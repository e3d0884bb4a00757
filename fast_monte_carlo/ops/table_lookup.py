"""Device-side table lookups: the table-mode HeadsEval implementation.

Each head's table is a flat (rows, channels) array gathered once per play
step.  Bin indices are computed by compare-sum against midpoint edges
(vectorized compares — no data-dependent control flow), and the two
axis profiles (fine / coarse) share their index computations across heads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SimConfig
from ..models import analytic
from ..models.tables import TableSet, edges_from_reps, sd_reps_default
from .game import HeadOut, HeadsEvalFn, StepObs
from .pack import MatchupPack

F32 = jnp.float32
I32 = jnp.int32


def segments_of(reps: np.ndarray) -> Tuple[Tuple[float, float, float, int, int], ...]:
    """Decompose a rep grid into piecewise-uniform segments.

    Returns ((enter_boundary, start_value, step, base_idx, count), ...).
    Index arithmetic replaces the O(n_reps) compare-sum binning with ~5
    elementwise ops per segment; `enter_boundary` is the midpoint between the previous
    segment's last rep and this segment's first rep, so nearest-rep
    semantics are preserved exactly.
    """
    reps = np.asarray(reps, dtype=np.float64)
    segs = []
    i = 0
    n = len(reps)
    while i < n:
        if i + 1 >= n:
            step = 1.0
            j = i + 1
        else:
            step = reps[i + 1] - reps[i]
            j = i + 1
            while j + 1 < n and abs((reps[j + 1] - reps[j]) - step) < 1e-9:
                j += 1
            j += 1
        enter = -np.inf if i == 0 else (reps[i - 1] + reps[i]) / 2.0
        segs.append((float(enter), float(reps[i]), float(step), i, j - i))
        i = j
    return tuple(segs)


def _seg_bin(v: jnp.ndarray, segs) -> jnp.ndarray:
    idx = jnp.zeros(v.shape, I32)
    for enter, start, step, base, count in segs:
        local = jnp.clip(jnp.round((v - start) / step), 0, count - 1).astype(I32) + base
        if np.isinf(enter):
            idx = local
        else:
            idx = jnp.where(v > enter, local, idx)
    return idx


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ProfileIdx:
    dist_edges: jnp.ndarray
    ytg_edges: jnp.ndarray
    sec_edges: jnp.ndarray
    sd_edges: Optional[jnp.ndarray]
    nd: int = field(metadata=dict(static=True))
    ny: int = field(metadata=dict(static=True))
    ns: int = field(metadata=dict(static=True))
    nsd: int = field(metadata=dict(static=True), default=0)
    dist_segs: tuple = field(metadata=dict(static=True), default=())
    ytg_segs: tuple = field(metadata=dict(static=True), default=())
    sec_segs: tuple = field(metadata=dict(static=True), default=())
    sd_segs: tuple = field(metadata=dict(static=True), default=())


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DeviceTable:
    values: jnp.ndarray    # (rows, C)
    row_map: jnp.ndarray   # (2, K) slot->row  or (2, K*K) pair->row
    n_slots: int = field(metadata=dict(static=True))   # table slot-axis size
    profile: str = field(metadata=dict(static=True))   # 'fine'|'coarse'|'play'
    is_pair: bool = field(metadata=dict(static=True), default=False)
    channels: int = field(metadata=dict(static=True), default=1)
    has_sd: bool = field(metadata=dict(static=True), default=False)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TableHeads:
    """Both directions' tables, merged: direction is folded into row_map by
    offsetting direction-1 rows past direction-0's."""
    fine: ProfileIdx
    coarse: ProfileIdx
    stage1: Optional[DeviceTable]
    stage2: Optional[DeviceTable]
    pq: Optional[DeviceTable]
    rq: Optional[DeviceTable]
    sq: Optional[DeviceTable]
    fumble: Optional[DeviceTable]
    play: Optional[DeviceTable]
    play_sd_edges: Optional[jnp.ndarray]
    play_nsd: int = field(metadata=dict(static=True), default=0)
    k: int = field(metadata=dict(static=True), default=8)
    # single-gather fused path (all per-play heads, one table row per play)
    fused: Optional[DeviceTable] = None
    fused_prof: Optional[ProfileIdx] = None
    fused_has_s2: bool = field(metadata=dict(static=True), default=False)
    fused_has_fumble: bool = field(metadata=dict(static=True), default=False)
    # nano path: rows = dist*ytg*sec only, (down, sd) folded into channels
    # so the single gather reads a small table (see nano_profile())
    nano: Optional[DeviceTable] = None
    nano_prof: Optional[ProfileIdx] = None
    nano_nsd: int = field(metadata=dict(static=True), default=1)
    nano_c: int = field(metadata=dict(static=True), default=0)


def _profile_idx(prof) -> ProfileIdx:
    return ProfileIdx(
        dist_edges=jnp.asarray(edges_from_reps(prof.dist), F32),
        ytg_edges=jnp.asarray(edges_from_reps(prof.ytg), F32),
        sec_edges=jnp.asarray(edges_from_reps(prof.sec), F32),
        sd_edges=(jnp.asarray(edges_from_reps(prof.sd), F32)
                  if prof.sd is not None else None),
        nd=len(prof.dist), ny=len(prof.ytg), ns=len(prof.sec),
        nsd=len(prof.sd) if prof.sd is not None else 0,
        dist_segs=segments_of(prof.dist),
        ytg_segs=segments_of(prof.ytg),
        sec_segs=segments_of(prof.sec),
        sd_segs=segments_of(prof.sd) if prof.sd is not None else (),
    )


def _merge_tables(*tables, k: int, is_pair: bool) -> DeviceTable:
    """Stack N direction host tables (2 per matchup, in game order) into one
    device table; row_map row d is the flat base offset of direction d."""
    t0 = tables[0]
    per_slot = int(np.prod(t0.shape)) // t0.shape[0]
    vals, rms = [], []
    offset = 0
    for t in tables:
        assert t.shape[1:] == t0.shape[1:], "direction tables must share axes"
        ps = int(np.prod(t.shape)) // t.shape[0]
        assert ps == per_slot
        vals.append(t.values)
        rms.append(offset + t.row_map.reshape(1, -1) * per_slot)
        offset += int(np.prod(t.shape))
    return DeviceTable(
        values=jnp.asarray(np.concatenate(vals, axis=0)),
        row_map=jnp.asarray(np.concatenate(rms, axis=0).astype(np.int32)),
        n_slots=int(t0.shape[0]),
        profile=t0.profile,
        is_pair=is_pair,
        channels=int(t0.values.shape[1]),
        has_sd=bool(t0.has_sd),
    )


def pack_tables(ts_a: TableSet, ts_b: TableSet, k: int,
                fused_prof=None, nano_prof=None) -> TableHeads:
    """Single matchup: directions [A-offense, B-offense]."""
    return pack_tables_multi([(ts_a, ts_b)], k, fused_prof, nano_prof)


def pack_tables_multi(ts_pairs, k: int, fused_prof=None,
                      nano_prof=None) -> TableHeads:
    """Many matchups in one TableHeads: direction rows are interleaved
    [g0 A-off, g0 B-off, g1 A-off, ...] and addressed by dirx = gid*2+off."""
    dirs = [t for pair in ts_pairs for t in pair]
    ts0 = dirs[0]
    fine = _profile_idx(ts0.fine)
    coarse = _profile_idx(ts0.coarse)

    def merge(attr, is_pair=False):
        tables = [getattr(t, attr) for t in dirs]
        if any(t is None for t in tables):
            return None
        return _merge_tables(*tables, k=k, is_pair=is_pair)

    nano = None
    np_idx = None
    nano_nsd = 1
    nano_c = 0
    if nano_prof is not None and all(
            getattr(t, "nano", None) is not None for t in dirs):
        nano = _merge_tables(*[t.nano for t in dirs], k=k, is_pair=False)
        np_idx = _profile_idx(nano_prof)  # sd segs drive the channel select
        nano_nsd = int(getattr(ts0.nano, "nano_nsd", 1))
        nano_c = int(getattr(ts0.nano, "nano_c", 0))

    fused = None
    fp = None
    if fused_prof is not None and all(t.fused is not None for t in dirs):
        fused = _merge_tables(*[t.fused for t in dirs], k=k, is_pair=False)
        fp = _profile_idx(fused_prof)

    s2_pair = (ts0.stage2 is not None and ts0.stage2.row_map.size == k * k)
    th = TableHeads(
        fine=fine, coarse=coarse,
        stage1=merge("stage1"),
        stage2=merge("stage2", is_pair=s2_pair),
        pq=merge("pq", is_pair=True),
        rq=merge("rq"),
        sq=merge("sq"),
        fumble=merge("fumble"),
        play=merge("play"),
        play_sd_edges=(jnp.asarray(edges_from_reps(sd_reps_default()), F32)
                       if ts0.play is not None else None),
        play_nsd=len(sd_reps_default()) if ts0.play is not None else 0,
        k=k,
        fused=fused,
        fused_prof=fp,
        fused_has_s2=bool(getattr(ts0.fused, "fused_has_s2", False)
                          or getattr(ts0.nano, "fused_has_s2", False)),
        fused_has_fumble=bool(getattr(ts0.fused, "fused_has_fumble", False)
                              or getattr(ts0.nano, "fused_has_fumble", False)),
        nano=nano,
        nano_prof=np_idx,
        nano_nsd=nano_nsd,
        nano_c=nano_c,
    )
    return th


def _table_cache_key(team_a, team_b, heads, cfg, fine, coarse, fused) -> str:
    import hashlib
    import json as _json

    def prof_sig(p):
        if p is None:
            return None
        return [p.dist.tolist(), p.ytg.tolist(), p.sec.tolist(),
                None if p.sd is None else p.sd.tolist()]

    def ctx_sig(t):
        return [t.name, t.sp_rating, t.sp_offense, t.sp_defense,
                t.qb.names, t.qb.share.tolist(),
                t.rush.names, t.rush.share.tolist(),
                t.target.names, t.target.share.tolist()]

    def forest_sig(f):
        if f is None:
            return None
        return [f.name, f.n_trees, f.n_nodes, float(f.leaf.sum()),
                float(f.thresh.sum())]

    payload = _json.dumps([
        ctx_sig(team_a), ctx_sig(team_b),
        prof_sig(fine), prof_sig(coarse), prof_sig(fused),
        forest_sig(heads.stage1), forest_sig(heads.stage2),
        [forest_sig(f) for f in (heads.pass_quants or ())],
        [forest_sig(f) for f in (heads.rush_quants or ())],
        [forest_sig(f) for f in (heads.sack_quants or ())],
        forest_sig(heads.fumble), forest_sig(heads.play),
        cfg.model.enable_fumbles, cfg.model.use_play_model,
        cfg.model.stage1_clip_lo, cfg.model.stage1_clip_hi,
        cfg.model.stage2_sack_scale, cfg.model.stage2_int_scale,
    ], sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


# inside the checkout, like the compile cache (utils/compile_cache.py), so
# the cache does not move with the shell's working directory
TABLE_CACHE_DIR: Optional[str] = str(
    Path(__file__).resolve().parents[2] / ".table_cache")

# device-resident TableHeads by (disk key, repr(cfg), coach_map items);
# FIFO-capped — ~14MB of device buffers per entry (two weekly slates)
_DEVICE_TABLE_CACHE: Dict[tuple, "TableHeads"] = {}
_DEVICE_TABLE_CACHE_MAX = 128


def _remember(dev_key, th: "TableHeads") -> "TableHeads":
    if dev_key is not None:
        while len(_DEVICE_TABLE_CACHE) >= _DEVICE_TABLE_CACHE_MAX:
            _DEVICE_TABLE_CACHE.pop(next(iter(_DEVICE_TABLE_CACHE)))
        _DEVICE_TABLE_CACHE[dev_key] = th
    return th


def cachewarm_events(team_a, team_b, heads, cfg: SimConfig, coach_map=None,
                     cache_dir: Optional[str] = "auto"):
    """Run the 'cachewarm' warm-up: cfg.engine.cachewarm_games oracle games
    with first-visit score_diff recording (oracle.py record_first_sd),
    disk-cached (deterministic in contexts/heads/cfg/seed/games).  Returns
    [side0_events, side1_events] — side i = team i on offense."""
    import pickle
    from pathlib import Path as _P

    if cache_dir == "auto":
        cache_dir = TABLE_CACHE_DIR
    cache_path = None
    if cache_dir:
        import hashlib

        # the warm-up trajectory depends on essentially EVERY SimConfig
        # field (clock charges, matchup tilts, RZ gates, ...), not just the
        # model constants _table_cache_key hashes — include the full
        # frozen-dataclass repr so a changed config is a cache miss
        cfg_sig = hashlib.sha256(repr(cfg).encode()).hexdigest()[:12]
        key = _table_cache_key(team_a, team_b, heads, cfg, None, None, None)
        # the warm-up trajectory also depends on coach_map (the play-call
        # model's coach_id feature) — hash it into the filename or a
        # coach-only change would serve stale first-visit recordings
        coach_sig = hashlib.sha256(
            repr(sorted((coach_map or {}).items())).encode()).hexdigest()[:8]
        cache_path = _P(cache_dir) / (
            f"warm_{key}_{cfg_sig}_{coach_sig}_{cfg.engine.cachewarm_seed}_"
            f"{cfg.engine.cachewarm_games}.pkl")
        if cache_path.exists():
            try:
                with open(cache_path, "rb") as fh:
                    return pickle.load(fh)
            except Exception:
                pass
    from ..oracle import OracleMatchup
    m = OracleMatchup(team_a, team_b, heads, cfg, coach_map,
                      record_first_sd=True)
    rng = np.random.default_rng(cfg.engine.cachewarm_seed)
    for i in range(cfg.engine.cachewarm_games):
        m.simulate_game(i % 2, rng)
    if cache_path is not None:
        try:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = cache_path.with_suffix(".tmp")
            with open(tmp, "wb") as fh:
                pickle.dump(m.first_sd, fh)
            tmp.rename(cache_path)
        except Exception:
            pass
    return m.first_sd


def _apply_sd_mode(ts: TableSet, cfg: SimConfig, fused_prof,
                   warm=None) -> None:
    """In the collapsed sd modes, contract every sd axis: 'marginal' /
    'frozen' per tables.marginalize_sd; 'cachewarm' at the recorded
    first-visit sd of each cell (trajectory-coherent freeze — `warm` is one
    side's OracleMatchup.first_sd dict)."""
    if cfg.engine.sd_mode == "axis":
        return
    mode = cfg.engine.sd_mode  # 'frozen' | 'marginal' | 'cachewarm'
    from ..models.tables import (cachewarm_collapse, fused_head_groups,
                                 marginalize_sd)

    if mode == "cachewarm":
        if warm is None:
            raise ValueError("sd_mode='cachewarm' needs warm-up recordings "
                             "(ops.table_lookup.cachewarm_events)")
        if ts.stage1 is not None and ts.stage1.has_sd:
            rm = np.asarray(ts.stage1.row_map)
            ts.stage1 = cachewarm_collapse(
                ts.stage1, ts.fine, warm,
                [("s1", tuple(range(ts.stage1.channels)))],
                slots_to_s=lambda s1, s2, rm=rm: int(rm[int(s1 or 0)]))
        if ts.pq is not None and ts.pq.has_sd:
            rm = np.asarray(ts.pq.row_map)
            K = int(round(len(rm) ** 0.5))
            ts.pq = cachewarm_collapse(
                ts.pq, ts.coarse, warm,
                [("pq", tuple(range(ts.pq.channels)))],
                slots_to_s=lambda s1, s2, rm=rm, K=K: int(
                    rm[int(s1 or 0) * K + int(s2 or 0)]))
        if ts.fused is not None and ts.fused.has_sd and fused_prof is not None:
            fa = cachewarm_collapse(ts.fused, fused_prof, warm,
                                    fused_head_groups(ts.fused))
            fa.fused_has_s2 = getattr(ts.fused, "fused_has_s2", False)
            fa.fused_has_fumble = getattr(ts.fused, "fused_has_fumble", False)
            ts.fused = fa
        return

    if ts.stage1 is not None and ts.stage1.has_sd:
        ts.stage1 = marginalize_sd(ts.stage1, ts.fine, mode)
    if ts.pq is not None and ts.pq.has_sd:
        ts.pq = marginalize_sd(ts.pq, ts.coarse, mode)
    if ts.fused is not None and ts.fused.has_sd and fused_prof is not None:
        fa = marginalize_sd(ts.fused, fused_prof, mode)
        fa.fused_has_s2 = getattr(ts.fused, "fused_has_s2", False)
        fa.fused_has_fumble = getattr(ts.fused, "fused_has_fumble", False)
        ts.fused = fa
    # the play-policy table keeps its sd axis: the reference's play-call
    # cache DOES key on score_diff (fast_monte_carlo_cfb.py:343-357)


def build_table_heads(team_a, team_b, heads, cfg: SimConfig, coach_map=None,
                      fine=None, coarse=None, fused=None, nano=None,
                      cache_dir: Optional[str] = "auto") -> TableHeads:
    """Build + device-pack both directions' tables for one matchup.

    `fused`: an optional TableProfile; when given AND every head's player
    rows collapse to one, a single-gather fused table is built and used as
    the per-play path (players are still sampled and tracked for stats —
    only the model *outputs* are player-independent in that case, which is
    exactly when fusion is valid).

    `nano`: an optional TableProfile for the nano layout (one gather from a
    row-count-capped table, down/sd in channels).  Built through the same
    fused-table pipeline (and disk cache) then re-laid-out."""
    from ..matchup import build_direction
    from ..models.tables import build_fused_table, build_tables

    from ..models.tables import TableSet, coarse_profile, fine_profile

    if nano is not None:
        assert fused is None, "nano and fused presets are mutually exclusive"
        fused = nano

    def _finish(ts_a, ts_b):
        """Pack; when the nano preset is active, re-layout the fused tables
        into the nano format first (pure transform, disk cache unchanged)."""
        if nano is not None:
            from ..models.tables import nano_from_fused
            for ts in (ts_a, ts_b):
                if ts.fused is not None:
                    ts.nano = nano_from_fused(ts.fused, nano)
                    ts.fused = None
            return pack_tables(ts_a, ts_b, k=team_a.qb.k, nano_prof=nano)
        return pack_tables(ts_a, ts_b, k=team_a.qb.k, fused_prof=fused)

    # disk cache: table builds are host-side and deterministic in
    # (contexts, profiles, forests, model constants)
    import pickle
    from pathlib import Path as _P

    # 'cachewarm' sd mode: one oracle warm-up per matchup (disk-cached),
    # recording each memo-cell's first-visit score_diff per side
    warm_a = warm_b = None
    if cfg.engine.sd_mode == "cachewarm":
        warm = cachewarm_events(team_a, team_b, heads, cfg, coach_map,
                                cache_dir)
        warm_a, warm_b = warm[0], warm[1]

    cache_path = None
    dev_key = None
    if cache_dir == "auto":
        cache_dir = TABLE_CACHE_DIR
    if cache_dir:
        key = _table_cache_key(team_a, team_b, heads, cfg, fine, coarse, fused)
        # in-process DEVICE-table cache on top of the disk cache: a disk
        # hit still pays per-call unpickle + a ~14MB/matchup host->device
        # upload, which repeated slate API calls would pay every time.
        # Identical (contexts,
        # heads, profiles, model constants, full cfg, coach_map) return
        # the already device-resident TableHeads.
        # the disk key is layout-agnostic (disk stores pre-relayout
        # TableSets; _finish re-lays-out on load) but the device cache
        # stores the post-_finish object, so the key must record whether
        # the nano relayout was applied to this build.
        layout = "nano" if nano is not None else "fused"
        dev_key = (key, layout, repr(cfg),
                   tuple(sorted((coach_map or {}).items())))
        hit = _DEVICE_TABLE_CACHE.get(dev_key)
        if hit is not None:
            return hit
        cache_path = _P(cache_dir) / f"tables_{key}.pkl"
        if cache_path.exists():
            try:
                with open(cache_path, "rb") as fh:
                    ts_a, ts_b = pickle.load(fh)
                _apply_sd_mode(ts_a, cfg, fused, warm_a)
                _apply_sd_mode(ts_b, cfg, fused, warm_b)
                return _remember(dev_key, _finish(ts_a, ts_b))
            except Exception:
                pass

    def _save(ts_a, ts_b):
        if cache_path is None:
            return
        try:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = cache_path.with_suffix(".tmp")
            with open(tmp, "wb") as fh:
                pickle.dump((ts_a, ts_b), fh)
            tmp.rename(cache_path)
        except Exception:
            pass

    da = build_direction(team_a, team_b, heads, cfg, coach_map)
    db = build_direction(team_b, team_a, heads, cfg, coach_map)
    if fused is not None:
        fa = build_fused_table(da, heads, cfg, fused)
        fb = build_fused_table(db, heads, cfg, fused)
        if fa is not None and fb is not None:
            # fusion succeeded: skip the (unused) per-head tables entirely
            ts_a = TableSet(stage1=None, stage2=None, pq=None, rq=None,
                            sq=None, fumble=None, play=None,
                            fine=fine or fine_profile(),
                            coarse=coarse or coarse_profile(), fused=fa)
            ts_b = TableSet(stage1=None, stage2=None, pq=None, rq=None,
                            sq=None, fumble=None, play=None,
                            fine=ts_a.fine, coarse=ts_a.coarse, fused=fb)
            if cfg.model.use_play_model and heads.play is not None:
                full_a = build_tables(da, heads, cfg, fine, coarse)
                full_b = build_tables(db, heads, cfg, fine, coarse)
                ts_a.play, ts_b.play = full_a.play, full_b.play
            _save(ts_a, ts_b)
            _apply_sd_mode(ts_a, cfg, fused, warm_a)
            _apply_sd_mode(ts_b, cfg, fused, warm_b)
            return _remember(dev_key, _finish(ts_a, ts_b))
    ts_a = build_tables(da, heads, cfg, fine, coarse)
    ts_b = build_tables(db, heads, cfg, fine, coarse)
    if fused is not None:
        ts_a.fused = build_fused_table(da, heads, cfg, fused)
        ts_b.fused = build_fused_table(db, heads, cfg, fused)
    _save(ts_a, ts_b)
    _apply_sd_mode(ts_a, cfg, fused, warm_a)
    _apply_sd_mode(ts_b, cfg, fused, warm_b)
    return _remember(dev_key, _finish(ts_a, ts_b))


def _bin(v: jnp.ndarray, edges: jnp.ndarray) -> jnp.ndarray:
    """index = #edges below v; edges are midpoints so this snaps to the
    nearest representative."""
    return jnp.sum(v[:, None] > edges[None, :], axis=1).astype(I32)


def make_table_heads_eval(cfg: SimConfig) -> HeadsEvalFn:
    """Table mode heads-eval; heads_state is a TableHeads pytree."""

    def heads_eval(th: TableHeads, obs: StepObs, pack: MatchupPack) -> HeadOut:
        off, qb, wr, rb = obs.dirx, obs.qb, obs.wr, obs.rb
        down_i = jnp.clip(obs.down - 1, 0, 4).astype(I32)  # down>=5 one class
        dist_f = obs.dist
        ytg_f = obs.ytg
        sec_f = obs.sec.astype(F32)
        K = th.k
        sd_f = obs.sd

        if th.nano is not None:
            return _nano_eval(th, obs, pack, down_i, dist_f, ytg_f, sec_f, sd_f, cfg)
        if th.fused is not None:
            return _fused_eval(th, obs, pack, down_i, dist_f, ytg_f, sec_f, sd_f, cfg)

        idx = {}
        sd_idx = {}
        for name, prof in (("fine", th.fine), ("coarse", th.coarse)):
            di = _seg_bin(dist_f, prof.dist_segs)
            yi = _seg_bin(ytg_f, prof.ytg_segs)
            si = _seg_bin(sec_f, prof.sec_segs)
            # flat state offset within one slot row: ((d*Nd + di)*Ny + yi)*Ns + si
            state = ((down_i * prof.nd + di) * prof.ny + yi) * prof.ns + si
            idx[name] = state
            if prof.sd_segs:
                sd_idx[name] = (_seg_bin(sd_f, prof.sd_segs), prof.nsd)

        def lookup(t: DeviceTable, slot_key: jnp.ndarray) -> jnp.ndarray:
            base = jnp.take(t.row_map.reshape(-1), slot_key, mode="clip")
            pname = t.profile if t.profile in idx else "coarse"
            state = idx[pname]
            if t.has_sd:
                sdi, nsd = sd_idx[pname]
                state = state * nsd + sdi
            rows = base + state
            return jnp.take(t.values, rows, axis=0, mode="clip")

        slot_qb = off * K + qb
        slot_rb = off * K + rb
        pair = off * (K * K) + qb * K + wr

        p_c_biased = lookup(th.stage1, slot_qb)[:, 0]

        if th.stage2 is not None:
            key = pair if th.stage2.is_pair else slot_qb
            s2 = lookup(th.stage2, key)        # (B,2) cum (inc, inc+sck)
            s2_cum = s2
        else:
            inc, itc, sck = analytic.stage2_fallback_probs(
                obs.down.astype(F32), obs.dist, cfg, jnp)
            inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg, jnp)
            s2_cum = jnp.stack([inc, inc + sck], axis=1)

        pq = lookup(th.pq, pair)               # (B,2) q50, sigma
        rq = lookup(th.rq, slot_rb)
        sq = lookup(th.sq, slot_qb)

        if th.fumble is not None and cfg.model.enable_fumbles:
            p_f = lookup(th.fumble, slot_rb)[:, 0]
        else:
            p_f = jnp.zeros_like(p_c_biased)

        p_pass_ml = None
        if th.play is not None and cfg.model.use_play_model:
            sdi = _bin(obs.sd, th.play_sd_edges)
            state = idx["coarse"] * th.play_nsd + sdi
            base = jnp.take(th.play.row_map.reshape(-1), off, mode="clip")  # per direction row
            p_pass_ml = jnp.take(th.play.values, base + state, axis=0,
                                 mode="clip")[:, 0]

        return HeadOut(
            p_complete=p_c_biased,
            s2_cum=s2_cum,
            pass_ms=pq, rush_ms=rq, sack_ms=sq,
            p_fumble=p_f,
            p_pass_ml=p_pass_ml,
        )

    heads_eval.needs_x = False  # tables key on scalar state fields only
    return heads_eval


def _unpack_head_row(th: TableHeads, obs: StepObs, row, down_i, dist_f,
                     ytg_f, sec_f, sd_f, cfg: SimConfig) -> HeadOut:
    """Shared FUSED_CHANNELS unpack + ML-play-table lookup for the fused and
    nano single-gather paths."""
    p_c = row[:, 0]
    pq = row[:, 1:3]
    rq = row[:, 3:5]
    sq = row[:, 5:7]
    c = 7
    if th.fused_has_s2:
        s2_cum = row[:, c:c + 2]
        c += 2
    else:
        inc, itc, sck = analytic.stage2_fallback_probs(
            obs.down.astype(F32), obs.dist, cfg, jnp)
        inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg, jnp)
        s2_cum = jnp.stack([inc, inc + sck], axis=1)
    p_f = row[:, c] if th.fused_has_fumble else jnp.zeros_like(p_c)

    p_pass_ml = None
    if th.play is not None and cfg.model.use_play_model:
        sdi = _bin(sd_f, th.play_sd_edges)
        cp = th.coarse
        dci = _seg_bin(dist_f, cp.dist_segs)
        yci = _seg_bin(ytg_f, cp.ytg_segs)
        sci = _seg_bin(sec_f, cp.sec_segs)
        cstate = ((down_i * cp.nd + dci) * cp.ny + yci) * cp.ns + sci
        per_dir_p = th.play.values.shape[0] // th.play.row_map.size
        pbase = obs.dirx * per_dir_p
        p_pass_ml = jnp.take(th.play.values,
                             pbase + cstate * th.play_nsd + sdi, axis=0,
                             mode="clip")[:, 0]

    return HeadOut(p_complete=p_c, s2_cum=s2_cum, pass_ms=pq, rush_ms=rq,
                   sack_ms=sq, p_fumble=p_f, p_pass_ml=p_pass_ml)


def _fused_eval(th: TableHeads, obs: StepObs, pack: MatchupPack,
                down_i, dist_f, ytg_f, sec_f, sd_f, cfg: SimConfig) -> HeadOut:
    """Single-gather path: one fused table row carries every head output."""
    prof = th.fused_prof
    di = _seg_bin(dist_f, prof.dist_segs)
    yi = _seg_bin(ytg_f, prof.ytg_segs)
    si = _seg_bin(sec_f, prof.sec_segs)
    state = ((down_i * prof.nd + di) * prof.ny + yi) * prof.ns + si
    if th.fused.has_sd:
        state = state * prof.nsd + _seg_bin(sd_f, prof.sd_segs)
    per_dir = th.fused.values.shape[0] // th.fused.row_map.size
    base = obs.dirx * per_dir
    row = jnp.take(th.fused.values, base + state, axis=0, mode="clip")  # (B, C)
    return _unpack_head_row(th, obs, row, down_i, dist_f, ytg_f, sec_f,
                            sd_f, cfg)


def _nano_eval(th: TableHeads, obs: StepObs, pack: MatchupPack,
               down_i, dist_f, ytg_f, sec_f, sd_f, cfg: SimConfig) -> HeadOut:
    """Nano path: ONE gather from a (dist*ytg*sec)-row table whose channels
    carry every (down, sd, head) combination; down and sd are then selected
    per lane with masked sums (5 + nsd cheap elementwise passes) — keeps
    the table's row count small (see nano_profile())."""
    prof = th.nano_prof
    di = _seg_bin(dist_f, prof.dist_segs)
    yi = _seg_bin(ytg_f, prof.ytg_segs)
    si = _seg_bin(sec_f, prof.sec_segs)
    state = (di * prof.ny + yi) * prof.ns + si
    # direction base offsets are uniform (R rows per direction), so the
    # row_map gather collapses to arithmetic (one (B,) take fewer)
    per_dir = th.nano.values.shape[0] // th.nano.row_map.size
    base = obs.dirx * per_dir
    row = jnp.take(th.nano.values, base + state, axis=0, mode="clip")
    nsd, c = th.nano_nsd, th.nano_c
    blk = nsd * c
    if cfg.engine.nano_select == "dot":
        # one-pass masked contraction: reshape to (B, 5, blk) and contract
        # the down axis against a one-hot.  Same arithmetic as the slice
        # chain below, but emitted as a single reduce XLA cannot fission
        # into per-slice fusions — the fix, on the earlier chip, for the
        # rbg+no-stats pathology where the chain split into fusions that
        # each re-read the gathered row strided (config.resolve_nano_select).
        # HIGHEST keeps the contraction in float32 (no TF32 rounding of
        # the table values), so 'dot' and 'chain' agree bitwise
        hi = jax.lax.Precision.HIGHEST
        oh = (down_i[:, None] == jnp.arange(5)[None, :]).astype(row.dtype)
        sel = jnp.einsum("bdc,bd->bc", row.reshape(-1, 5, blk), oh,
                         precision=hi)
        if nsd > 1:
            sdi = _seg_bin(sd_f, prof.sd_segs)
            oh2 = (sdi[:, None] == jnp.arange(nsd)[None, :]).astype(sel.dtype)
            sel = jnp.einsum("bsc,bs->bc", sel.reshape(-1, nsd, c), oh2,
                             precision=hi)
    else:
        sel = None
        for d in range(5):
            g = (down_i == d).astype(row.dtype)[:, None]
            part = row[:, d * blk:(d + 1) * blk] * g
            sel = part if sel is None else sel + part
        if nsd > 1:
            sdi = _seg_bin(sd_f, prof.sd_segs)
            sel2 = None
            for s in range(nsd):
                g = (sdi == s).astype(sel.dtype)[:, None]
                part = sel[:, s * c:(s + 1) * c] * g
                sel2 = part if sel2 is None else sel2 + part
            sel = sel2
    return _unpack_head_row(th, obs, sel, down_i, dist_f, ytg_f, sec_f,
                            sd_f, cfg)
