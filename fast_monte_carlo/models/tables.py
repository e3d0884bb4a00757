"""Table compilation of model heads — the device fast path.

Rationale (SURVEY §7.3): per-play full-forest evaluation costs ~3e5
elementwise ops per trial-play.  The reference
itself amortizes model inference through memo caches keyed on coarse state
bins (fast_monte_carlo_cfb.py:68-94): 0.5-yd distance, 1-yd ytg, 30-s clock
buckets, per-player, with score_diff dropped.  Within a fixed matchup the
SP+ features are constants and timeouts never change, so each head is
effectively a function on a small finite grid.

This module evaluates the EXACT compiled forests over that grid once per
matchup direction, baking in every deterministic post-transform:

  stage1  -> clip(sigmoid(margin) + matchup_bias, .02, .98)      1 channel
  stage2  -> post-nudge cumulative (P(inc), P(inc)+P(sack))      2 channels
  quants  -> (q50, sigma = max(floor, (q90-q10)/2.56))           2 channels
  fumble  -> probability                                         1 channel
  play    -> clip(renormalized softmax P(pass), .02, .98)        1 channel
             (+ a score_diff axis: the play policy is the only head whose
              reference cache keys include score_diff, :343-357)

so the per-play engine cost collapses to ~10 table gathers + bin index
arithmetic.  Player identity is a table axis: slots (or passer x target
pairs) are deduplicated by forest "used category" equivalence — a player
whose one-hot column never appears in any split is indistinguishable from
Unknown.

The build itself exploits the tensor-product structure of the grid: trees
are grouped by the set of axes they actually touch and evaluated by masked
recursion over that sub-grid only (a depth-3 tree splitting on ytg and
seconds costs a |ytg| x |sec| boolean mask walk, not a full-grid pass), then
broadcast-added into the full table.  Build time is host-numpy seconds per
matchup, independent of trial count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..config import SimConfig
from ..matchup import DirectionContext
from . import analytic
from .forest import FlatForest

AXES = ("slot", "down", "dist", "ytg", "sec", "sd")  # canonical order


@dataclass(frozen=True)
class TableProfile:
    """Axis representative values (grid points) for the state dimensions."""

    dist: np.ndarray
    ytg: np.ndarray
    sec: np.ndarray
    sd: Optional[np.ndarray] = None

    def reps(self, kind: str) -> np.ndarray:
        if kind == "down":
            # 5 reps: the reference lets a failed 4th-down pass reach down 5+
            # without a turnover (fast_monte_carlo_cfb.py:1165,1181 increment
            # past handle_fourth's down==4 gate).  No forest saw down>4 in
            # training, so all downs >=5 are one equivalence class.
            return np.asarray([1.0, 2.0, 3.0, 4.0, 5.0])
        return getattr(self, kind)


def _halfgrid(lo, hi, step):
    return np.round(np.arange(lo, hi + step / 2, step), 4)


def fine_profile() -> TableProfile:
    """Reference-cache-faithful bins where it matters: 0.5-yd distance to 12
    (goal-to-go exactness), 1-yd ytg, 60-s clock buckets (aligned with the
    two_minute=120 and half=1800 boundaries), and a compact score_diff axis
    (0 kept separate: zero == missing to the xgboost heads)."""
    dist = np.unique(np.concatenate([
        _halfgrid(0.5, 12.0, 0.5), _halfgrid(13, 30, 1.0), [33, 36, 40, 50, 64]]))
    ytg = np.arange(0.0, 121.0)
    sec = np.minimum(np.arange(61) * 60.0 + 30.0, 3600.0)
    sd = np.asarray([-17.0, -8.0, -3.0, 0.0, 3.0, 8.0, 17.0])
    return TableProfile(dist=dist, ytg=ytg, sec=sec, sd=sd)


def coarse_profile() -> TableProfile:
    dist = np.unique(np.concatenate([
        _halfgrid(0.5, 10.0, 0.5), _halfgrid(11, 20, 1.0), [24, 28, 33, 40, 64]]))
    ytg = np.unique(np.concatenate([np.arange(0.0, 36.0), np.arange(36, 121, 2.0)]))
    sec = np.minimum(np.concatenate([np.arange(0, 3600, 90.0) + 45.0, [3600.0]]), 3600.0)
    sd = np.asarray([-8.0, 0.0, 8.0])
    return TableProfile(dist=dist, ytg=ytg, sec=sec, sd=sd)


def turbo_profile() -> TableProfile:
    """Sized so the fused table for BOTH directions stays small (~131k rows
    x 8ch x 4B ~ 4MB), chosen on the earlier chip, whose gathers were
    faster from on-chip memory; not yet measured on the GPU.
    5x16x34x15x3 = 122k rows per direction pair."""
    dist = np.asarray([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 5.5, 7.0, 9.0, 11.0,
                       15.0, 64.0])
    ytg = np.unique(np.concatenate([
        np.arange(0.0, 13.0),                       # goal-to-go zone, 1-yd
        [15, 18, 21, 25, 29, 33, 38, 45, 54, 64, 75, 88, 99, 120]]))
    sec = np.asarray([40.0, 140.0, 300.0, 700.0, 1300.0, 1680.0, 1790.0,
                      2100.0, 2700.0, 3200.0, 3500.0, 3600.0])
    sd = np.asarray([-8.0, 0.0, 8.0])
    return TableProfile(dist=dist, ytg=ytg, sec=sec, sd=sd)


def nano_profile() -> TableProfile:
    """Single-gather fast path.  The nano layout keeps ROWS = dist x ytg x
    sec only (16*32*16 = 8192 per direction, 16384 both) and folds the down
    axis (and the sd axis in 'axis' mode) into CHANNELS, selected per lane
    with a 5-way (x3-way) masked sum after ONE gather.  It was chosen on
    the earlier chip, whose gathers slowed sharply past ~16k rows while
    extra channels were nearly free; not yet measured on the GPU."""
    dist = np.asarray([0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 7.0,
                       8.5, 10.0, 12.0, 16.0, 25.0, 64.0])
    ytg = np.unique(np.concatenate([
        np.arange(1.0, 16.0),                       # goal-to-go + RZ, 1-yd
        [17, 19, 21, 23, 25, 28, 31, 35, 40, 45, 51, 58, 66, 75, 85, 96, 120]]))
    sec = np.asarray([15.0, 45.0, 90.0, 150.0, 350.0, 700.0, 1200.0, 1650.0,
                      1762.0, 1850.0, 1950.0, 2100.0, 2500.0, 3000.0, 3400.0,
                      3600.0])
    sd = np.asarray([-8.0, 0.0, 8.0])
    return TableProfile(dist=dist, ytg=ytg, sec=sec, sd=sd)


def slate_profile() -> TableProfile:
    dist = np.unique(np.concatenate([_halfgrid(0.5, 6.0, 0.5), [8, 10, 13, 16, 20, 26, 40, 64]]))
    ytg = np.unique(np.concatenate([np.arange(0.0, 22.0), np.arange(22, 121, 4.0)]))
    sec = np.minimum(np.concatenate([np.arange(0, 3600, 180.0) + 90.0, [3600.0]]), 3600.0)
    return TableProfile(dist=dist, ytg=ytg, sec=sec)


def sd_reps_default() -> np.ndarray:
    return np.concatenate([[-35.0], np.arange(-24.0, 25.0, 2.0), [35.0]])


def sd_marginal_weights(reps: np.ndarray, sigma: float = 9.0) -> np.ndarray:
    """Weights for marginalizing a table's score_diff axis.

    The reference's memo caches key WITHOUT score_diff, so each state bin's
    model output is frozen at whatever sd the first call carried
    (fast_monte_carlo_cfb.py:68-88) — i.e. the as-executed reference has NO
    within-game score feedback on the pass/yardage heads, and its effective
    model is sd-marginalized over a roughly-centered sd distribution.
    Contracting the sd axis with these weights reproduces that (and the
    live-sd 'axis' mode remains available as the truer-to-the-raw-models
    alternative — it widens margin sd by ~7%, see VALIDATION.md)."""
    w = np.exp(-0.5 * (np.asarray(reps, dtype=np.float64) / sigma) ** 2)
    return w / w.sum()


def marginalize_sd(t: "HostTable", prof: TableProfile,
                   mode: str = "frozen") -> "HostTable":
    """Collapse a HostTable's trailing sd axis.

    mode='marginal': weighted mean over sd (expectation) — smooths away the
    reference cache's per-bin variability and under-disperses margins.
    mode='frozen' (default): per-cell SAMPLE one sd rep with the weight
    distribution — reproduces the reference's first-write-wins semantics,
    where each state bin keeps the output of a random-ish score_diff draw
    (fast_monte_carlo_cfb.py:68-94).  Deterministic (fixed-seed) so builds
    and caches are reproducible."""
    if not t.has_sd:
        return t
    nsd = len(prof.sd)
    w = sd_marginal_weights(prof.sd)
    vals = t.values.reshape(-1, nsd, t.values.shape[-1])
    if mode == "marginal":
        out = np.tensordot(w, vals.transpose(1, 0, 2), axes=1).astype(np.float32)
    else:
        rng = np.random.default_rng(20250816)
        pick = rng.choice(nsd, size=vals.shape[0], p=w)
        out = vals[np.arange(vals.shape[0]), pick].astype(np.float32)
    return HostTable(values=out, shape=t.shape[:-1] if t.shape[-1] == nsd else t.shape,
                     row_map=t.row_map, profile=t.profile, has_sd=False,
                     channels=t.channels)


def edges_from_reps(reps: np.ndarray) -> np.ndarray:
    """Midpoint edges: index(v) = sum(v > edges) maps v to its nearest rep
    (ties toward the lower rep)."""
    return (reps[:-1] + reps[1:]) / 2.0


# ---------------------------------------------------------------------------
# 'cachewarm' sd mode: trajectory-coherent freeze
# ---------------------------------------------------------------------------
#
# The reference's memo caches key WITHOUT score_diff, so each state bin
# freezes at the model output of its FIRST visit — and first visits come
# from real game trajectories, making the frozen sds COHERENT across cells
# (early-game cells freeze near sd 0; cells first reached during a blowout
# freeze at large sd together).  That coherence is why the as-executed
# reference's margin sd (18.8) sits between the iid per-cell 'frozen'
# collapse (17.3) and the live-sd 'axis' mode (20.0) — see VALIDATION.md.
# 'cachewarm' reproduces the mechanism: run a few oracle warm-up games with
# first-visit recording (oracle.py record_first_sd), then collapse each
# table cell's sd axis at the recorded first-visit sd (nearest rep); cells
# never visited in the warm-up fall back to the iid 'frozen' pick.


def _first_visit_picks(prof: TableProfile, events: dict, cell_shape,
                       slots_to_s=None):
    """events: {memo_key: (visit_order, sd)} with memo_key =
    (down, dist, ytg, sec_bucket30, to_off, to_def, slot, slot2)
    (oracle._coarse_key).  Returns (picks, found): int sd-rep index and
    bool mask over cells laid out `cell_shape` = (S, 5, Nd, Ny, Ns).
    Multiple memo keys map to one (coarser) table cell; the EARLIEST visit
    wins, mirroring first-write-wins."""
    S, ndown, nd, ny, ns = cell_shape
    picks = np.zeros(cell_shape, dtype=np.int64)
    found = np.zeros(cell_shape, dtype=bool)
    if not events:
        return picks, found
    keys = list(events.keys())
    order = np.asarray([events[k][0] for k in keys], dtype=np.int64)
    sd = np.asarray([events[k][1] for k in keys], dtype=np.float64)
    down = np.asarray([min(int(k[0]), 5) for k in keys], dtype=np.int64) - 1
    dist = np.asarray([k[1] for k in keys], dtype=np.float64)
    ytg = np.asarray([k[2] for k in keys], dtype=np.float64)
    sec = np.asarray([k[3] for k in keys], dtype=np.float64) * 30.0 + 15.0
    if slots_to_s is None:
        s_idx = np.zeros(len(keys), dtype=np.int64)
    else:
        s_idx = np.asarray([slots_to_s(k[6], k[7]) for k in keys],
                           dtype=np.int64)
    di = np.searchsorted(edges_from_reps(prof.dist), dist, side="left")
    yi = np.searchsorted(edges_from_reps(prof.ytg), ytg, side="left")
    si = np.searchsorted(edges_from_reps(prof.sec), sec, side="left")
    sdi = np.searchsorted(edges_from_reps(prof.sd), sd, side="left")
    cell = (((s_idx * ndown + down) * nd + di) * ny + yi) * ns + si
    # earliest visit per cell wins
    srt = np.argsort(order, kind="stable")
    cell, sdi = cell[srt], sdi[srt]
    first = np.unique(cell, return_index=True)[1]
    flat_p, flat_f = picks.reshape(-1), found.reshape(-1)
    flat_p[cell[first]] = sdi[first]
    flat_f[cell[first]] = True
    return picks, found


def cachewarm_collapse(t: "HostTable", prof: TableProfile, side_events: dict,
                       head_groups, seed: int = 20250816,
                       slots_to_s=None) -> "HostTable":
    """Collapse a HostTable's sd axis with trajectory-coherent first-visit
    picks (see note above).  `side_events` is one side's
    OracleMatchup.first_sd dict; `head_groups` maps cache name -> tuple of
    channel indices in this table (a fused table mixes heads per channel;
    per-head tables pass a single group covering all channels)."""
    if not t.has_sd:
        return t
    nsd = len(prof.sd)
    # HostTable.shape includes the trailing sd axis while has_sd
    cell_shape = t.shape[:-1] if t.shape[-1] == nsd else t.shape  # (S,5,Nd,Ny,Ns)
    vals = t.values.reshape(cell_shape + (nsd, t.channels))
    covered = sorted(c for _, chans in head_groups for c in chans)
    if covered != list(range(t.channels)):
        raise ValueError(
            f"head_groups cover channels {covered} but the table has "
            f"{t.channels} (fused_has_s2/fused_has_fumble inconsistent?)")
    out = np.zeros(cell_shape + (t.channels,), dtype=np.float32)
    # fallback for never-visited cells: the iid 'frozen' pick, same rng
    # stream as marginalize_sd(mode='frozen') for reproducibility
    w = sd_marginal_weights(prof.sd)
    rng = np.random.default_rng(seed)
    fallback = rng.choice(nsd, size=int(np.prod(cell_shape)), p=w).reshape(cell_shape)
    for cache_name, chans in head_groups:
        picks, found = _first_visit_picks(prof, side_events.get(cache_name, {}),
                                          cell_shape, slots_to_s)
        pk = np.where(found, picks, fallback)
        sel = np.take_along_axis(
            vals[..., list(chans)], pk[..., None, None], axis=-2)[..., 0, :]
        out[..., list(chans)] = sel
    res = HostTable(values=out.reshape(-1, t.channels).astype(np.float32),
                    shape=cell_shape, row_map=t.row_map, profile=t.profile,
                    has_sd=False, channels=t.channels)
    return res


def fused_head_groups(t: "HostTable"):
    """Cache-name -> channel-index groups for a fused table's layout
    (FUSED_CHANNELS order with conditional s2/fumble tails)."""
    groups = [("s1", (0,)), ("pq", (1, 2)), ("rq", (3, 4)), ("sq", (5, 6))]
    nxt = 7
    if getattr(t, "fused_has_s2", False):
        groups.append(("s2", (nxt, nxt + 1)))
        nxt += 2
    if getattr(t, "fused_has_fumble", False):
        groups.append(("fq", (nxt,)))
    return groups


# ---------------------------------------------------------------------------
# feature grids over a sub-axes product
# ---------------------------------------------------------------------------

def _bshape(axes_present: Sequence[str], sizes: Dict[str, int], kind: str) -> Tuple[int, ...]:
    return tuple(sizes[a] if a == kind else 1 for a in axes_present)


def _axis_grid(axes_present, sizes, kind, reps):
    return reps.reshape(_bshape(axes_present, sizes, kind))


_FEATURE_AXES = {
    "down": ("down",), "distance": ("dist",), "yardsToGoal": ("ytg",),
    "seconds_remaining": ("sec",), "score_diff": ("sd",),
    "is_red_zone": ("ytg",), "goal_to_go": ("dist", "ytg"),
    "fourth_and_short": ("down", "dist"), "fg_range": ("ytg",),
    "half": ("sec",), "two_minute": ("sec",),
    "offenseTimeouts": (), "defenseTimeouts": (),
    "sp_rating_off": (), "sp_offense_rating_off": (),
    "sp_defense_rating_def": (), "sp_rating_def": (),
}


def _feature_values(fname, axes_present, sizes, prof: TableProfile,
                    direction: DirectionContext, cfg: SimConfig):
    g = lambda kind: _axis_grid(axes_present, sizes, kind, prof.reps(kind))
    if fname == "down":
        return g("down")
    if fname == "distance":
        return g("dist")
    if fname == "yardsToGoal":
        return g("ytg")
    if fname == "seconds_remaining":
        return g("sec")
    if fname == "score_diff":
        return g("sd") if "sd" in axes_present else np.float64(0.0)
    if fname == "is_red_zone":
        return (g("ytg") <= 20).astype(np.float64)
    if fname == "goal_to_go":
        return (g("dist") >= g("ytg") - 0.5).astype(np.float64)
    if fname == "fourth_and_short":
        return ((g("down") == 4) & (g("dist") <= 2.0)).astype(np.float64)
    if fname == "fg_range":
        return (g("ytg") <= 33).astype(np.float64)
    if fname == "half":
        return np.where(g("sec") > cfg.clock.half_seconds, 1.0, 2.0)
    if fname == "two_minute":
        return (np.mod(g("sec"), cfg.clock.half_seconds) <= 120).astype(np.float64)
    if fname == "offenseTimeouts" or fname == "defenseTimeouts":
        return np.float64(cfg.timeouts)
    if fname == "sp_rating_off":
        return np.float64(direction.sp_rating_off)
    if fname == "sp_offense_rating_off":
        return np.float64(direction.sp_offense_rating_off)
    if fname == "sp_defense_rating_def":
        return np.float64(direction.sp_defense_rating_def)
    if fname == "sp_rating_def":
        return np.float64(direction.sp_rating_def)
    raise KeyError(fname)


# ---------------------------------------------------------------------------
# grid evaluation of one forest
# ---------------------------------------------------------------------------

def _tree_slices(f: FlatForest):
    roots = list(f.roots) + [f.n_nodes]
    return [(int(roots[i]), int(roots[i + 1])) for i in range(f.n_trees)]


def eval_forest_on_grid(
    f: FlatForest,
    prof: TableProfile,
    direction: DirectionContext,
    cfg: SimConfig,
    slot_cat_ids: Dict[str, np.ndarray],   # group -> (S,) category ids per slot row
    use_sd_axis: bool = False,
) -> np.ndarray:
    """Margins of forest f over the full grid.

    Returns (S, 4, Nd, Ny, Ns[, Nsd], n_classes) float32.
    """
    lay = f.layout
    S = len(next(iter(slot_cat_ids.values()))) if slot_cat_ids else 1
    sizes = {
        "slot": S, "down": len(prof.reps("down")), "dist": len(prof.dist),
        "ytg": len(prof.ytg), "sec": len(prof.sec),
    }
    full_axes = ["slot", "down", "dist", "ytg", "sec"]
    if use_sd_axis:
        sizes["sd"] = len(prof.sd)
        full_axes.append("sd")
    full_shape = tuple(sizes[a] for a in full_axes)
    out = np.zeros(full_shape + (f.n_classes,), dtype=np.float64)
    out += f.base_margin.astype(np.float64)

    # classify each node's feature -> (axes needed, value-fn descriptor)
    ncat = lay.n_cat
    offsets = lay.cat_group_offsets
    names = lay.cat_group_names

    def node_feature_info(gfeat: int):
        if gfeat < ncat:
            for gi in range(len(names) - 1, -1, -1):
                if gfeat >= offsets[gi]:
                    return ("cat", names[gi], gfeat - offsets[gi]), ("slot",)
            raise AssertionError
        fname = lay.numeric_names[gfeat - ncat]
        return ("num", fname, None), _FEATURE_AXES[fname]

    # per-axis raw feature value vectors (float32: inference-time comparison
    # semantics — DMatrix/inplace_predict cast inputs to f32)
    axis_reps = {a: prof.reps({"dist": "dist", "ytg": "ytg", "sec": "sec",
                               "sd": "sd", "down": "down"}.get(a, a)).astype(np.float32)
                 if a != "slot" else np.arange(S)
                 for a in full_axes}

    def full_feature_vec(name: str, axis: str) -> np.ndarray:
        """Single-axis feature value over that axis' reps."""
        reps = axis_reps[axis].astype(np.float32)
        if name in ("down", "distance", "yardsToGoal", "seconds_remaining", "score_diff"):
            return reps
        if name == "is_red_zone":
            return (reps <= 20).astype(np.float32)
        if name == "fg_range":
            return (reps <= 33).astype(np.float32)
        if name == "half":
            return np.where(reps > cfg.clock.half_seconds, 1.0, 2.0).astype(np.float32)
        if name == "two_minute":
            return (np.mod(reps, cfg.clock.half_seconds) <= 120).astype(np.float32)
        raise KeyError(name)

    # Two-tier evaluation:
    #   tier A ("simple" trees: single-axis predicates only, the vast
    #   majority) accumulates on a FOREST-level union grid — per axis, the
    #   distinct branch-behavior levels across all tier-A predicates — and
    #   upsamples to the full grid ONCE per class at the end.
    #   tier B (trees touching a multi-axis feature like goal_to_go or
    #   fourth_and_short) keeps the per-tree level grid + per-tree upsample.
    # This turns the dominant cost (per-tree full-grid broadcast-adds, ~4k
    # trees x millions of cells) into ~n_classes full-grid adds.
    slices = _tree_slices(f)
    const_zero = np.float32(0.0)

    def classify_tree(lo, hi):
        nodes = [i for i in range(lo, hi) if f.feat[i] >= 0]
        node_axis, node_desc = {}, {}
        multi_axes, used_axes = set(), set()
        for i in nodes:
            desc, ax = node_feature_info(int(f.feat[i]))
            ax = tuple(a for a in ax if a != "sd" or use_sd_axis)
            node_desc[i] = desc
            if len(ax) == 0:
                node_axis[i] = None
            elif len(ax) == 1:
                node_axis[i] = ax[0]
                used_axes.add(ax[0])
            else:
                node_axis[i] = "__multi__"
                multi_axes.update(ax)
                used_axes.update(ax)
        return nodes, node_axis, node_desc, multi_axes, used_axes

    def go_left_vec(i, node_desc, node_axis):
        """go_left outcome per rep of the node's axis (or scalar)."""
        kind, name, local = node_desc[i]
        a = node_axis[i]
        if kind == "cat":
            val = (slot_cat_ids[name] == local).astype(np.float32)
        elif a is None:
            if name == "score_diff":
                val = const_zero
            else:
                val = np.float32(_feature_values(name, (), {}, prof, direction, cfg))
        elif a == "__multi__":
            return None
        else:
            val = full_feature_vec(name, a)
        th = np.float32(f.thresh[i])
        gl = (val < th) if f.cmp == "lt" else (val <= th)
        if f.zero_as_missing:
            gl = np.where(val == 0.0, bool(f.default_left[i]), gl)
        return gl

    info = [classify_tree(lo, hi) for lo, hi in slices]

    # ---- forest-level union levels over tier-A predicates -------------------
    union_preds: Dict[str, list] = {}
    for t, (nodes, node_axis, node_desc, multi_axes, used_axes) in enumerate(info):
        if multi_axes:
            continue
        for i in nodes:
            a = node_axis[i]
            if a is not None:
                union_preds.setdefault(a, []).append(
                    np.broadcast_to(go_left_vec(i, node_desc, node_axis),
                                    (sizes[a],)))
    union_axes = tuple(a for a in full_axes if a in union_preds)
    u_map: Dict[str, np.ndarray] = {}
    u_rep: Dict[str, np.ndarray] = {}
    for a in union_axes:
        mat = np.stack(union_preds[a])
        _, first_idx, inv = np.unique(mat, axis=1, return_index=True,
                                      return_inverse=True)
        u_map[a] = inv.astype(np.int64)
        u_rep[a] = first_idx.astype(np.int64)
    u_sizes = {a: len(u_rep[a]) for a in union_axes}
    acc_u = np.zeros(tuple(u_sizes[a] for a in union_axes) + (f.n_classes,),
                     dtype=np.float64)

    def eval_tree_on_levels(t, target_axes, target_sizes, rep_idx):
        """Existing per-tree algorithm generalized: returns (sub_array, sig,
        level_maps) where level_maps map target-axis positions -> tree levels."""
        lo, _ = slices[t]
        nodes, node_axis, node_desc, multi_axes, used_axes = info[t]
        sig = tuple(a for a in target_axes if a in used_axes)

        level_map, level_rep_idx = {}, {}
        for a in sig:
            if a in multi_axes:
                n = target_sizes[a]
                level_map[a] = np.arange(n)
                level_rep_idx[a] = rep_idx[a] if rep_idx else np.arange(n)
                continue
            preds = [go_left_vec(i, node_desc, node_axis)
                     for i in nodes if node_axis[i] == a]
            mat = np.stack([np.broadcast_to(p, (sizes[a],)) for p in preds])
            if rep_idx:  # restrict to the target axis positions
                mat = mat[:, rep_idx[a]]
            _, first_idx, inv = np.unique(mat, axis=1, return_index=True,
                                          return_inverse=True)
            level_map[a] = inv.astype(np.int64)
            src = rep_idx[a] if rep_idx else np.arange(sizes[a])
            level_rep_idx[a] = np.asarray(src)[first_idx]

        lv_sizes = {a: len(np.unique(level_map[a])) for a in sig}
        sub_shape = tuple(lv_sizes[a] for a in sig)
        acc = np.zeros(sub_shape, dtype=np.float64)

        def node_go_left_grid(i):
            a = node_axis[i]
            if a is None:
                return bool(go_left_vec(i, node_desc, node_axis))
            if a == "__multi__":
                kind, name, local = node_desc[i]
                axs = _FEATURE_AXES[name]
                vals = {}
                for ax2 in axs:
                    reps = axis_reps[ax2][level_rep_idx[ax2]].astype(np.float32)
                    shape = tuple(lv_sizes[a3] if a3 == ax2 else 1 for a3 in sig)
                    vals[ax2] = reps.reshape(shape)
                if name == "goal_to_go":
                    val = (vals["dist"] >= vals["ytg"] - 0.5).astype(np.float32)
                elif name == "fourth_and_short":
                    val = ((vals["down"] == 4) & (vals["dist"] <= 2.0)).astype(np.float32)
                else:
                    raise KeyError(name)
                th = np.float32(f.thresh[i])
                gl = (val < th) if f.cmp == "lt" else (val <= th)
                if f.zero_as_missing:
                    gl = np.where(val == 0.0, bool(f.default_left[i]), gl)
                return np.broadcast_to(gl, sub_shape)
            gl = np.broadcast_to(go_left_vec(i, node_desc, node_axis), (sizes[a],))
            gl_lv = gl[level_rep_idx[a]]
            shape = tuple(lv_sizes[a3] if a3 == a else 1 for a3 in sig)
            return np.broadcast_to(gl_lv.reshape(shape), sub_shape)

        def recurse(i, mask):
            if f.feat[i] < 0:
                if sub_shape:
                    acc[mask] += float(f.leaf[i])
                elif mask:
                    acc[...] += float(f.leaf[i])
                return
            gl = node_go_left_grid(i)
            if isinstance(gl, (bool, np.bool_)):
                recurse(int(f.left[i]) if gl else int(f.right[i]), mask)
                return
            lm = mask & gl
            rm = mask & ~gl
            if lm.any():
                recurse(int(f.left[i]), lm)
            if rm.any():
                recurse(int(f.right[i]), rm)

        recurse(lo, np.ones(sub_shape, dtype=bool) if sub_shape else True)
        return acc, sig, level_map

    for t, (lo, hi) in enumerate(slices):
        cls = int(f.tree_class[t])
        nodes, node_axis, node_desc, multi_axes, used_axes = info[t]
        if not nodes:
            out[..., cls] += float(f.leaf[lo])
            continue
        if not multi_axes:
            # tier A: accumulate on the union grid
            acc, sig, level_map = eval_tree_on_levels(
                t, union_axes, u_sizes, u_rep)
            if sig:
                gathered = acc[np.ix_(*[level_map[a] for a in sig])]
                shape = tuple(u_sizes[a] if a in sig else 1 for a in union_axes)
                acc_u[..., cls] += gathered.reshape(shape)
            else:
                acc_u[..., cls] += acc
        else:
            # tier B: per-tree full-grid upsample (rare)
            acc, sig, level_map = eval_tree_on_levels(
                t, full_axes, sizes, None)
            if sig:
                gathered = acc[np.ix_(*[level_map[a] for a in sig])]
                shape = tuple(sizes[a] if a in sig else 1 for a in full_axes)
                out[..., cls] += gathered.reshape(shape)
            else:
                out[..., cls] += acc

    # one full-grid upsample of the union accumulator per class
    if union_axes:
        gathered = acc_u[np.ix_(*[u_map[a] for a in union_axes])]
        shape = tuple(sizes[a] if a in union_axes else 1 for a in full_axes) \
            + (f.n_classes,)
        out += gathered.reshape(
            tuple(sizes[a] if a in union_axes else 1 for a in full_axes)
            + (f.n_classes,))
    else:
        out += acc_u.reshape((1,) * len(full_axes) + (f.n_classes,))

    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# slot / pair deduplication
# ---------------------------------------------------------------------------

def dedupe_slots(cat_ids: np.ndarray, used_locals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(row_ids_per_table_row, slot->row map).  Slots whose category never
    appears in a split collapse onto one 'unseen' row."""
    used = set(int(u) for u in used_locals)
    eff = np.asarray([int(c) if int(c) in used else -1 for c in cat_ids])
    uniq, inv = np.unique(eff, return_inverse=True)
    return uniq.astype(np.int64), inv.astype(np.int32)


def dedupe_pairs(
    qb_ids: np.ndarray, wr_ids: np.ndarray,
    qb_used: np.ndarray, wr_used: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (pair_qb_ids (P,), pair_wr_ids (P,), pairmap (K,K)->row)."""
    qset = set(int(u) for u in qb_used)
    wset = set(int(u) for u in wr_used)
    K = len(qb_ids)
    eff = np.empty((K, K, 2), dtype=np.int64)
    for i, q in enumerate(qb_ids):
        for j, w in enumerate(wr_ids):
            eff[i, j, 0] = int(q) if int(q) in qset else -1
            eff[i, j, 1] = int(w) if int(w) in wset else -1
    flat = eff.reshape(-1, 2)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    return uniq[:, 0], uniq[:, 1], inv.reshape(K, K).astype(np.int32)


# ---------------------------------------------------------------------------
# per-head table build (host side)
# ---------------------------------------------------------------------------

@dataclass
class HostTable:
    values: np.ndarray          # (rows, C) float32, rows = S*5*Nd*Ny*Ns[*Nsd]
    shape: Tuple[int, ...]      # (S, 5, Nd, Ny, Ns[, Nsd])
    row_map: np.ndarray         # slot->row (K,) or flattened pair map (K*K,)
    profile: str                # 'fine' | 'coarse' | 'play'
    has_sd: bool = False
    channels: int = 1


@dataclass
class TableSet:
    """All head tables for ONE possession direction."""
    stage1: Optional[HostTable]
    stage2: Optional[HostTable]
    pq: Optional[HostTable]
    rq: Optional[HostTable]
    sq: Optional[HostTable]
    fumble: Optional[HostTable]
    play: Optional[HostTable]
    fine: TableProfile
    coarse: TableProfile
    # single-gather fusion of all per-play heads (present when every head's
    # player rows collapse to one — e.g. no focus roster); channel layout in
    # FUSED_CHANNELS order, stage-2 channels only when a stage2 forest exists
    fused: Optional[HostTable] = None
    fused_has_s2: bool = False
    fused_has_fumble: bool = False
    # single-gather nano layout (rows = dist*ytg*sec; down/sd in channels)
    nano: Optional[HostTable] = None


FUSED_CHANNELS = ("p_complete", "pq_mu", "pq_sigma", "rq_mu", "rq_sigma",
                  "sq_mu", "sq_sigma", "s2_cum1", "s2_cum2", "p_fumble")


def build_fused_table(direction: DirectionContext, heads, cfg: SimConfig,
                      prof: TableProfile) -> Optional[HostTable]:
    """One multi-channel table over a single profile covering every per-play
    head, valid only when each head's player slots deduplicate to one row.
    The play step then costs ONE gather (channels are contiguous, so the
    row fetch is one cache line) — the table-mode speed king for matchups
    without focus rosters."""
    d = direction

    def single(ids, used):
        rows, _ = dedupe_slots(ids, used)
        return rows if len(rows) == 1 else None

    r_s1 = single(d.qb_stage1, heads.stage1.used_cat_locals("passer_name"))
    r_pq_q = single(d.qb_passq, heads.pass_quants[0].used_cat_locals("passer_name"))
    r_pq_w = single(d.wr_passq, heads.pass_quants[0].used_cat_locals("target_name"))
    r_rq = single(d.rb_rushq, heads.rush_quants[0].used_cat_locals("rusher_name"))
    r_sq = single(d.qb_sackq, heads.sack_quants[0].used_cat_locals("passer_name"))
    if any(r is None for r in (r_s1, r_pq_q, r_pq_w, r_rq, r_sq)):
        return None

    use_sd = prof.sd is not None

    def grid(forest, slot_ids):
        return eval_forest_on_grid(forest, prof, d, cfg, slot_ids,
                                   use_sd_axis=use_sd)

    sig = lambda m: 1.0 / (1.0 + np.exp(-m))
    g1 = grid(heads.stage1, {"passer_name": r_s1})
    ch = [np.clip(sig(g1[..., 0]) + d.bias,
                  cfg.model.stage1_clip_lo, cfg.model.stage1_clip_hi)]

    def q_ms(trio, slot_ids, floor):
        gs = [grid(f, slot_ids)[..., 0] for f in trio]
        sigma = np.maximum(floor, (gs[2] - gs[0]) / cfg.model.sigma_denom)
        return gs[1], sigma

    ch.extend(q_ms(heads.pass_quants,
                   {"passer_name": r_pq_q, "target_name": r_pq_w},
                   cfg.model.pass_sigma_floor))
    ch.extend(q_ms(heads.rush_quants, {"rusher_name": r_rq},
                   cfg.model.rush_sigma_floor))
    ch.extend(q_ms(heads.sack_quants, {"passer_name": r_sq},
                   cfg.model.sack_sigma_floor))

    has_s2 = heads.stage2 is not None
    if has_s2:
        f2 = heads.stage2
        ids2 = {"passer_name": single(d.qb_stage2, f2.used_cat_locals("passer_name"))}
        if "target_name" in f2.layout.cat_group_names:
            t2 = single(d.wr_stage2, f2.used_cat_locals("target_name"))
            if t2 is None or ids2["passer_name"] is None:
                return None
            ids2["target_name"] = t2
        elif ids2["passer_name"] is None:
            return None
        g2 = grid(f2, ids2)
        order = {c: i for i, c in enumerate(heads.stage2_class_order)}
        z = g2 - g2.max(axis=-1, keepdims=True)
        e = np.exp(z)
        p = e / e.sum(axis=-1, keepdims=True)
        inc, itc, sck = (p[..., order[k]] for k in
                         ("incomplete", "intercepted", "sack"))
        inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg, np)
        ch.extend([inc, inc + sck])

    has_fum = heads.fumble is not None and cfg.model.enable_fumbles
    if has_fum:
        rf = single(d.rb_fumble, heads.fumble.used_cat_locals("rusher_name"))
        if rf is None:
            return None
        ch.append(sig(grid(heads.fumble, {"rusher_name": rf})[..., 0]))

    vals = np.stack(ch, axis=-1).astype(np.float32)
    t = HostTable(values=vals.reshape(-1, vals.shape[-1]),
                  shape=vals.shape[:-1], row_map=np.zeros(1, np.int64),
                  profile="fused", channels=vals.shape[-1], has_sd=use_sd)
    t.fused_has_s2 = has_s2           # type: ignore[attr-defined]
    t.fused_has_fumble = has_fum      # type: ignore[attr-defined]
    return t


def nano_from_fused(t: HostTable, prof: TableProfile) -> HostTable:
    """Re-layout a fused HostTable for the single-gather nano path: rows =
    dist*ytg*sec; the down axis and (when present) the sd axis move into
    channels, ordered (down, sd, head_channel) — see nano_profile() for the
    row-count rationale.  Values are bit-identical to the fused table's
    (same grid evaluation, only the memory layout differs)."""
    c = t.channels
    nd, ny, ns = len(prof.dist), len(prof.ytg), len(prof.sec)
    nsd = len(prof.sd) if t.has_sd else 1
    grid = t.values.reshape(1, 5, nd, ny, ns, nsd, c)
    vals = np.ascontiguousarray(grid[0].transpose(1, 2, 3, 0, 4, 5))
    out = HostTable(values=vals.reshape(nd * ny * ns, 5 * nsd * c),
                    shape=(1, nd, ny, ns), row_map=np.zeros(1, np.int64),
                    profile="nano", channels=5 * nsd * c, has_sd=False)
    out.nano_nsd = nsd                                        # type: ignore[attr-defined]
    out.nano_c = c                                            # type: ignore[attr-defined]
    out.fused_has_s2 = getattr(t, "fused_has_s2", False)      # type: ignore[attr-defined]
    out.fused_has_fumble = getattr(t, "fused_has_fumble", False)  # type: ignore[attr-defined]
    return out


def _finalize(grid: np.ndarray, post: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """grid (..., C_raw) -> flattened (rows, C_out)."""
    out = post(grid)
    return out.reshape(-1, out.shape[-1]).astype(np.float32)


def build_tables(
    direction: DirectionContext,
    heads,
    cfg: SimConfig,
    fine: Optional[TableProfile] = None,
    coarse: Optional[TableProfile] = None,
) -> TableSet:
    from .heads import ModelHeads  # circular-safe

    fine = fine or fine_profile()
    coarse = coarse or coarse_profile()
    d = direction

    def sig(p):  # sigmoid
        return 1.0 / (1.0 + np.exp(-p))

    # ---- stage1: clip(sigmoid + bias) -------------------------------------
    f1 = heads.stage1
    s1_sd = fine.sd is not None
    rows1, map1 = dedupe_slots(d.qb_stage1, f1.used_cat_locals("passer_name"))
    g = eval_forest_on_grid(f1, fine, d, cfg, {"passer_name": rows1},
                            use_sd_axis=s1_sd)
    t_stage1 = HostTable(
        values=_finalize(g, lambda m: np.clip(
            sig(m[..., :1]) + d.bias, cfg.model.stage1_clip_lo, cfg.model.stage1_clip_hi)),
        shape=g.shape[:-1], row_map=map1, profile="fine", channels=1, has_sd=s1_sd)

    # ---- stage2 (forest if present): post-nudge cumulative ----------------
    t_stage2 = None
    pairmap_s2 = None
    if heads.stage2 is not None:
        f2 = heads.stage2
        has_t = "target_name" in f2.layout.cat_group_names
        if has_t:
            pq_ids, pw_ids, pairmap_s2 = dedupe_pairs(
                d.qb_stage2, d.wr_stage2,
                f2.used_cat_locals("passer_name"), f2.used_cat_locals("target_name"))
            slot_ids = {"passer_name": pq_ids, "target_name": pw_ids}
            rmap = pairmap_s2.reshape(-1)
        else:
            rows2, rmap = dedupe_slots(d.qb_stage2, f2.used_cat_locals("passer_name"))
            slot_ids = {"passer_name": rows2}
        g = eval_forest_on_grid(f2, coarse, d, cfg, slot_ids)

        order = {c: i for i, c in enumerate(heads.stage2_class_order)}

        def post2(m):
            z = m - m.max(axis=-1, keepdims=True)
            e = np.exp(z)
            p = e / e.sum(axis=-1, keepdims=True)
            inc = p[..., order["incomplete"]]
            itc = p[..., order["intercepted"]]
            sck = p[..., order["sack"]]
            inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg, np)
            return np.stack([inc, inc + sck], axis=-1)

        t_stage2 = HostTable(values=_finalize(g, post2), shape=g.shape[:-1],
                             row_map=rmap, profile="coarse", channels=2)

    # ---- quantile heads: (q50, sigma) --------------------------------------
    def quant_table(trio, slot_ids, rmap, floor, use_sd=False) -> HostTable:
        gs = [eval_forest_on_grid(f, coarse, d, cfg, slot_ids, use_sd_axis=use_sd)
              for f in trio]
        q10, q50, q90 = (x[..., 0] for x in gs)
        sigma = np.maximum(floor, (q90 - q10) / cfg.model.sigma_denom)
        vals = np.stack([q50, sigma], axis=-1)
        return HostTable(values=vals.reshape(-1, 2).astype(np.float32),
                         shape=gs[0].shape[:-1], row_map=rmap,
                         profile="coarse", channels=2, has_sd=use_sd)

    pq_sd = coarse.sd is not None
    pq_ids, pw_ids, pairmap = dedupe_pairs(
        d.qb_passq, d.wr_passq,
        heads.pass_quants[0].used_cat_locals("passer_name"),
        heads.pass_quants[0].used_cat_locals("target_name"))
    t_pq = quant_table(heads.pass_quants,
                       {"passer_name": pq_ids, "target_name": pw_ids},
                       pairmap.reshape(-1), cfg.model.pass_sigma_floor,
                       use_sd=pq_sd)

    rrows, rmap_r = dedupe_slots(d.rb_rushq, heads.rush_quants[0].used_cat_locals("rusher_name"))
    t_rq = quant_table(heads.rush_quants, {"rusher_name": rrows}, rmap_r,
                       cfg.model.rush_sigma_floor)

    srows, rmap_s = dedupe_slots(d.qb_sackq, heads.sack_quants[0].used_cat_locals("passer_name"))
    t_sq = quant_table(heads.sack_quants, {"passer_name": srows}, rmap_s,
                       cfg.model.sack_sigma_floor)

    # ---- fumble -------------------------------------------------------------
    t_fum = None
    if heads.fumble is not None and cfg.model.enable_fumbles:
        frows, fmap = dedupe_slots(d.rb_fumble, heads.fumble.used_cat_locals("rusher_name"))
        g = eval_forest_on_grid(heads.fumble, coarse, d, cfg, {"rusher_name": frows})
        t_fum = HostTable(values=_finalize(g, lambda m: sig(m[..., :1])),
                          shape=g.shape[:-1], row_map=fmap, profile="coarse", channels=1)

    # ---- ML play policy (score_diff axis) -----------------------------------
    t_play = None
    if heads.play is not None and cfg.model.use_play_model:
        fp = heads.play
        prof = TableProfile(dist=coarse.dist, ytg=coarse.ytg, sec=coarse.sec,
                            sd=sd_reps_default())
        coach = np.asarray([d.coach_id], dtype=np.int64)
        g = eval_forest_on_grid(fp, prof, d, cfg, {"head_coach": coach}, use_sd_axis=True)

        ip, ir = heads.play_classes.index("pass") if "pass" in heads.play_classes else 0, None
        if "run" in heads.play_classes and len(heads.play_classes) > 2:
            ir = heads.play_classes.index("run")

        def postp(m):
            z = m / max(1e-6, heads.play_temperature)
            z = z - z.max(axis=-1, keepdims=True)
            e = np.exp(z)
            p = e / e.sum(axis=-1, keepdims=True)
            pp = p[..., ip]
            if ir is not None:
                pp = pp / np.maximum(1e-9, pp + p[..., ir])
            return np.clip(pp, cfg.model.play_clip_lo, cfg.model.play_clip_hi)[..., None]

        t_play = HostTable(values=_finalize(g, postp), shape=g.shape[:-1],
                           row_map=np.zeros(1, np.int32), profile="play",
                           has_sd=True, channels=1)

    return TableSet(stage1=t_stage1, stage2=t_stage2, pq=t_pq, rq=t_rq, sq=t_sq,
                    fumble=t_fum, play=t_play, fine=fine, coarse=coarse)
