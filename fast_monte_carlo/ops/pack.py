"""Device packing of matchup context and model heads.

MatchupPack holds everything game-state-independent for ONE matchup (both
possession directions) as device arrays indexed by direction (0 = team A on
offense, 1 = team B on offense).  HeadsPack holds the compiled forests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SimConfig
from ..matchup import DirectionContext, build_direction
from ..models.heads import ModelHeads
from .forest_eval import JaxForest, pack_forest


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MatchupPack:
    sp: jnp.ndarray           # (2,4) rating_off, offense_off, defense_def, rating_def
    bias: jnp.ndarray         # (2,)
    ymult: jnp.ndarray        # (2,)
    mz: jnp.ndarray           # (2,)
    off_offense: jnp.ndarray  # (2,) offense's SP OFFENSE (for tilt functions)
    def_defense: jnp.ndarray  # (2,) defense's SP DEFENSE
    qb_cum: jnp.ndarray       # (2,K)
    wr_cum: jnp.ndarray
    rb_cum: jnp.ndarray
    qb_tracked: jnp.ndarray   # (2,K) bool
    wr_tracked: jnp.ndarray
    rb_tracked: jnp.ndarray
    ids_qb_stage1: jnp.ndarray  # (2,K) int32
    ids_qb_passq: jnp.ndarray
    ids_qb_sackq: jnp.ndarray
    ids_qb_stage2: jnp.ndarray
    ids_wr_passq: jnp.ndarray
    ids_wr_stage2: jnp.ndarray
    ids_rb_rushq: jnp.ndarray
    ids_rb_fumble: jnp.ndarray
    coach_id: jnp.ndarray     # (2,) int32

    @property
    def k(self) -> int:
        return self.qb_cum.shape[1]


def pack_matchup(dir_a: DirectionContext, dir_b: DirectionContext) -> MatchupPack:
    return pack_matchups([dir_a, dir_b])


def pack_matchups(dirs) -> MatchupPack:
    """Direction-indexed pack: rows are [g0 A-off, g0 B-off, g1 A-off, ...]
    for a multi-matchup slate sharing one compiled program (the
    ('game','trial') layout of SURVEY §2.4/§7.1: games select table/pack
    rows, trials are the sharded batch axis)."""
    def two(fn):
        return jnp.asarray(np.stack([fn(d) for d in dirs]))

    return MatchupPack(
        sp=two(lambda d: np.asarray([d.sp_rating_off, d.sp_offense_rating_off,
                                     d.sp_defense_rating_def, d.sp_rating_def],
                                    dtype=np.float32)),
        bias=two(lambda d: np.float32(d.bias)),
        ymult=two(lambda d: np.float32(d.ymult)),
        mz=two(lambda d: np.float32(d.mz)),
        off_offense=two(lambda d: np.float32(d.off.sp_offense)),
        def_defense=two(lambda d: np.float32(d.deff.sp_defense)),
        qb_cum=two(lambda d: d.qb_cum.astype(np.float32)),
        wr_cum=two(lambda d: d.wr_cum.astype(np.float32)),
        rb_cum=two(lambda d: d.rb_cum.astype(np.float32)),
        qb_tracked=two(lambda d: d.off.qb.tracked),
        wr_tracked=two(lambda d: d.off.target.tracked),
        rb_tracked=two(lambda d: d.off.rush.tracked),
        ids_qb_stage1=two(lambda d: d.qb_stage1.astype(np.int32)),
        ids_qb_passq=two(lambda d: d.qb_passq.astype(np.int32)),
        ids_qb_sackq=two(lambda d: d.qb_sackq.astype(np.int32)),
        ids_qb_stage2=two(lambda d: d.qb_stage2.astype(np.int32)),
        ids_wr_passq=two(lambda d: d.wr_passq.astype(np.int32)),
        ids_wr_stage2=two(lambda d: d.wr_stage2.astype(np.int32)),
        ids_rb_rushq=two(lambda d: d.rb_rushq.astype(np.int32)),
        ids_rb_fumble=two(lambda d: d.rb_fumble.astype(np.int32)),
        coach_id=two(lambda d: np.int32(d.coach_id)),
    )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class HeadsPack:
    stage1: Optional[JaxForest]
    stage2: Optional[JaxForest]
    pq: Optional[Tuple[JaxForest, JaxForest, JaxForest]]
    rq: Optional[Tuple[JaxForest, JaxForest, JaxForest]]
    sq: Optional[Tuple[JaxForest, JaxForest, JaxForest]]
    fumble: Optional[JaxForest]
    play: Optional[JaxForest]
    play_temperature: float = field(metadata=dict(static=True), default=1.0)
    play_pass_idx: int = field(metadata=dict(static=True), default=0)
    play_run_idx: int = field(metadata=dict(static=True), default=-1)
    stage2_order: Tuple[int, int, int] = field(
        metadata=dict(static=True), default=(0, 1, 2)
    )  # column indices of (incomplete, intercepted, sack) in stage2 output
    # all heads' trees in one walk (exact mode fast path; ops/forest_eval.py
    # MergedForest) — None only when stage1/quantile heads are absent
    merged: Optional[object] = None


def _heads_sig(heads: ModelHeads) -> tuple:
    """Cheap identity fingerprint of the pack-relevant fields: reassigning
    any forest (e.g. tests swapping in a retrained stage2) changes the ids
    and invalidates the instance memo below."""
    return (
        id(heads.stage1), id(heads.stage2), tuple(heads.stage2_class_order),
        tuple(map(id, heads.pass_quants or ())),
        tuple(map(id, heads.rush_quants or ())),
        tuple(map(id, heads.sack_quants or ())),
        id(heads.fumble), id(heads.play),
        float(heads.play_temperature),
        tuple(heads.play_classes or ()),
    )


def pack_heads(heads: ModelHeads) -> HeadsPack:
    # memoized per heads instance: packing re-flattens and re-uploads every
    # forest (12 pack_forest calls + the MergedForest build) — pure in the
    # heads, so a 60-matchup slate must pay it once, not per MatchupRunner
    cached = getattr(heads, "_heads_pack_memo", None)
    sig = _heads_sig(heads)
    if cached is not None and cached[0] == sig:
        return cached[1]

    def trio(t):
        return tuple(pack_forest(f) for f in t) if t else None

    pass_idx, run_idx = 0, -1
    if heads.play is not None:
        if "pass" in heads.play_classes:
            pass_idx = heads.play_classes.index("pass")
        if "run" in heads.play_classes and len(heads.play_classes) > 2:
            run_idx = heads.play_classes.index("run")
    s2_order = (0, 1, 2)
    if heads.stage2 is not None:
        pos = {c: i for i, c in enumerate(heads.stage2_class_order)}
        s2_order = (pos["incomplete"], pos["intercepted"], pos["sack"])
    hp = HeadsPack(
        stage1=pack_forest(heads.stage1) if heads.stage1 else None,
        stage2=pack_forest(heads.stage2) if heads.stage2 else None,
        pq=trio(heads.pass_quants),
        rq=trio(heads.rush_quants),
        sq=trio(heads.sack_quants),
        fumble=pack_forest(heads.fumble) if heads.fumble else None,
        play=pack_forest(heads.play) if heads.play else None,
        play_temperature=float(heads.play_temperature),
        play_pass_idx=pass_idx,
        play_run_idx=run_idx,
        stage2_order=s2_order,
        merged=_merge_heads(heads),
    )
    # the third slot pins strong references to every forest in the sig:
    # ids are only unique among LIVE objects, so without these a freed
    # forest's id could be reused by a replacement and false-hit the memo
    refs = (heads.stage1, heads.stage2, heads.pass_quants,
            heads.rush_quants, heads.sack_quants, heads.fumble, heads.play)
    heads._heads_pack_memo = (sig, hp, refs)
    return hp


def _merge_heads(heads: ModelHeads):
    """Build the one-walk MergedForest for exact mode (None if the core
    heads are missing).  Cat-column labels name the per-trial id source the
    engine gathers from the MatchupPack."""
    from ..models.heads import ST1_FEATURES
    from .forest_eval import merge_forests

    if heads.stage1 is None or not heads.pass_quants \
            or not heads.rush_quants or not heads.sack_quants:
        return None
    named = [("stage1", heads.stage1, {"passer_name": "qb_stage1"})]
    if heads.stage2 is not None:
        cmap = {"passer_name": "qb_stage2"}
        if "target_name" in heads.stage2.layout.cat_group_names:
            cmap["target_name"] = "wr_stage2"
        named.append(("stage2", heads.stage2, cmap))
    for i, f in enumerate(heads.pass_quants):
        named.append((f"pq{i}", f, {"passer_name": "qb_passq",
                                    "target_name": "wr_passq"}))
    for i, f in enumerate(heads.rush_quants):
        named.append((f"rq{i}", f, {"rusher_name": "rb_rushq"}))
    for i, f in enumerate(heads.sack_quants):
        named.append((f"sq{i}", f, {"passer_name": "qb_sackq"}))
    if heads.fumble is not None:
        named.append(("fumble", heads.fumble, {"rusher_name": "rb_fumble"}))
    if heads.play is not None:
        named.append(("play", heads.play, {"head_coach": "coach"}))
    try:
        return merge_forests(named, tuple(ST1_FEATURES))
    except (ValueError, KeyError):
        # a head with numerics outside the shared ST1 row can't merge;
        # exact mode falls back to per-forest evaluation
        return None


def build_packs(team_a, team_b, heads: ModelHeads, cfg: SimConfig, coach_map=None):
    dir_a = build_direction(team_a, team_b, heads, cfg, coach_map)
    dir_b = build_direction(team_b, team_a, heads, cfg, coach_map)
    return pack_matchup(dir_a, dir_b), pack_heads(heads)
