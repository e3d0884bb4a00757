"""Per-direction matchup precompute.

For a fixed (offense context, defense context) pair, everything the models
need that does not change during a game is resolved here once, host-side:
SP+ feature values, analytic tilt scalars, per-player-slot category ids for
every forest head, and cumulative share vectors for player sampling.

Both the CPU oracle and the device engine consume this; the device engine
additionally packs it into device arrays (ops/pack.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from .config import SimConfig
from .data.context import TeamContext
from .models import analytic
from .models.heads import ModelHeads

# Reference hardcodes four coaches (fast_monte_carlo_cfb.py:55-61); callers
# may pass a richer map.
DEFAULT_HEAD_COACH_MAP = {
    "Kansas State": "Chris Klieman",
    "Iowa State": "Matt Campbell",
    "Kansas": "Lance Leipold",
    "Fresno State": "Matt Entz",
}


@dataclass
class DirectionContext:
    """Offense `off` with ball against defense `deff`."""

    off: TeamContext
    deff: TeamContext
    cfg: SimConfig

    # SP+ features in ST1 order positions 8..11
    sp_rating_off: float = 0.0
    sp_offense_rating_off: float = 0.0
    sp_defense_rating_def: float = 0.0
    sp_rating_def: float = 0.0

    # analytic scalars
    bias: float = 0.0
    ymult: float = 1.0
    mz: float = 0.0

    # per-slot model category ids (K,) per head
    qb_stage1: np.ndarray = field(default=None)
    qb_passq: np.ndarray = field(default=None)
    qb_sackq: np.ndarray = field(default=None)
    qb_stage2: np.ndarray = field(default=None)
    wr_passq: np.ndarray = field(default=None)
    wr_stage2: np.ndarray = field(default=None)
    rb_rushq: np.ndarray = field(default=None)
    rb_fumble: np.ndarray = field(default=None)
    coach_id: int = -1

    # sampling cumshares (K,)
    qb_cum: np.ndarray = field(default=None)
    wr_cum: np.ndarray = field(default=None)
    rb_cum: np.ndarray = field(default=None)


def build_direction(
    off: TeamContext,
    deff: TeamContext,
    heads: ModelHeads,
    cfg: SimConfig,
    coach_map: Optional[Dict[str, str]] = None,
) -> DirectionContext:
    coach_map = DEFAULT_HEAD_COACH_MAP if coach_map is None else coach_map
    d = DirectionContext(off=off, deff=deff, cfg=cfg)
    d.sp_rating_off = off.sp_rating
    d.sp_offense_rating_off = off.sp_offense
    d.sp_defense_rating_def = deff.sp_defense
    d.sp_rating_def = deff.sp_rating
    d.bias = float(analytic.matchup_bias(off.sp_offense, deff.sp_defense, cfg))
    d.ymult = float(analytic.yardage_multiplier(off.sp_offense, deff.sp_defense, cfg))
    d.mz = float(analytic.mismatch_z(off.sp_offense, deff.sp_defense, cfg))

    qb_names = [off.qb.model_name(k) for k in range(off.qb.k)]
    wr_names = [off.target.model_name(k) for k in range(off.target.k)]
    rb_names = [off.rush.model_name(k) for k in range(off.rush.k)]

    d.qb_stage1 = heads.cat_ids_for("stage1", "passer_name", qb_names)
    d.qb_passq = heads.cat_ids_for("pass", "passer_name", qb_names)
    d.qb_sackq = heads.cat_ids_for("sack", "passer_name", qb_names)
    d.qb_stage2 = heads.cat_ids_for("stage2", "passer_name", qb_names)
    d.wr_passq = heads.cat_ids_for("pass", "target_name", wr_names)
    d.wr_stage2 = (
        heads.cat_ids_for("stage2", "target_name", wr_names)
        if heads.stage2 is not None and "target_name" in heads.stage2.layout.cat_group_names
        else np.full(len(wr_names), -1, dtype=np.int64)
    )
    d.rb_rushq = heads.cat_ids_for("rush", "rusher_name", rb_names)
    d.rb_fumble = heads.cat_ids_for("fumble", "rusher_name", rb_names)

    coach = coach_map.get(off.name)
    if heads.play is not None and coach is not None:
        d.coach_id = heads.play.layout.cat_id("head_coach", coach)

    d.qb_cum = off.qb.cum_share
    d.wr_cum = off.target.cum_share
    d.rb_cum = off.rush.cum_share
    return d
