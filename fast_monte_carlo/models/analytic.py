"""Closed-form model components, parameterized by SimConfig.

These are the reference's hand-tuned analytic pieces (SP+ tilts, heuristic
play-call policy, 4th-down go table, FG curve) plus the analytic stage-2
fallback.  Every function is written array-module-generic: pass ``xp=numpy``
(oracle) or ``xp=jax.numpy`` (device engine); scalars work through numpy.

Reference provenance is cited per function; constants live in
fast_monte_carlo.config, never inline.
"""
from __future__ import annotations

import numpy as np

from ..config import SimConfig


def softclip(x, lo, hi, xp=np):
    return xp.minimum(xp.maximum(x, lo), hi)


# ---------------------------------------------------------------------------
# SP+ matchup adjustments (fast_monte_carlo_cfb.py:431-484)
# ---------------------------------------------------------------------------

def matchup_bias(off_offense: float, def_defense: float, cfg: SimConfig, xp=np):
    m = cfg.matchup
    return m.bias_k * (off_offense - def_defense) / m.bias_denom


def yardage_multiplier(off_offense: float, def_defense: float, cfg: SimConfig, xp=np):
    m = cfg.matchup
    return 1.0 + m.ymult_k * xp.tanh((off_offense - def_defense) / m.ymult_denom)


def mismatch_z(off_offense: float, def_defense: float, cfg: SimConfig, xp=np):
    return (off_offense - def_defense) / cfg.matchup.mismatch_denom


def rz_finish_prob_pass(ytg, down, off_offense, def_defense, cfg: SimConfig, xp=np):
    m = cfg.matchup
    base = m.rz_pass_base + m.rz_pass_slope * xp.maximum(0.0, 7.0 - ytg) / 7.0
    base = base + m.rz_pass_down_bonus * xp.maximum(0, 4 - down)
    tilt = m.rz_pass_tilt * xp.tanh((off_offense - def_defense) / m.rz_pass_tilt_denom)
    return softclip(base + tilt, m.rz_pass_lo, m.rz_pass_hi, xp)


def rz_finish_prob_run(ytg, down, off_offense, def_defense, cfg: SimConfig, xp=np):
    m = cfg.matchup
    base = m.rz_run_base + m.rz_run_slope * xp.maximum(0.0, 7.0 - ytg) / 7.0
    base = base + m.rz_run_down_bonus * xp.maximum(0, 4 - down)
    tilt = m.rz_run_tilt * xp.tanh((off_offense - def_defense) / m.rz_run_tilt_denom)
    return softclip(base + tilt, m.rz_run_lo, m.rz_run_hi, xp)


def explosive_prob(ytg, off_offense, def_defense, cfg: SimConfig, xp=np):
    m = cfg.matchup
    z = mismatch_z(off_offense, def_defense, cfg, xp)
    base = m.explosive_base + m.explosive_z_k * z
    base = base + xp.where(ytg > 60, m.explosive_bonus_60, 0.0)
    base = base + xp.where(ytg > 40, m.explosive_bonus_40, 0.0)
    return softclip(base, m.explosive_lo, m.explosive_hi, xp)


def sack_scale(off_offense, def_defense, cfg: SimConfig, xp=np):
    """Defined-but-unused in the reference (:463-465); kept for parity."""
    z = mismatch_z(off_offense, def_defense, cfg, xp)
    return softclip(xp.exp(-1.0 * z), 0.60, 1.50, xp)


# ---------------------------------------------------------------------------
# Heuristic play-call policy (fast_monte_carlo_cfb.py:719-735)
# ---------------------------------------------------------------------------

def pass_prob_v1(down, distance, ytg, seconds_remaining, score_diff, cfg: SimConfig, xp=np):
    m = cfg.model
    base = 0.53
    base = base + xp.where(down == 1, 0.02 + 0.010 * xp.maximum(0.0, distance - 10) / 10, 0.0)
    base = base + xp.where(down == 2, 0.12 + 0.020 * xp.maximum(0.0, distance - 7) / 10, 0.0)
    base = base + xp.where(down == 3, 0.28 + 0.030 * xp.maximum(0.0, distance - 5) / 10, 0.0)
    base = base + xp.where(down == 4, 0.45 + 0.035 * xp.maximum(0.0, distance - 3) / 10, 0.0)
    base = base - xp.where(ytg <= 10, 0.05, 0.0)
    base = base - xp.where(ytg <= 5, 0.03, 0.0)
    two_min = (seconds_remaining % cfg.clock.half_seconds) <= 120
    base = base + xp.where(two_min & (score_diff < 0), 0.22, 0.0)
    base = base + xp.where((seconds_remaining < 600) & (score_diff < 0), 0.06, 0.0)
    return softclip(base, m.heuristic_clip_lo, m.heuristic_clip_hi, xp)


# ---------------------------------------------------------------------------
# 4th-down go-for-it policy (fast_monte_carlo_cfb.py:1336-1378)
# ---------------------------------------------------------------------------

def go_for_it_prob(ytg, dist, score_diff, seconds_remaining, cfg: SimConfig, xp=np):
    f = cfg.fourth
    p = 0.0 * xp.asarray(ytg, dtype=np.float32)
    # field-position buckets, highest bound first; each row applies only where
    # ytg falls in (this_bound, prev_bound]
    prev_bound = np.inf
    for bound, dist_rows in f.table:
        in_bucket = (ytg > bound) & (ytg <= prev_bound)
        bucket_p = 0.0 * xp.asarray(ytg, dtype=np.float32)
        prev_dist = -np.inf
        for dmax, prob in dist_rows:
            bucket_p = xp.where((dist > prev_dist) & (dist <= dmax), prob, bucket_p)
            prev_dist = dmax
        p = xp.where(in_bucket, bucket_p, p)
        prev_bound = bound

    # leading late: slightly conservative
    p = xp.where((seconds_remaining < f.late_seconds) & (score_diff > 0),
                 p * f.late_leading_scale, p)
    # trailing late: aggressive override
    late_trail = (seconds_remaining < f.late_seconds) & (score_diff < 0)
    p = xp.where(late_trail,
                 xp.where(ytg > f.late_trailing_long_fg_ytg,
                          f.late_trailing_go_long, f.late_trailing_go_short),
                 p)
    return softclip(p, 0.0, 1.0, xp)


# ---------------------------------------------------------------------------
# Special teams curves (fast_monte_carlo_cfb.py:858-874)
# ---------------------------------------------------------------------------

def field_goal_prob(attempt_dist, cfg: SimConfig, xp=np):
    st = cfg.st
    p = 0.0 * xp.asarray(attempt_dist, dtype=np.float32) + st.fg_long_prob
    for bound, prob in reversed(st.fg_curve):
        p = xp.where(attempt_dist < bound, prob, p)
    return p


# ---------------------------------------------------------------------------
# Analytic stage-2 fallback (artifact missing from the snapshot, SURVEY §0.1)
# ---------------------------------------------------------------------------

# Conditional rates among non-complete dropbacks, before the reference's
# in-sim nudge (sack*0.65, int*1.2+0.004, fast_monte_carlo_cfb.py:767-768).
# Reconstructed from FBS aggregate dropback outcome rates; the recipe to
# retrain the real booster is train/pipeline.py (mirrors
# reference train_pass_outcome_stage2.py).
STAGE2_FALLBACK_BASE = dict(incomplete=0.780, intercepted=0.075, sack=0.145)


def stage2_fallback_probs(down, distance, cfg: SimConfig, xp=np):
    """(p_incomplete, p_intercepted, p_sack | not complete), lightly
    situation-modulated: sacks rise on late downs & long distance; picks rise
    slightly with distance."""
    b_inc = STAGE2_FALLBACK_BASE["incomplete"]
    b_int = STAGE2_FALLBACK_BASE["intercepted"]
    b_sck = STAGE2_FALLBACK_BASE["sack"]
    d = xp.asarray(distance, dtype=np.float32)
    long_d = xp.maximum(0.0, d - 7.0) / 10.0
    p_sck = b_sck * (1.0 + 0.25 * xp.where(down >= 3, 1.0, 0.0) + 0.15 * long_d)
    p_int = b_int * (1.0 + 0.10 * long_d)
    p_inc = b_inc + 0.0 * p_sck
    s = p_inc + p_int + p_sck
    return p_inc / s, p_int / s, p_sck / s


def stage2_nudge(p_inc, p_int, p_sck, cfg: SimConfig, xp=np):
    """The reference's hand nudge + renorm (fast_monte_carlo_cfb.py:762-770)."""
    m = cfg.model
    p_inc = xp.maximum(0.0, p_inc)
    p_int = xp.maximum(0.0, p_int) * m.stage2_int_scale + m.stage2_int_add
    p_sck = xp.maximum(0.0, p_sck) * m.stage2_sack_scale
    s = p_inc + p_int + p_sck
    s = xp.where(s == 0.0, 1.0, s)
    return p_inc / s, p_int / s, p_sck / s
