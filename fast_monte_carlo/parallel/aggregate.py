"""On-device aggregation of trial results.

The reference aggregates by appending result rows in the parent process and
running pandas groupbys (fast_monte_carlo_cfb.py:1501-1506, 1681-1687) and
numpy reductions over saved CSVs (edge_finder.py:309-332).  Here the
reductions run on device over the (possibly sharded) trial axis, and only
small summaries transfer to the host:

  * win/loss/push rates, mean/sd points           (summary parity :1681-1687)
  * score / margin / total histograms             (empirical CDFs for edges)
  * cover and total probabilities at given lines  (edge_finder parity)
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import jax.numpy as jnp

MAX_PTS = 128          # per-team score histogram support [0, 128)
MARGIN_OFF = 128       # margin histogram support [-128, 128)


class ScoreSummary(NamedTuple):
    n: jnp.ndarray
    mean_pts: jnp.ndarray      # (2,)
    sd_pts: jnp.ndarray        # (2,)
    win_rate: jnp.ndarray      # (2,) P(team i wins), ties excluded
    tie_rate: jnp.ndarray
    pts_hist: jnp.ndarray      # (2, MAX_PTS)
    margin_hist: jnp.ndarray   # (2*MARGIN_OFF,) margin = pts0 - pts1
    total_hist: jnp.ndarray    # (2*MAX_PTS,)


def summarize_scores(score: jnp.ndarray) -> ScoreSummary:
    """score: (B, 2) int. All reductions are device-side; with a sharded
    trial axis XLA inserts the psums."""
    s = score.astype(jnp.float32)
    n = jnp.asarray(score.shape[0], jnp.float32)
    mean = s.mean(axis=0)
    sd = s.std(axis=0, ddof=1)
    w0 = (score[:, 0] > score[:, 1]).mean()
    w1 = (score[:, 1] > score[:, 0]).mean()
    tie = (score[:, 0] == score[:, 1]).mean()
    h0 = jnp.bincount(jnp.clip(score[:, 0], 0, MAX_PTS - 1), length=MAX_PTS)
    h1 = jnp.bincount(jnp.clip(score[:, 1], 0, MAX_PTS - 1), length=MAX_PTS)
    margin = jnp.clip(score[:, 0] - score[:, 1] + MARGIN_OFF, 0, 2 * MARGIN_OFF - 1)
    mh = jnp.bincount(margin, length=2 * MARGIN_OFF)
    th = jnp.bincount(jnp.clip(score[:, 0] + score[:, 1], 0, 2 * MAX_PTS - 1),
                      length=2 * MAX_PTS)
    return ScoreSummary(
        n=n, mean_pts=mean, sd_pts=sd,
        win_rate=jnp.stack([w0, w1]), tie_rate=tie,
        pts_hist=jnp.stack([h0, h1]), margin_hist=mh, total_hist=th,
    )


class ScoreMoments(NamedTuple):
    """Additive device-side reductions of one launch's scores: accumulating
    these across pipelined launches and transferring ONCE is the fast path
    for large-n market scans (per-launch host transfers would serialize
    dispatch)."""
    n: jnp.ndarray             # game count
    wins: jnp.ndarray          # (2,) win counts
    ties: jnp.ndarray
    s_sum: jnp.ndarray         # (2,) point sums
    s_sumsq: jnp.ndarray       # (2,)
    pts_hist: jnp.ndarray      # (2, MAX_PTS)
    margin_hist: jnp.ndarray
    total_hist: jnp.ndarray

    def __add__(self, o: "ScoreMoments") -> "ScoreMoments":
        return ScoreMoments(*(a + b for a, b in zip(self, o)))


def score_moments(score: jnp.ndarray) -> ScoreMoments:
    """Counts/sums/histograms of one (B, 2) score batch — every field is
    additive across batches (jit this; see MatchupRunner.run_pairs_summary)."""
    s = score.astype(jnp.float32)
    h0 = jnp.bincount(jnp.clip(score[:, 0], 0, MAX_PTS - 1), length=MAX_PTS)
    h1 = jnp.bincount(jnp.clip(score[:, 1], 0, MAX_PTS - 1), length=MAX_PTS)
    margin = jnp.clip(score[:, 0] - score[:, 1] + MARGIN_OFF, 0, 2 * MARGIN_OFF - 1)
    return ScoreMoments(
        n=jnp.asarray(score.shape[0], jnp.float32),
        wins=jnp.stack([(score[:, 0] > score[:, 1]).sum(),
                        (score[:, 1] > score[:, 0]).sum()]).astype(jnp.float32),
        ties=(score[:, 0] == score[:, 1]).sum().astype(jnp.float32),
        s_sum=s.sum(axis=0), s_sumsq=(s * s).sum(axis=0),
        pts_hist=jnp.stack([h0, h1]),
        margin_hist=jnp.bincount(margin, length=2 * MARGIN_OFF),
        total_hist=jnp.bincount(
            jnp.clip(score[:, 0] + score[:, 1], 0, 2 * MAX_PTS - 1),
            length=2 * MAX_PTS),
    )


def summary_from_moments(m: ScoreMoments) -> ScoreSummary:
    """Finalize accumulated moments into the same ScoreSummary
    summarize_scores produces (sd uses ddof=1 like jnp.std(ddof=1);
    at n < 2 the ddof=1 variance is undefined — NaN, matching
    summarize_scores, not 0)."""
    n = m.n
    mean = m.s_sum / n
    var = jnp.maximum(0.0, (m.s_sumsq - n * mean * mean) / jnp.maximum(1.0, n - 1))
    var = jnp.where(n > 1, var, jnp.nan)
    return ScoreSummary(
        n=n, mean_pts=mean, sd_pts=jnp.sqrt(var),
        win_rate=m.wins / n, tie_rate=m.ties / n,
        pts_hist=m.pts_hist, margin_hist=m.margin_hist, total_hist=m.total_hist,
    )


def cover_probs(score: jnp.ndarray, spread: float) -> Dict[str, jnp.ndarray]:
    """Spread from team 0's perspective; cover iff margin > -spread, push at
    equality (edge_finder.py:308-313)."""
    margin = (score[:, 0] - score[:, 1]).astype(jnp.float32)
    tgt = -float(spread)
    return {
        "p_cover": (margin > tgt).mean(),
        "p_notcover": (margin < tgt).mean(),
        "push": (margin == tgt).mean(),
        "mean_margin": margin.mean(),
    }


def total_probs(score: jnp.ndarray, total: float) -> Dict[str, jnp.ndarray]:
    tot = (score[:, 0] + score[:, 1]).astype(jnp.float32)
    t = float(total)
    return {
        "p_over": (tot > t).mean(),
        "p_under": (tot < t).mean(),
        "push": (tot == t).mean(),
        "mean_total": tot.mean(),
    }


def player_stat_probs(pstats: jnp.ndarray, team: int, role: int, slot: int,
                      col: int, line: float) -> Dict[str, jnp.ndarray]:
    """P(over/under/push) of one player stat vs a prop line
    (edge_finder.py:206-208 semantics)."""
    vals = pstats[:, team, role, slot, col]
    return {
        "p_over": (vals > line).mean(),
        "p_under": (vals < line).mean(),
        "push": (jnp.abs(vals - line) <= 1e-9).mean(),
        "mean": vals.mean(),
    }
