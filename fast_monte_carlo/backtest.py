"""Backtest / calibration harness: score the simulator against ACTUAL
game results.

The reference validates by eyeball — box-score diagnostics printed for a
human (fast_monte_carlo_cfb.py:1525-1567) and a summary win-rate table
(:1681-1687); there is no tooling that asks "were the probabilities
right?" against outcomes.  This module is that tooling:

* win-probability calibration — Brier score, log loss, expected
  calibration error, and a reliability table over probability bins;
* margin/total point accuracy — bias, MAE, RMSE, correlation;
* full-distribution calibration — PIT (probability integral transform)
  values of each actual margin/total under the simulated histogram
  (mid-p convention for the discrete support), with a KS distance from
  uniform: the sharpest test that the simulator's whole distribution,
  not just its mean, is honest.

Inputs are deliberately frame-shaped: `predictions` is exactly the slate
summary DataFrame the production sweep returns (api.simulate_slate_
summaries / SlateRunner.run_summaries), `results` is a tiny csv of
finals (team_a, team_b, score_a, score_b) in either orientation.
`backtest_slate` runs the sims and the report in one call; `cli
backtest` is the command-line front.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from .edge import _norm_team


# ---------------------------------------------------------------------------
# joining predictions with results (orientation-aware)
# ---------------------------------------------------------------------------

def join_results(predictions: pd.DataFrame,
                 results: pd.DataFrame) -> pd.DataFrame:
    """Align a predictions frame (slate-summary columns) with a results
    frame (team_a, team_b, score_a, score_b) on normalized team names,
    accepting either orientation per row.  Returns one row per matched
    game with the prediction's orientation: actual_a/actual_b scores,
    actual_margin_a, actual_total, won_a (ties count for neither side,
    matching the engine's strict win_rate).

    Rematches (the same two teams appearing more than once in `results`
    — regular-season meeting plus a championship rematch) are consumed in
    order: the k-th prediction row for a pair scores against the k-th
    results row for that pair.  The output carries `_pred_index` (the
    row's position in `predictions`) so callers can align per-row
    side-data (calibration_report uses it for the summaries)."""
    res_ix: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
    for r in results.itertuples(index=False):
        a, b = _norm_team(r.team_a), _norm_team(r.team_b)
        # store under the SORTED pair; orientation restored at match time
        key = (a, b) if a <= b else (b, a)
        sa, sb = float(r.score_a), float(r.score_b)
        res_ix.setdefault(key, []).append(
            (sa, sb) if key == (a, b) else (sb, sa))
    rows = []
    for i, p in enumerate(predictions.itertuples(index=False)):
        a, b = _norm_team(p.team_a), _norm_team(p.team_b)
        key = (a, b) if a <= b else (b, a)
        queue = res_ix.get(key)
        if not queue:
            continue
        sa, sb = queue.pop(0)            # FIFO per pair: k-th meets k-th
        if key != (a, b):
            sa, sb = sb, sa              # back to the prediction's order
        rows.append({**p._asdict(), "_pred_index": i,
                     "actual_a": sa, "actual_b": sb,
                     "actual_margin_a": sa - sb, "actual_total": sa + sb,
                     "won_a": float(sa > sb)})
    return pd.DataFrame(rows)


# ---------------------------------------------------------------------------
# metric blocks
# ---------------------------------------------------------------------------

def win_calibration(p_win: Sequence[float], won: Sequence[float],
                    bins: int = 10) -> Dict:
    """Probability-quality metrics for binary outcomes: Brier score, log
    loss, expected calibration error, and a reliability table (per-bin
    mean prediction vs observed frequency).  Lower Brier/logloss/ECE is
    better; a calibrated simulator's reliability rows sit on the
    diagonal."""
    p = np.clip(np.asarray(p_win, float), 1e-12, 1 - 1e-12)
    y = np.asarray(won, float)
    if p.shape != y.shape or p.ndim != 1:
        raise ValueError(f"p_win and won must be equal-length 1-d, got "
                         f"{p.shape} vs {y.shape}")
    brier = float(np.mean((p - y) ** 2))
    logloss = float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    edges = np.linspace(0.0, 1.0, bins + 1)
    which = np.clip(np.digitize(p, edges[1:-1]), 0, bins - 1)
    table = []
    ece = 0.0
    for b in range(bins):
        m = which == b
        if not m.any():
            continue
        mp, fw = float(p[m].mean()), float(y[m].mean())
        table.append({"bin_lo": float(edges[b]), "bin_hi": float(edges[b + 1]),
                      "n": int(m.sum()), "mean_pred": round(mp, 4),
                      "frac_won": round(fw, 4), "gap": round(fw - mp, 4)})
        ece += m.mean() * abs(fw - mp)
    return {"n": int(p.size), "brier": round(brier, 5),
            "brier_skill": round(1.0 - brier / 0.25, 4),
            "logloss": round(logloss, 5), "ece": round(float(ece), 5),
            "reliability": table}


def point_metrics(pred: Sequence[float], actual: Sequence[float]) -> Dict:
    """Location accuracy of a point forecast (projected margin or total
    vs the actual number)."""
    p, a = np.asarray(pred, float), np.asarray(actual, float)
    err = p - a
    out = {"n": int(p.size), "bias": round(float(err.mean()), 3),
           "mae": round(float(np.abs(err).mean()), 3),
           "rmse": round(float(np.sqrt((err ** 2).mean())), 3)}
    if p.size >= 2 and p.std() > 0 and a.std() > 0:
        out["corr"] = round(float(np.corrcoef(p, a)[0, 1]), 4)
    return out


def pit_values(hists: Sequence[np.ndarray], support0: float,
               actuals: Sequence[float]) -> np.ndarray:
    """Mid-p PIT of each actual value under its simulated histogram:
    PIT = P(X < actual) + 0.5 * P(X == actual), with every histogram's
    integer support starting at `support0`.  If the simulated
    distributions are the truth, PIT is uniform on (0,1) — deviations
    localize HOW the sim is wrong (U-shape: too narrow; hump: too wide;
    tilt: biased)."""
    out = np.empty(len(actuals))
    for i, (h, a) in enumerate(zip(hists, actuals)):
        h = np.asarray(h, float)
        n = h.sum()
        k = int(round(float(a) - support0))
        below = h[:max(k, 0)].sum()
        at = h[k] if 0 <= k < len(h) else 0.0
        out[i] = (below + 0.5 * at) / n
    return out


def ks_uniform(pit: np.ndarray) -> float:
    """One-sample KS distance of PIT values from Uniform(0,1)."""
    x = np.sort(np.asarray(pit, float))
    n = x.size
    grid = np.arange(1, n + 1) / n
    return float(np.maximum(grid - x, x - (grid - 1 / n)).max())


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def calibration_report(predictions: pd.DataFrame, results: pd.DataFrame,
                       summaries: Optional[List] = None,
                       bins: int = 10) -> Dict:
    """Full backtest report off a slate prediction frame and a results
    frame.  `summaries` (the per-matchup ScoreSummary objects from
    return_summaries=True, in `predictions` row order) unlocks the
    distribution-level PIT/KS block; without them the report covers win
    calibration and point accuracy only."""
    from .parallel.aggregate import MARGIN_OFF

    joined = join_results(predictions, results)
    if joined.empty:
        raise ValueError("no prediction rows matched the results frame "
                         "(team names are matched normalized, either "
                         "orientation)")
    # ties carry no strict winner — exclude them from the binary block,
    # exactly as win_rate excludes them from the probability
    dec = joined[joined["actual_margin_a"] != 0]
    rep: Dict = {
        "games": int(len(joined)),
        "win": win_calibration(dec["win_a"], dec["won_a"], bins=bins),
        "margin": point_metrics(joined["mean_margin_a"],
                                joined["actual_margin_a"]),
        "total": point_metrics(joined["mean_total"],
                               joined["actual_total"]),
        "rows": joined,
    }
    if summaries is not None:
        if len(summaries) != len(predictions):
            raise ValueError("summaries must align 1:1 with predictions")
        # align by prediction ROW (join_results' _pred_index), so
        # duplicate matchups (rematches) keep their own distributions
        sums = [summaries[i] for i in joined["_pred_index"]]
        mh = [np.asarray(s.margin_hist, float) for s in sums]
        th = [np.asarray(s.total_hist, float) for s in sums]
        pit_m = pit_values(mh, -MARGIN_OFF, joined["actual_margin_a"])
        pit_t = pit_values(th, 0.0, joined["actual_total"])
        joined["pit_margin"], joined["pit_total"] = pit_m, pit_t
        rep["pit"] = {
            "margin_ks": round(ks_uniform(pit_m), 4),
            "total_ks": round(ks_uniform(pit_t), 4),
            "margin_mean": round(float(pit_m.mean()), 4),
            "total_mean": round(float(pit_t.mean()), 4),
            # KS 95% critical distance for n samples (asymptotic)
            "ks_crit_95": round(1.36 / np.sqrt(len(joined)), 4),
        }
    return rep


def fit_calibration(rep: Dict):
    """Affine market calibration fitted from a backtest report (round 5,
    VERDICT r4 #8): shifts = the negated margin/total point biases.
    SHIFT-ONLY by design — dispersion (scale) estimates from <~100 games
    are noise, and the PIT/KS block (the dispersion instrument) flags
    location, not width, on the 2025 data.  Returns
    (edge.MarketCalibration, {shift SEs}) for the opt-in
    `market_odds_from_summary(..., calibration=...)` path; the SEs let
    the caller judge whether a shift is significant before applying."""
    from .edge import MarketCalibration

    joined = rep["rows"]
    m_err = np.asarray(joined["mean_margin_a"] - joined["actual_margin_a"],
                       float)
    t_err = np.asarray(joined["mean_total"] - joined["actual_total"], float)
    c = MarketCalibration(margin_shift=round(-float(m_err.mean()), 3),
                          total_shift=round(-float(t_err.mean()), 3))
    ses = {"margin_shift_se": round(float(m_err.std(ddof=1)
                                          / np.sqrt(len(m_err))), 3),
           "total_shift_se": round(float(t_err.std(ddof=1)
                                         / np.sqrt(len(t_err))), 3)}
    return c, ses


def backtest_slate(
    games: List[Tuple[str, str]],
    results: pd.DataFrame,
    *,
    sp_path: str,
    year: int = 2025,
    week: int = 1,
    n_pairs: int = 32768,
    artifact_dir: str = "seeded:0",
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg=None,
    seed: int = 0,
    shard: bool = False,
    bins: int = 10,
) -> Dict:
    """Simulate `games` through the production slate sweep and score the
    predictions against `results` — the one-call backtest.  Use the SP+
    file AS OF the games' week (the engine consumes pregame ratings;
    feeding it postgame ratings would leak the outcomes being scored)."""
    from .api import simulate_slate_summaries

    df, summaries = simulate_slate_summaries(
        games, sp_path=sp_path, year=year, week=week, n_pairs=n_pairs,
        artifact_dir=artifact_dir, focus_csv=focus_csv, mode=mode,
        table_quality=table_quality, cfg=cfg, seed=seed, shard=shard,
        return_summaries=True)
    return calibration_report(df, results, summaries=summaries, bins=bins)


def print_backtest_readable(rep: Dict) -> None:
    w = rep["win"]
    print(f"\n=== Backtest: {rep['games']} games "
          f"({w['n']} with a winner) ===")
    print(f"  win prob : brier {w['brier']:.4f}  "
          f"(skill vs coin {w['brier_skill']:+.3f})  "
          f"logloss {w['logloss']:.4f}  ECE {w['ece']:.4f}")
    for row in w["reliability"]:
        print(f"    [{row['bin_lo']:.1f},{row['bin_hi']:.1f})  n={row['n']:<4d}"
              f" pred {row['mean_pred']:.3f}  won {row['frac_won']:.3f}"
              f"  gap {row['gap']:+.3f}")
    m, t = rep["margin"], rep["total"]
    print(f"  margin   : bias {m['bias']:+.2f}  mae {m['mae']:.2f}  "
          f"rmse {m['rmse']:.2f}" + (f"  corr {m['corr']:.3f}"
                                     if "corr" in m else ""))
    print(f"  total    : bias {t['bias']:+.2f}  mae {t['mae']:.2f}  "
          f"rmse {t['rmse']:.2f}" + (f"  corr {t['corr']:.3f}"
                                     if "corr" in t else ""))
    if "pit" in rep:
        p = rep["pit"]
        print(f"  PIT (KS vs uniform, crit@95% {p['ks_crit_95']:.3f}): "
              f"margin {p['margin_ks']:.3f} (mean {p['margin_mean']:.3f})  "
              f"total {p['total_ks']:.3f} (mean {p['total_mean']:.3f})")
