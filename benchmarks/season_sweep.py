"""BASELINE config #5: a season-style calibration sweep — many matchups at
large n, producing win-prob/ATS distribution tables.

The snapshot has no schedule file, so the sweep pairs teams by adjacent
SP+ rank (competitive games) plus a few cross-tier games.  Output: one row
per matchup with win%, fair moneylines, mean margin/total, cover prob at
the SP+-implied spread.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np
import pandas as pd

from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.edge import prob_to_american
from fast_monte_carlo.models.heads import load_heads

n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 50000
n_matchups = int(sys.argv[2]) if len(sys.argv) > 2 else 20
quality = sys.argv[3] if len(sys.argv) > 3 else "fused"

cfg = SimConfig()
sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
ranked = sp.sort_values("RATING", ascending=False)["team"].tolist()
games = [(ranked[i], ranked[i + 1]) for i in range(0, 2 * n_matchups, 2)]

heads = load_heads("/root/reference")
rows = []
t_all = time.perf_counter()
total_games = 0
for gi, (ta, tb) in enumerate(games):
    a = build_team_context_from_sp_flex(ta, 2025, 1, sp)
    b = build_team_context_from_sp_flex(tb, 2025, 1, sp)
    r = MatchupRunner(a, b, heads, cfg, mode="table", table_quality=quality)
    out = r.run_pairs(n_pairs, seed=gi, collect_players=False)
    sc = np.asarray(out.score, dtype=float)
    total_games += len(sc)
    margin = sc[:, 0] - sc[:, 1]
    total = sc.sum(axis=1)
    w = float((sc[:, 0] > sc[:, 1]).mean())
    spread = -round(margin.mean() * 2) / 2  # market-style half-point line
    # the simulator responds to offense-vs-defense splits (matchup_bias /
    # yardage tilt use off.OFFENSE - def.DEFENSE), not overall RATING
    net_split = (a.sp_offense - b.sp_defense) - (b.sp_offense - a.sp_defense)
    rows.append({
        "team_a": ta, "team_b": tb,
        "sp_gap": round(a.sp_rating - b.sp_rating, 1),
        "net_split_gap": round(net_split, 1),
        "win_a": round(w, 4), "ml_a": prob_to_american(w),
        "mean_margin": round(float(margin.mean()), 2),
        "mean_total": round(float(total.mean()), 2),
        "spread_line": spread,
        "p_cover_at_line": round(float((margin > -spread).mean()), 4),
        "n": len(sc),
    })
    print(f"[{gi+1}/{len(games)}] {ta} vs {tb}: win {w:.3f} "
          f"margin {margin.mean():+.1f} total {total.mean():.1f}", flush=True)

dt = time.perf_counter() - t_all
df = pd.DataFrame(rows)
df.to_csv("season_sweep.csv", index=False)
print(f"\n{len(games)} matchups, {total_games:,} games in {dt:.0f}s "
      f"({total_games/dt:,.0f} games/s end-to-end)")
# calibration sanity: win prob should track the off-vs-def split gap (the
# quantity the simulator's tilts actually consume)
corr = np.corrcoef(df.net_split_gap, df.win_a)[0, 1]
print(f"corr(net off-def split gap, win prob) = {corr:.3f}")
print(f"corr(overall RATING gap, win prob) = "
      f"{np.corrcoef(df.sp_gap, df.win_a)[0, 1]:.3f}  (weak by design: the "
      f"reference's tilts use offense/defense splits)")
print(f"cover prob at own mean line ~ 50%: "
      f"{df.p_cover_at_line.mean():.3f} ± {df.p_cover_at_line.std():.3f}")
