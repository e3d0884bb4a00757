"""BASELINE config #4: spread/total edge scan at large n, on device.

Simulates n games (fused tables) and then times the on-device market
reductions (win/cover/total + histograms) that replace the reference's
pandas-over-CSV edge scan (edge_finder.py:283-336)."""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import jax
import numpy as np

from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.edge import market_odds_from_summary
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.parallel import cover_probs, summarize_scores, total_probs

n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 262144

cfg = SimConfig()
sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")
r = MatchupRunner(A, B, heads, cfg, mode="table", table_quality="fused")

t0 = time.perf_counter()
out = r.run_pairs(n_pairs, seed=0, collect_players=False)
_ = np.asarray(out.score[:8])
t_sim = time.perf_counter() - t0
n = 2 * n_pairs
print(f"simulate {n:,} games: {t_sim:.2f}s ({n/t_sim:,.0f}/s)", flush=True)

summ = jax.jit(summarize_scores)(out.score)
cov = jax.jit(lambda s: cover_probs(s, -3.0))(out.score)
tot = jax.jit(lambda s: total_probs(s, 50.5))(out.score)
jax.block_until_ready(summ.margin_hist)

t0 = time.perf_counter()
summ = jax.jit(summarize_scores)(out.score)
cov = jax.jit(lambda s: cover_probs(s, -3.0))(out.score)
tot = jax.jit(lambda s: total_probs(s, 50.5))(out.score)
res = market_odds_from_summary(summ, A.name, B.name, spread=-3.0, total=50.5)
t_edge = time.perf_counter() - t0
print(f"edge scan (device reductions + market odds): {t_edge*1e3:.1f} ms", flush=True)
print(f"win A: {float(summ.win_rate[0]):.4f}  "
      f"P(cover -3): {float(cov['p_cover']):.4f}  "
      f"P(over 50.5): {float(tot['p_over']):.4f}")
print("fair lines:", {k: {kk: res[k][kk] for kk in ('american_cover', 'american_notcover')
                          if kk in res[k]} for k in res})
