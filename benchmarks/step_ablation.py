"""Ablate the play step on the device to see where time goes.

Variants (all B games, early-exit on, transfer-verified):
  full-fused     the production fused-table path
  analytic       same step, no table gathers (closed-form heads)
  turbo          small VMEM-sized fused table
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import jax
import numpy as np

from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads

n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 131072
cfg = SimConfig()
sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")

for label, mode, quality in (
    ("analytic", "analytic", "default"),
    ("fused", "table", "fused"),
    ("turbo", "table", "turbo"),
):
    r = MatchupRunner(A, B, heads if mode != "analytic" else None, cfg,
                      mode=mode, table_quality=quality)
    out = r.run_pairs(n_pairs, seed=0, collect_players=False)
    _ = np.asarray(out.score[:4])
    best = 1e9
    for t in range(2):
        t0 = time.perf_counter()
        out = r.run_pairs(n_pairs, seed=t + 1, collect_players=False)
        _ = np.asarray(out.score[:4])
        best = min(best, time.perf_counter() - t0)
    n = 2 * n_pairs
    print(f"{label:10s} {best:6.3f}s  {n/best:>10,.0f} games/s", flush=True)
