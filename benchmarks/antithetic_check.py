"""Antithetic variates: measured variance reduction on market estimators.

Runs M independently-seeded batches of 2*n_pairs games with and without
EngineConfig.antithetic and compares the across-batch variance of the
batch-level estimators the edge finder actually consumes (win prob, mean
margin, spread-cover prob, total-over prob).  The variance ratio
var(plain)/var(antithetic) is the effective-sample-size multiplier: ratio
R means a plain run needs R times the games for the same standard error.

Also reports the within-pair margin correlation (pairs are rows 4k,4k+1 vs
4k+2,4k+3 — ops/game.py play_step), which drives the reduction:
var(pair mean) = sigma^2 (1+rho)/2.

Usage: python benchmarks/antithetic_check.py [analytic|table] [n_pairs] [M]
"""
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import jax

MODE = sys.argv[1] if len(sys.argv) > 1 else "analytic"
N_PAIRS = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
M = int(sys.argv[3]) if len(sys.argv) > 3 else 100

if MODE == "analytic":
    jax.config.update("jax_platforms", "cpu")
else:
    from fast_monte_carlo.utils.compile_cache import enable_compile_cache  # noqa: E402
    enable_compile_cache()

import numpy as np

from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads

sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference") if MODE != "analytic" else None

SPREAD, TOTAL = -3.0, 69.5


def estimators(score):
    margin = score[:, 0] - score[:, 1]
    total = score[:, 0] + score[:, 1]
    return np.array([
        (margin > 0).mean(),            # win prob (team A)
        margin.mean(),                  # mean margin
        (margin > -SPREAD).mean(),      # A covers -3
        (total > TOTAL).mean(),         # over 69.5
    ])


def pair_rho(margin):
    m = margin.reshape(-1, 4).astype(np.float64)
    a = np.concatenate([m[:, 0], m[:, 1]])
    b = np.concatenate([m[:, 2], m[:, 3]])
    return float(np.corrcoef(a, b)[0, 1])


results = {}
for anti in (False, True):
    cfg = SimConfig()
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=anti))
    runner = MatchupRunner(A, B, heads, cfg, mode=MODE)
    ests, rhos = [], []
    t0 = time.perf_counter()
    for s in range(M):
        out = runner.run_pairs(N_PAIRS, seed=1000 + s, collect_players=False,
                               collect_stats=False)
        sc = np.asarray(out.score)
        ests.append(estimators(sc))
        rhos.append(pair_rho(sc[:, 0] - sc[:, 1]))
    dt = time.perf_counter() - t0
    ests = np.stack(ests)
    results[anti] = ests
    print(f"antithetic={anti}: {M} batches x {2*N_PAIRS} games in {dt:.1f}s; "
          f"mean ests {ests.mean(axis=0).round(4).tolist()}; "
          f"within-pair margin rho {np.mean(rhos):+.4f}", flush=True)

names = ["win_prob", "mean_margin", f"cover_{SPREAD}", f"over_{TOTAL}"]
v0 = results[False].var(axis=0, ddof=1)
v1 = results[True].var(axis=0, ddof=1)
print("\nestimator        var(plain)    var(anti)   ESS multiplier")
for i, nm in enumerate(names):
    print(f"{nm:15s} {v0[i]:.3e}  {v1[i]:.3e}   {v0[i]/v1[i]:6.2f}x")
# unbiasedness: means must agree within cross-batch SE
d = results[False].mean(axis=0) - results[True].mean(axis=0)
se = np.sqrt(v0 / M + v1 / M)
print("mean deltas (z):", [f"{d[i]/se[i]:+.2f}" for i in range(len(names))])
