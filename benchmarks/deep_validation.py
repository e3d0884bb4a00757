"""Large-sample distributional validation: oracle vs table-mode engine.

Runs the CPU oracle (reference-faithful scalar sim) for n_oracle games and
the table-mode engine for n_engine games, then compares:
  - win probability (z-test)
  - margin & total distributions (two-sample KS)
  - box-score means
Writes a markdown block suitable for VALIDATION.md.
"""
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

platform = sys.argv[5] if len(sys.argv) > 5 else "cpu"
if platform == "cpu":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

if platform == "cpu":
    jax.config.update("jax_platforms", "cpu")
else:
    # engine on the real chip (the oracle side is pure numpy either way);
    # rbg streams are backend-specific, so validating the bench default
    # (--rng rbg) belongs on the GPU
    from fast_monte_carlo.utils.compile_cache import enable_compile_cache  # noqa: E402
    enable_compile_cache()

import jax.numpy as jnp
import numpy as np
from scipy import stats as sps

from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.oracle import OracleMatchup
from fast_monte_carlo.stats import TS

n_oracle = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
n_engine_pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 32768
quality = sys.argv[3] if len(sys.argv) > 3 else "default"
rng_impl = sys.argv[4] if len(sys.argv) > 4 else "threefry"

cfg = SimConfig()
if rng_impl != "threefry":
    import dataclasses

    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                 rng_impl=rng_impl))
sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")

_cache = REPO / "benchmarks" / f"oracle_margins_{n_oracle}.npz"
if _cache.exists():
    # cached default-SimConfig oracle scores (seed 123, same stream as
    # below — produced by cover_ladder.py / this script); the oracle does
    # not depend on quality or rng_impl, so any engine variant can reuse it
    o_sc = np.load(_cache)["score"].astype(float)
    print(f"oracle: loaded {len(o_sc)} cached games from {_cache.name}",
          flush=True)
else:
    t0 = time.perf_counter()
    m = OracleMatchup(A, B, heads, cfg)
    rng = np.random.default_rng(123)
    o_res = [m.simulate_game(i % 2, rng) for i in range(n_oracle)]
    o_sc = np.asarray([r["score"] for r in o_res], dtype=float)
    np.savez_compressed(_cache, margin=o_sc[:, 0] - o_sc[:, 1], score=o_sc)
    print(f"oracle: {n_oracle} games in {time.perf_counter()-t0:.0f}s",
          flush=True)

t0 = time.perf_counter()
r = MatchupRunner(A, B, heads, cfg, mode="table", table_quality=quality)
out = r.run_pairs(n_engine_pairs, seed=7, collect_players=False)
e_sc = np.asarray(out.score, dtype=float)
print(f"engine({quality}, {rng_impl}): {2*n_engine_pairs} games in "
      f"{time.perf_counter()-t0:.0f}s", flush=True)

o_win = (o_sc[:, 0] > o_sc[:, 1]).mean()
e_win = (e_sc[:, 0] > e_sc[:, 1]).mean()
se = np.sqrt(o_win * (1 - o_win) / len(o_sc) + e_win * (1 - e_win) / len(e_sc))
z = (o_win - e_win) / se

o_margin = o_sc[:, 0] - o_sc[:, 1]
e_margin = e_sc[:, 0] - e_sc[:, 1]
o_total = o_sc.sum(axis=1)
e_total = e_sc.sum(axis=1)
ks_m = sps.ks_2samp(o_margin, e_margin)
ks_t = sps.ks_2samp(o_total, e_total)

print(f"\n| quantity | oracle (n={len(o_sc)}) | table engine (n={len(e_sc)}) | test |")
print("|---|---|---|---|")
print(f"| win% A | {o_win:.4f} | {e_win:.4f} | z = {z:+.2f} (delta "
      f"{abs(o_win-e_win)*100:.2f}%) |")
print(f"| mean margin | {o_margin.mean():+.2f} | {e_margin.mean():+.2f} | "
      f"KS D={ks_m.statistic:.4f}, p={ks_m.pvalue:.3f} |")
print(f"| mean total | {o_total.mean():.2f} | {e_total.mean():.2f} | "
      f"KS D={ks_t.statistic:.4f}, p={ks_t.pvalue:.3f} |")
print(f"| sd margin / total | {o_margin.std():.1f} / {o_total.std():.1f} | "
      f"{e_margin.std():.1f} / {e_total.std():.1f} | |")
verdict = "PASS" if (abs(o_win - e_win) < max(0.005, 3.5 * se)
                     and ks_m.pvalue > 0.001 and ks_t.pvalue > 0.001) else "FAIL"
print(f"\nverdict: {verdict} (win-prob tolerance max(0.5%, 3.5*SE)={max(0.005, 3.5*se)*100:.2f}%)")
