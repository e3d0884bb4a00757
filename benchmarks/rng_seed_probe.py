"""Engine-to-engine RNG-implementation check: threefry vs rbg win%.

The high-power oracle runs showed engine win% 0.6018 (threefry, seed 7)
vs 0.5981 (rbg, seed 7) at n=262144 — a 0.37pp gap, z~2.7 if both were
unbiased estimates of the same number.  This probe runs BOTH RNG
implementations at several seeds (nano tables, same program otherwise)
to decide seed-noise vs systematic stream effect.

Usage: python benchmarks/rng_seed_probe.py [n_pairs] [seeds...]
"""
import dataclasses
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax

from fast_monte_carlo.utils.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import numpy as np

from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads

n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 131072
seeds = [int(s) for s in sys.argv[2:]] or [7, 8, 9, 10]

sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")

wins = {}
for impl in ("threefry", "rbg"):
    cfg = SimConfig()
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, rng_impl=impl))
    r = MatchupRunner(A, B, heads, cfg, mode="table", table_quality="nano")
    ws = []
    for s in seeds:
        t0 = time.perf_counter()
        out = r.run_pairs(n_pairs, seed=s, collect_players=False,
                          collect_stats=False)
        sc = np.asarray(out.score, dtype=float)
        w = float((sc[:, 0] > sc[:, 1]).mean())
        ws.append(w)
        print(f"{impl:8s} seed {s:3d}: win% {w:.4f} "
              f"({time.perf_counter()-t0:.0f}s)", flush=True)
    wins[impl] = np.asarray(ws)

se1 = 0.49 / np.sqrt(2 * n_pairs)          # per-run binomial SE
for impl, ws in wins.items():
    print(f"{impl:8s}: mean {ws.mean():.4f}  sd-across-seeds {ws.std(ddof=1):.4f} "
          f"(per-run SE {se1:.4f})")
d = wins["threefry"].mean() - wins["rbg"].mean()
se = se1 * np.sqrt(1 / len(seeds) + 1 / len(seeds))
print(f"threefry - rbg: {d*100:+.3f}pp  z = {d/se:+.2f}")
