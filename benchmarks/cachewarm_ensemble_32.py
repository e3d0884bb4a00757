"""Widen the cachewarm@250 warm-seed ensemble from 16 to 32 seeds.

The engine-side seed-ensemble SE (0.19pp at n=16) dominates the
north-star comparison error (VERDICT r3 / VALIDATION.md) — more referee
games can't tighten it, more warm seeds can.  The 16 new seeds are the
consecutive integers 15..30 — chosen before running, no selection
(same preregistration rule as the round-3 extension to 16).
524,288 games per seed (SE 0.07pp) as before.
"""
import sys, time, dataclasses
sys.path.insert(0, str(__import__('pathlib').Path(__file__).resolve().parents[1]))
import jax
from fast_monte_carlo.utils.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()
import numpy as np
from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads

# the 16 round-3 measurements (cachewarm_ensemble_16.log), reused verbatim
R3 = {123: 0.61741, 7: 0.60185, 42: 0.61903, 1001: 0.60879,
      2: 0.62482, 3: 0.60274, 4: 0.61417, 5: 0.59972, 6: 0.60098,
      8: 0.60343, 9: 0.60817, 10: 0.61147, 11: 0.61344, 12: 0.61919,
      13: 0.61267, 14: 0.61048}

sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")
cfg0 = SimConfig()
wins = dict(R3)
for ws in range(15, 31):
    cfg = cfg0.replace(engine=dataclasses.replace(
        cfg0.engine, sd_mode="cachewarm", cachewarm_games=250,
        cachewarm_seed=ws))
    t0 = time.perf_counter()
    r = MatchupRunner(A, B, heads, cfg, mode="table", table_quality="nano")
    s = r.run_pairs_summary(262144, seed=21, chunk_pairs=32768)
    win = float(np.asarray(s.win_rate, float)[0])
    wins[ws] = win
    print(f"cachewarm@250 seed={ws}: win_A={win:.5f} "
          f"({time.perf_counter()-t0:.0f}s)", flush=True)
w = np.asarray(list(wins.values()))
print(f"\nensemble n={len(w)}: mean {w.mean():.5f}  sd {w.std(ddof=1):.5f}  "
      f"SE {w.std(ddof=1)/np.sqrt(len(w)):.5f}")
print(f"vs cold referee of record 0.6061 +/- 0.0010 (n=262,144): "
      f"delta {w.mean()-0.6061:+.5f}")
