"""Widen the cachewarm@250 warm-seed ensemble from 4 to 16 seeds.

Original 4 (round-3 study): 123, 7, 42, 1001.  The 12 new seeds are the
integers 2..13 — chosen before running, no selection.  524,288 games per
seed (SE 0.07pp) so the ensemble spread, not sampling, dominates each
point."""
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

sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")
cfg0 = SimConfig()
wins = []
for ws in (123, 7, 42, 1001, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14):
    cfg = cfg0.replace(engine=dataclasses.replace(
        cfg0.engine, sd_mode="cachewarm", cachewarm_games=250,
        cachewarm_seed=ws))
    t0 = time.perf_counter()
    r = MatchupRunner(A, B, heads, cfg, mode="table", table_quality="nano")
    s = r.run_pairs_summary(262144, seed=21, chunk_pairs=32768)
    win = float(np.asarray(s.win_rate, float)[0])
    wins.append(win)
    print(f"cachewarm@250 seed={ws}: win_A={win:.5f} "
          f"({time.perf_counter()-t0:.0f}s)", flush=True)
w = np.asarray(wins)
print(f"\nensemble n={len(w)}: mean {w.mean():.5f}  sd {w.std(ddof=1):.5f}  "
      f"SE {w.std(ddof=1)/np.sqrt(len(w)):.5f}")
print(f"vs cold referee 0.6069 +/- 0.0013 (n=131,072): "
      f"delta {w.mean()-0.6069:+.5f}")
