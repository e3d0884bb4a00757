"""Widen the cachewarm@250 warm-seed ensemble from 47 to 63 seeds.

Continuation of the rounds-3/4/5 preregistration rule: the 16 new seeds
are the consecutive integers 47..62, chosen before running (none
collide with the existing 47 keys).  524,288 games per seed.  At n=63
the seed-ensemble SE reaches ~0.11pp against the 319k referee's 0.09pp
— the two uncertainty sources finally comparable.
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

# the 47 recorded round-3/4/5 measurements (cachewarm_ensemble_*.log)
R5 = {123: 0.61741, 7: 0.60185, 42: 0.61903, 1001: 0.60879,
      2: 0.62482, 3: 0.60274, 4: 0.61417, 5: 0.59972, 6: 0.60098,
      8: 0.60343, 9: 0.60817, 10: 0.61147, 11: 0.61344, 12: 0.61919,
      13: 0.61267, 14: 0.61048,
      15: 0.61664, 16: 0.62737, 17: 0.60227, 18: 0.59619, 19: 0.61625,
      20: 0.61031, 21: 0.61907, 22: 0.62156, 23: 0.59884, 24: 0.59910,
      25: 0.62140, 26: 0.62437, 27: 0.60252, 28: 0.60230, 29: 0.60077,
      30: 0.60938}

# round-5 seeds 31..46 from cachewarm_ensemble_48.log
import re
from pathlib import Path
log48 = (Path(__file__).resolve().parent / 'cachewarm_ensemble_48.log').read_text()
for m in re.finditer(r"seed=(\d+): win_A=(0\.\d+)", log48):
    R5[int(m.group(1))] = float(m.group(2))
assert len(R5) == 47, len(R5)

sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")
cfg0 = SimConfig()
wins = dict(R5)
for ws in range(47, 63):
    assert ws not in wins
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
print(f"vs cold referee of record 0.6065 +/- 0.0009 (n=319,488): "
      f"delta {w.mean()-0.6065:+.5f}")
