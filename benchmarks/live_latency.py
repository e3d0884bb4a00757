"""Warm live-query latency: table/nano mode, 65,536 games per answer.

Times a first call (compile + table build), then rotates through 4
distinct situations so nothing is answer-cached, and prints each answer's
latency and win probability.  Win probabilities must be monotone in game
state (up-4-with-ball mid-Q3 > tied-Q2 > down-3-defense late-Q4).
Not yet run on the GPU."""
import sys, time
sys.path.insert(0, str(__import__('pathlib').Path(__file__).resolve().parents[1]))

import jax
from fast_monte_carlo.utils.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

from fast_monte_carlo.api import simulate_live_game
from fast_monte_carlo.ops.game import Situation

SP = "/root/reference/PregameSPPlus2025_1.csv"

sits = [
    Situation(0, 1312, 2, 7.0, 35.0, 21, 17),
    Situation(1, 420, 3, 4.0, 60.0, 17, 20),
    Situation(0, 2400, 1, 10.0, 75.0, 7, 7),
    Situation(1, 95, 4, 2.0, 40.0, 24, 27),
]

t0 = time.perf_counter()
row, s = simulate_live_game("Kansas State", "Iowa State", sits[0],
                            sp_path=SP, n_games=65536)
print(f"first call (compile + tables): {time.perf_counter()-t0:.1f}s "
      f"win_a={row['win_a']:.4f}")

# warm: rotate through distinct situations so no result caching can hide
lat = []
for i in range(12):
    sit = sits[i % len(sits)]
    t0 = time.perf_counter()
    row, s = simulate_live_game("Kansas State", "Iowa State", sit,
                                sp_path=SP, n_games=65536, seed=i)
    lat.append(time.perf_counter() - t0)
lat_s = sorted(lat)
print(f"warm /live 65,536 games: median {lat_s[len(lat)//2]*1e3:.0f}ms "
      f"min {lat_s[0]*1e3:.0f}ms max {lat_s[-1]*1e3:.0f}ms")
print("win_a by sit:", [f"{simulate_live_game('Kansas State','Iowa State', s2, sp_path=SP, n_games=16384)[0]['win_a']:.3f}" for s2 in sits])
