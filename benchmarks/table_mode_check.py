"""Table-mode vs exact-mode distributional check + throughput (any backend).

Usage: python benchmarks/table_mode_check.py [cpu|gpu] [n]
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

backend = sys.argv[1] if len(sys.argv) > 1 else "cpu"
if backend == "cpu":
    import os
    os.environ["JAX_PLATFORMS"] = "cpu"
import jax

if backend == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.ops.game import make_exact_heads_eval, simulate_games
from fast_monte_carlo.ops.pack import build_packs
from fast_monte_carlo.ops.table_lookup import build_table_heads, make_table_heads_eval
from fast_monte_carlo.stats import TS

print("devices:", jax.devices(), flush=True)
n = int(sys.argv[2]) if len(sys.argv) > 2 else 4096

cfg = SimConfig()
sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B_ = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")
pack, hp = build_packs(A, B_, heads, cfg)

t0 = time.perf_counter()
th = build_table_heads(A, B_, heads, cfg)
print(f"table build: {time.perf_counter()-t0:.1f}s", flush=True)

te = make_table_heads_eval(cfg)
fo = jnp.asarray(np.arange(n) % 2, jnp.int32)
f = jax.jit(lambda ths, key: simulate_games(pack, cfg, te, ths, key, n, fo, collect_players=False))
t0 = time.perf_counter()
out = f(th, jax.random.PRNGKey(0))
jax.block_until_ready(out.score)
t1 = time.perf_counter()
out = f(th, jax.random.PRNGKey(1))
jax.block_until_ready(out.score)
t2 = time.perf_counter()
print(f"table mode: compile+run {t1-t0:.1f}s steady {t2-t1:.3f}s -> {n/(t2-t1):,.0f} games/s", flush=True)
sc = np.asarray(out.score)
print("mean score:", sc.mean(axis=0).round(2), "winA:", round(float((sc[:, 0] > sc[:, 1]).mean()), 4))
st = np.asarray(out.stats).mean(axis=0)
for k in ["plays", "pass_att", "comp", "pass_yds", "pass_td", "rush_att", "rush_yds",
          "rush_td", "punts", "FG", "FGA", "INT", "sacks", "rz_trips", "rz_TD"]:
    print(f"  {k:11s} {st[0, TS[k]]:7.1f} {st[1, TS[k]]:7.1f}")
