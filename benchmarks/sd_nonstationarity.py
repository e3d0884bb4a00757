"""Where the reference's margin sd 18.8 comes from (VALIDATION.md).

Two measurements:
1. margin sd per 1000-game block of the cached n=8000 referee oracle run —
   the as-executed reference is NON-STATIONARY (its memo caches keep
   filling; first-visit plays are computed live at that game's sd), so sd
   decays from ~'axis' (cold cache) toward the frozen limit.
2. engine margin sd across sd modes at n=8192, including the
   trajectory-coherent 'cachewarm' freeze (first-visit sds from a recorded
   oracle warm-up) — measured ~= iid 'frozen', i.e. freeze coherence does
   not widen dispersion; the live/frozen MIXTURE does.

Usage: python benchmarks/sd_nonstationarity.py [n_pairs]
"""
import dataclasses
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads

n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 4096

# largest cached WARM referee sample (strict supersets of one seed-123
# stream; benchmarks/oracle_extend.py) — more blocks = a longer decay
# curve.  Excludes the cold-protocol caches (oracle_margins_cold_*.npz:
# seed 456, caches reset every 250 games — a stationary stream that would
# silently flatten this decay analysis).
WARM_SEAM = 12000  # the warm stream was once resumed without cache
# restore at game 12000 (pre-fix oracle_extend.py checkpoints carried no
# caches), so games >= 12000 are a SECOND cache trajectory; the one-cache
# decay analysis must stop there
# digits-only glob: also excludes other protocol streams (nomemo, mlpolicy)
# that would flatten/shift the decay curve just like the cold caches would
npz = max((REPO / "benchmarks").glob("oracle_margins_[0-9]*.npz"),
          default=None, key=lambda p: int(p.stem.rsplit("_", 1)[1]))
if npz is not None:
    sc = np.load(npz)["score"].astype(float)[:WARM_SEAM]
    m = sc[:, 0] - sc[:, 1]
    print(f"referee oracle run (n={len(m)}, one cache): overall margin sd "
          f"{m.std(ddof=1):.2f}")
    for lo in range(0, len(m), 1000):
        b = m[lo:lo + 1000]
        print(f"  games {lo:4d}-{lo+1000:4d}: sd {b.std(ddof=1):5.2f} "
              f"mean {b.mean():+5.2f}")
    print("  (early blocks ~ cold cache ~ 'axis'; late blocks drift toward "
          "the frozen limit)\n")

sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")

for mode, ws in (("axis", 0), ("frozen", 0), ("marginal", 0),
                 ("cachewarm", 123), ("cachewarm", 7)):
    e = dataclasses.replace(SimConfig().engine, sd_mode=mode,
                            cachewarm_games=64, cachewarm_seed=ws or 123)
    cfg = SimConfig().replace(engine=e)
    r = MatchupRunner(A, B, heads, cfg, mode="table", table_quality="nano")
    t0 = time.perf_counter()
    out = r.run_pairs(n_pairs, seed=3, collect_players=False,
                      collect_stats=False)
    s = np.asarray(out.score, float)
    mg = s[:, 0] - s[:, 1]
    tag = f"{mode}" + (f"(warm seed {ws})" if mode == "cachewarm" else "")
    print(f"engine {tag:22s}: n={2*n_pairs} win {float((mg>0).mean()):.4f} "
          f"margin {mg.mean():+.2f} sd {mg.std(ddof=1):.2f} "
          f"({time.perf_counter()-t0:.0f}s)", flush=True)
