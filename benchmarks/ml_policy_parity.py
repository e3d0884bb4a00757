"""VERDICT r1 #7: HIGH-POWER parity for the recovered ML play policy.

Round 1 validated the ML play-call path (play_model.xgb recovered without
xgboost) at oracle n=400 only (SE ±2.5%).  This runs oracle n>=8000 vs
engine n>=262k with use_play_model=True and records Δ win-prob with its z
score (target: inside the ±0.5%-at-equal-n north star, i.e. |z| <~ 2 at
these sample sizes).

Oracle scores cached to benchmarks/oracle_mlpolicy_{n}.npz.

Usage: python benchmarks/ml_policy_parity.py [n_oracle] [engine_pairs]
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

n_oracle = int(sys.argv[1]) if len(sys.argv) > 1 else 8000
n_pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 131072

cfg = SimConfig()
cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_play_model=True))
sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")
assert heads.play is not None, "recovered play policy missing"

cache = REPO / "benchmarks" / f"oracle_mlpolicy_{n_oracle}.npz"
if cache.exists():
    o_sc = np.load(cache)["score"]
    print(f"oracle scores: loaded {len(o_sc)} from {cache.name}", flush=True)
else:
    from fast_monte_carlo.oracle import OracleMatchup
    m = OracleMatchup(A, B, heads, cfg)
    rng = np.random.default_rng(321)
    t0 = time.perf_counter()
    o_sc = np.asarray([m.simulate_game(i % 2, rng)["score"]
                       for i in range(n_oracle)], dtype=float)
    np.savez_compressed(cache, score=o_sc)
    print(f"oracle: {n_oracle} games in {time.perf_counter()-t0:.0f}s", flush=True)

r = MatchupRunner(A, B, heads, cfg, mode="table", table_quality="nano")
t0 = time.perf_counter()
out = r.run_pairs(n_pairs, seed=21, collect_players=False, collect_stats=False)
e_sc = np.asarray(out.score, dtype=float)
print(f"engine: {len(e_sc)} games in {time.perf_counter()-t0:.1f}s", flush=True)

o_win = float((o_sc[:, 0] > o_sc[:, 1]).mean())
e_win = float((e_sc[:, 0] > e_sc[:, 1]).mean())
se = float(np.sqrt(o_win * (1 - o_win) / len(o_sc)
                   + e_win * (1 - e_win) / len(e_sc)))
z = (e_win - o_win) / se
o_m, e_m = o_sc[:, 0] - o_sc[:, 1], e_sc[:, 0] - e_sc[:, 1]
md = f"""## Recovered ML play policy: high-power parity (VERDICT r1 #7)

use_play_model=True (5-class play_model.xgb recovered without xgboost,
temperature-calibrated); Kansas State vs Iowa State.

| quantity | oracle (n={len(o_sc)}) | engine nano (n={len(e_sc)}) | test |
|---|---|---|---|
| win% A | {o_win:.4f} | {e_win:.4f} | Δ {100*(e_win-o_win):+.2f}pp, z = {z:+.2f} |
| mean margin | {o_m.mean():+.2f} | {e_m.mean():+.2f} | |
| sd margin | {o_m.std(ddof=1):.2f} | {e_m.std(ddof=1):.2f} | |
| mean total | {(o_sc.sum(1)).mean():.2f} | {(e_sc.sum(1)).mean():.2f} | |

verdict: {"PASS" if abs(z) < 3.0 else "FAIL"} (|z| < 3)
"""
(REPO / "benchmarks" / "ML_POLICY_PARITY.md").write_text(md)
print(md, flush=True)
