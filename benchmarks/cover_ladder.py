"""VERDICT r1 #8: margin dispersion in MARKET terms.

Computes cover probability vs the CPU oracle across a ladder of spreads for
every sd_mode ('axis' / 'frozen' / 'marginal'), quantifying the error bound
per line — spread-cover is the actual product (edge_finder.py:308-313), so
this is the deliverable quantity, not margin sd per se.

Oracle margins are cached to benchmarks/oracle_margins_{n}.npz so repeated
analyses don't re-pay the ~2 min/1000-game oracle cost.

Usage: python benchmarks/cover_ladder.py [n_oracle] [engine_pairs] [--cold]

--cold uses the cold-protocol referee cache (oracle_margins_cold_{n}.npz,
caches reset every 250 games = the reference's per-worker run length —
see VALIDATION.md 'referee goes cold'); default is the warm single-cache
stream the round-2 ladder used.
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

pos = [a for a in sys.argv[1:] if not a.startswith("--")]
n_oracle = int(pos[0]) if pos else 8000
n_pairs = int(pos[1]) if len(pos) > 1 else 131072
cold = "--cold" in sys.argv
tag = "cold_" if cold else ""

cfg0 = SimConfig()
sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")

cache = REPO / "benchmarks" / f"oracle_margins_{tag}{n_oracle}.npz"
if cache.exists():
    o_margin = np.load(cache)["margin"]
    print(f"oracle margins: loaded {len(o_margin)} from {cache.name}", flush=True)
else:
    from fast_monte_carlo.oracle import OracleMatchup
    m = OracleMatchup(A, B, heads, cfg0)
    rng = np.random.default_rng(456 if cold else 123)
    t0 = time.perf_counter()
    sc = []
    for i in range(n_oracle):
        if cold and i % 250 == 0:
            m.reset_caches()
        sc.append(m.simulate_game(i % 2, rng)["score"])
    sc = np.asarray(sc, dtype=float)
    o_margin = sc[:, 0] - sc[:, 1]
    np.savez_compressed(cache, margin=o_margin, score=sc)
    print(f"oracle: {n_oracle} games in {time.perf_counter()-t0:.0f}s", flush=True)

ladder = np.arange(-21.0, 21.1, 1.5)   # spreads from team A's perspective


def cover_curve(margin: np.ndarray) -> np.ndarray:
    # P(cover) = P(margin > -spread), push at equality excluded both sides
    return np.asarray([(margin > -s).mean() for s in ladder])


o_curve = cover_curve(o_margin)
o_sd = float(o_margin.std(ddof=1))
se = np.sqrt(o_curve * (1 - o_curve) / len(o_margin))   # oracle MC error

print(f"\noracle n={len(o_margin)}: margin sd {o_sd:.2f}, "
      f"win% {float((o_margin > 0).mean()):.4f}", flush=True)

rows = {}
for mode in ("axis", "frozen", "marginal"):
    cfg = cfg0.replace(engine=dataclasses.replace(cfg0.engine, sd_mode=mode))
    r = MatchupRunner(A, B, heads, cfg, mode="table", table_quality="nano")
    out = r.run_pairs(n_pairs, seed=11, collect_players=False,
                      collect_stats=False)
    sc = np.asarray(out.score, dtype=float)
    e_margin = sc[:, 0] - sc[:, 1]
    e_curve = cover_curve(e_margin)
    rows[mode] = (e_curve, float(e_margin.std(ddof=1)))
    print(f"engine[{mode}]: {len(sc)} games, margin sd {rows[mode][1]:.2f}",
          flush=True)

hdr = f"| spread A | oracle P(cover) (±1.96se) |" + "".join(
    f" {m} Δpp |" for m in rows)
lines = [
    "## Cover-probability ladder: oracle vs engine sd modes",
    "",
    f"Kansas State vs Iowa State; oracle n={len(o_margin)} "
    f"({'COLD protocol: caches reset every 250 games' if cold else 'warm single-cache stream'}, "
    f"sd {o_sd:.2f}), engine n={2*n_pairs} per mode "
    f"(sd axis {rows['axis'][1]:.2f} / frozen {rows['frozen'][1]:.2f} / "
    f"marginal {rows['marginal'][1]:.2f}).  Δpp = engine − oracle cover "
    "prob in percentage points; |Δ| within ~2·SE(oracle) is "
    "statistically indistinguishable.",
    "",
    hdr,
    "|" + "---|" * (2 + len(rows)),
]
for i, s in enumerate(ladder):
    cells = "".join(
        f" {100*(rows[m][0][i]-o_curve[i]):+.2f} |" for m in rows)
    lines.append(f"| {s:+.1f} | {100*o_curve[i]:.2f}% "
                 f"(±{196*se[i]:.2f}pp) |" + cells)
maxes = {m: float(np.abs(rows[m][0] - o_curve).max()) * 100 for m in rows}
lines += [
    "",
    "Max |Δ| across the ladder: " + ", ".join(
        f"{m} {v:.2f}pp" for m, v in maxes.items())
    + f"; oracle 2·SE ranges {100*2*se.min():.2f}–{100*2*se.max():.2f}pp.",
]
out_path = REPO / "benchmarks" / "COVER_LADDER.md"
out_path.write_text("\n".join(lines))
print("\n".join(lines[-4:]), flush=True)
print(f"wrote {out_path}", flush=True)
