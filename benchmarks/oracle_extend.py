"""Extend the cached oracle sample to a larger n (high-power referee data).

Two referee protocols:

* WARM (default): one ever-warming memo cache over the whole stream — the
  SAME stream deep_validation.py and cover_ladder.py use (one sequential
  np.random.default_rng(123), first_offense = i % 2), so the existing
  oracle_margins_8000.npz is exactly the first 8000 games of this run
  (prefix-verified).  As VALIDATION.md documents, this referee is
  NON-stationary: margin sd decays toward the frozen limit as the cache
  fills, so very large n drifts from the reference's as-executed behavior.
* COLD (--cold [N]): memo caches reset every N games (default 250 — the
  reference's per-worker cache lifetime at its default run shape: n=500
  pairs over 4 Pool processes, fast_monte_carlo_cfb.py:1474-1496,
  :1302-1328).  Stationary AND faithful to the reference's real run
  length; seed-456 stream, outputs oracle_margins_cold_{n}.npz.  This is
  the referee the high-power north-star test prefers.

The oracle is pure Python on one host core, so runs are long.  Progress checkpoints
(scores + bit-generator state) land in a wip pickle every CHUNK games and
the run resumes from there if interrupted; the wip is kept on completion
so a later larger target continues the stream.  Milestone npz caches are
emitted en route.  Usage:

    python benchmarks/oracle_extend.py 32000
    python benchmarks/oracle_extend.py 131072 --cold
"""
import os
import pickle
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.oracle import OracleMatchup

CHUNK = 500

args = [a for a in sys.argv[1:] if not a.startswith("--")]
n_target = int(args[0]) if args else 32000
cold = "--cold" in sys.argv
cold_period = 250
for a in sys.argv[1:]:
    if a.startswith("--cold="):
        cold, cold_period = True, int(a.split("=", 1)[1])
assert CHUNK % cold_period == 0 or not cold, (
    "checkpoints must land on reset boundaries so resumes stay faithful")

tag = "cold_" if cold else ""
wip = REPO / "benchmarks" / f"oracle_margins_{tag}wip.pkl"
out = REPO / "benchmarks" / f"oracle_margins_{tag}{n_target}.npz"

cfg = SimConfig()
sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")
m = OracleMatchup(A, B, heads, cfg)

rng = np.random.default_rng(456 if cold else 123)
scores = []
if wip.exists():
    with open(wip, "rb") as f:
        ck = pickle.load(f)
    scores = list(ck["scores"])
    rng.bit_generator.state = ck["rng_state"]
    if not cold:
        # the WARM protocol is "one ever-warming cache": a resume must
        # restore the memo caches too, or games after the seam are drawn
        # against a re-warming cache and the stream is no longer the
        # advertised single-cache trajectory (cold runs don't need this —
        # CHUNK % cold_period == 0 puts every resume on a reset boundary)
        if "caches" not in ck:
            raise SystemExit(
                f"{wip.name} predates cache checkpointing: resuming it "
                "would reset the warm caches mid-stream. Delete the wip "
                "to restart the stream, or use --cold.")
        m._caches = ck["caches"]
    print(f"resumed at {len(scores)} games", flush=True)

MILESTONES = (16000, 32000, 65536, 131072, 196608, 262144, 327680)


def write_npz(n: int) -> None:
    sc = np.asarray(scores[:n], dtype=float)
    path = REPO / "benchmarks" / f"oracle_margins_{tag}{n}.npz"
    np.savez_compressed(path, margin=sc[:, 0] - sc[:, 1], score=sc)
    print(f"wrote {path.name}: n={n}, win_A={np.mean(sc[:,0]>sc[:,1]):.4f} "
          f"(SE {np.std(sc[:,0]>sc[:,1])/np.sqrt(n):.4f}), "
          f"mean margin {np.mean(sc[:,0]-sc[:,1]):.2f}, "
          f"mean total {np.mean(sc.sum(1)):.2f}", flush=True)


t0 = time.perf_counter()
done_at_start = len(scores)
while len(scores) < n_target:
    stop = min(len(scores) + CHUNK, n_target)
    for i in range(len(scores), stop):
        if cold and i % cold_period == 0:
            m.reset_caches()
        scores.append(m.simulate_game(i % 2, rng)["score"])
    with open(wip, "wb") as f:
        state = {"scores": np.asarray(scores, dtype=np.float32),
                 "rng_state": rng.bit_generator.state}
        if not cold:
            state["caches"] = m._caches
        pickle.dump(state, f)
    for ms in MILESTONES:       # emit intermediate caches along the way
        if len(scores) >= ms and not (
                REPO / "benchmarks" / f"oracle_margins_{tag}{ms}.npz").exists():
            write_npz(ms)
    rate = (len(scores) - done_at_start) / (time.perf_counter() - t0)
    print(f"{len(scores)}/{n_target} games ({rate:.1f}/s)", flush=True)

if not out.exists():
    write_npz(n_target)

sc = np.asarray(scores, dtype=float)
old = REPO / "benchmarks" / "oracle_margins_8000.npz"
if not cold and old.exists() and n_target >= 8000:
    prev = np.load(old)["score"]
    assert np.allclose(prev, sc[:8000]), "stream mismatch vs cached 8000!"
    print("prefix check ok: first 8000 games match oracle_margins_8000.npz",
          flush=True)
# the wip checkpoint is kept (scores + rng state): a later, larger target
# resumes from it instead of re-simulating the whole stream
