"""Per-step cost of the play step's random draws, threefry vs rbg, on the GPU.

Each play step draws 13 uniforms and 4 normals per game from a key folded
with the step index (ops/game.py play_step).  This script times exactly
those draws inside a scan of STEPS steps at B games, minus the same scan
with the draws replaced by a constant of the same shape (both sum every
value, so nothing is skipped), and prints microseconds per step from the
fastest of five runs.

    python benchmarks/rng_draw_cost.py [B] [STEPS]      # default 65536 192

Needs a GPU; exits non-zero without one.
"""
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fast_monte_carlo.ops.game import N_NORMALS, N_UNIFORMS  # noqa: E402


def make(impl: str, B: int, steps: int, draw: bool):
    def run(seed):
        key = jax.random.PRNGKey(seed)
        if impl == "rbg":
            raw = jnp.tile(jax.random.key_data(key).reshape(-1), 2)[:4]
            key = jax.random.wrap_key_data(raw.astype(jnp.uint32), impl="rbg")

        def step(acc, j):
            if not draw:
                x = jnp.full((B, N_UNIFORMS + N_NORMALS), j, jnp.float32)
                return acc + x.sum(axis=1), None
            ku, kn = jax.random.split(jax.random.fold_in(key, j))
            u = jax.random.uniform(ku, (B, N_UNIFORMS))
            n = jax.random.normal(kn, (B, N_NORMALS))
            # consume every draw: a slice would let XLA skip the rest
            return acc + u.sum(axis=1) + n.sum(axis=1), None

        acc, _ = jax.lax.scan(step, jnp.zeros((B,), jnp.float32),
                              jnp.arange(steps))
        return acc
    return jax.jit(run)


def timed(fn, reps: int = 5) -> float:
    jax.block_until_ready(fn(0))                 # compile + warm
    best = float("inf")
    for r in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(r + 1))
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    if jax.default_backend() != "gpu":
        print("rng_draw_cost: needs a GPU", file=sys.stderr)
        return 1
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 192
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    base = timed(make("threefry", B, steps, False))
    print(f"{card} | B={B} steps={steps} | empty scan {base * 1e3:.3f} ms")
    for impl in ("threefry", "rbg"):
        t = timed(make(impl, B, steps, True))
        print(f"{impl}: {(t - base) / steps * 1e6:.2f} us/step of draws "
              f"({t * 1e3:.3f} ms for the scan)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
