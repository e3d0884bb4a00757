"""Config-#3 weekly slate through the game-sharded production path.

Round 3 added SlateRunner(game_shard=True): per-matchup packs/nano tables
stacked on a game axis, each device lax.scan-ing its matchup stripe with
in-scan ScoreMoments reduction (parallel/slate.py).  On ONE chip this is
the same workload as baseline config #3 (60 matchups x 100k games, one
summary per matchup) with a different execution shape: a single launch
covers the whole slate's chunk (60-game scan) instead of 60 per-matchup
launches, so dispatch overhead amortizes across the slate and the
pipeline never drains.

Usage: python benchmarks/slate_gamesharded_bench.py [n_matchups] [pairs]
"""
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax

from fast_monte_carlo.utils.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

from fast_monte_carlo.api import SlateRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import (
    build_team_context_from_sp_flex, load_sp_flex,
)
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.parallel import game_mesh

N_MATCHUPS = int(sys.argv[1]) if len(sys.argv) > 1 else 60
PAIRS = int(sys.argv[2]) if len(sys.argv) > 2 else 50_000
CHUNK = 32_768
RNG_IMPL = __import__("os").environ.get("B_RNG", "threefry")


def main():
    import dataclasses

    cfg = SimConfig()   # score-only; B_RNG=rbg for the round-3 default RNG
    if RNG_IMPL != "threefry":
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, rng_impl=RNG_IMPL))
    sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
    ranked = sp.sort_values("RATING", ascending=False)["team"].tolist()
    games = [(ranked[i], ranked[i + 1]) for i in range(0, 2 * N_MATCHUPS, 2)]
    heads = load_heads("/root/reference")
    ms = [(build_team_context_from_sp_flex(a, 2025, 1, sp),
           build_team_context_from_sp_flex(b, 2025, 1, sp))
          for a, b in games]

    t0 = time.perf_counter()
    sr = SlateRunner(ms, heads, cfg, quality="nano", game_shard=True)
    print(f"# build ({len(ms)} matchups, stacked): "
          f"{time.perf_counter()-t0:.0f}s", flush=True)
    mesh = game_mesh(jax.devices()[:1])

    t0 = time.perf_counter()
    df = sr.run_summaries(PAIRS, seed=0, chunk_pairs=CHUNK, mesh=mesh)
    compile_s = time.perf_counter() - t0
    n_games = int(df.n_games.sum())
    print(f"# compile+first: {compile_s:.0f}s ({n_games:,} games)",
          flush=True)

    best = None
    for r in range(2):
        t0 = time.perf_counter()
        df = sr.run_summaries(PAIRS, seed=r + 1, chunk_pairs=CHUNK, mesh=mesh)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
        print(f"# run {r}: {dt:.2f}s -> {n_games/dt:,.0f} games/s", flush=True)

    print(df.head(3).to_string())
    print(f"\n[game-sharded slate] {len(ms)} matchups x "
          f"{n_games//len(ms):,} games = {n_games:,} games: "
          f"{n_games/best:,.0f} games/s on 1 chip "
          f"(clean-timed rbg launch loop: 1.28M @16k, 1.63M @65k)")


if __name__ == "__main__":
    main()
