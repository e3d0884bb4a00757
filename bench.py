"""Benchmark harness: full-game simulations/second on the attached GPU.

Scenario = BASELINE config #2: one matchup from the SP+ sheet, full
play-by-play with every model head active (stage-1 forest, analytic
stage-2 reconstruction, 9 GBR quantile heads), alternating home/away first
offense.  Inputs default to the seeded artifact set (``seeded:0``:
seeded heads at the published shapes and a 137-team seeded SP+ sheet);
``--artifacts``/``--sp`` take real ones.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "games/sec", "vs_baseline": N,
   "meta": {n, chunk, rng, mode, device, ...}}

Baseline: the reference is a pure-Python multiprocessing simulator with no
published numbers (BASELINE.md).  We use 40 games/sec as the baseline —
a generous estimate of `fast_monte_carlo_cfb.py` at its default 4 worker
processes.

Measurements run on the GPU only: without one the harness exits non-zero.
``--smoke`` is the exception, a tiny CPU run of the same code path that
measures nothing.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

BASELINE_GAMES_PER_SEC = 40.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="table", choices=["table", "exact", "analytic"])
    ap.add_argument("--sp", default="seeded:0",
                    help="SP+ sheet: a csv path or seeded:<int>")
    ap.add_argument("--artifacts", default="seeded:0",
                    help="model artifact dir or seeded:<int>")
    ap.add_argument("--team-a", default="Team 030", dest="team_a")
    ap.add_argument("--team-b", default="Team 041", dest="team_b")
    # default is the steady-state shape (64 pipelined 65k launches)
    ap.add_argument("-n", type=int, default=4194304, help="games per timed run")
    ap.add_argument("--pairs", action="store_true", help="n counts pairs")
    ap.add_argument("--smoke", action="store_true", help="tiny CPU smoke run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--rng", default="rbg", choices=["threefry", "rbg"],
                    help="rbg (default here): XLA RngBitGenerator — "
                         "counter-based, deep-validated vs the CPU oracle "
                         "(VALIDATION.md).  The library default stays "
                         "threefry.")
    ap.add_argument("--unroll", type=int, default=0,
                    help="lax.scan unroll factor for the play loop "
                         "(0 = config default)")
    ap.add_argument("--play-chunk", type=int, default=0,
                    help="early-exit while_loop chunk size in plays "
                         "(0 = config default 24); smaller stops nearer "
                         "the true max step count at more cond overhead")
    ap.add_argument("--tail-chunk", type=int, default=0,
                    help="descending schedule: switch to this chunk size "
                         "after --tail-after plays (0 = off)")
    ap.add_argument("--tail-after", type=int, default=144,
                    help="play count where the tail chunk size begins")
    ap.add_argument("--antithetic", action="store_true",
                    help="mirrored-draw pairs: halves RNG generation "
                         "(variance-neutral for this workload — see "
                         "EngineConfig.antithetic)")
    # score-only is the default: the summary workload never consumes box
    # scores (config.resolve_nano_select picks the select for it)
    ap.add_argument("--stats", dest="stats", action="store_true",
                    default=False,
                    help="collect box-score accrual during the bench "
                         "(default off: summary workload is score-only)")
    ap.add_argument("--no-stats", dest="stats", action="store_false",
                    help=argparse.SUPPRESS)  # pre-round-3 spelling
    # default workload: scores consumed via device-side moment/histogram
    # accumulation (run_pairs_summary — the edge-scan production workload,
    # which frees score buffers per launch)
    ap.add_argument("--raw-scores", action="store_false", dest="summary",
                    default=True,
                    help="keep per-launch score buffers instead of the "
                         "default device-accumulated summary (the "
                         "scores-frame workload)")
    ap.add_argument("--chunk", type=int, default=65536,
                    help="games per launch; n is split into pipelined "
                         "launches (0 = single launch).  65536 was chosen "
                         "on the earlier chip and is not yet measured on "
                         "the GPU")
    ap.add_argument("--quality", default="nano",
                    choices=["default", "coarse", "slate", "fused", "turbo",
                             "nano"],
                    help="table axis-resolution preset")
    ap.add_argument("--shard", action="store_true",
                    help="multichip readiness: run every launch as a "
                         "shard_map over the FULL visible device mesh "
                         "(per-device ScoreMoments + one psum per chunk — "
                         "parallel.simulate_moments_sharded, the production "
                         "multi-chip path).  chunk scales by device count "
                         "so each device keeps the 65,536-game per-launch "
                         "size; on one device it measures the shard_map "
                         "overhead.")
    ap.add_argument("--no-lanes", dest="lanes", action="store_false",
                    default=True,
                    help="skip the extra production-lane measurements "
                         "(slate loop 60x65k, config-#3 sweep 60x100k) "
                         "that otherwise run after the main bench and land "
                         "in meta.lanes")
    args = ap.parse_args(argv)

    if args.smoke:
        os.environ["JAX_PLATFORMS"] = "cpu"
        args.n = min(args.n, 2048)
        if args.mode == "table":
            args.mode = "analytic"

    import jax
    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
    from fast_monte_carlo.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import numpy as np

    from fast_monte_carlo.api import MatchupRunner
    from fast_monte_carlo.config import SimConfig
    from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
    from fast_monte_carlo.models.heads import load_heads

    dev = jax.devices()[0]
    if not args.smoke and jax.default_backend() != "gpu":
        print(f"# no GPU: jax found {dev.platform}; bench measures on the "
              f"GPU only (--smoke runs the CPU path)", file=sys.stderr)
        return 2
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count()}
    print(f"# device: {device}", file=sys.stderr)

    import dataclasses

    cfg = SimConfig()
    if args.rng != "threefry":
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, rng_impl=args.rng))
    if args.unroll:
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                     scan_unroll=args.unroll))
    if args.antithetic:
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                     antithetic=True))
    if args.play_chunk:
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, play_chunk=args.play_chunk))
    if args.tail_chunk:
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, play_chunk_tail=args.tail_chunk,
            tail_after=args.tail_after))
    sp = load_sp_flex(args.sp)
    a = build_team_context_from_sp_flex(args.team_a, 2025, 1, sp)
    b = build_team_context_from_sp_flex(args.team_b, 2025, 1, sp)
    heads = load_heads(args.artifacts) if args.mode != "analytic" else None

    t0 = time.perf_counter()
    runner = MatchupRunner(a, b, heads, cfg, mode=args.mode,
                           table_quality=args.quality, shard=args.shard)
    build_s = time.perf_counter() - t0
    ndev = jax.device_count()
    print(f"# setup (incl. table build): {build_s:.1f}s"
          + (f" | sharded over {ndev} device(s)" if args.shard else ""),
          file=sys.stderr)

    n_pairs = args.n if args.pairs else max(1, args.n // 2)

    stats = args.stats
    chunk_pairs = (args.chunk // 2) if args.chunk else n_pairs
    if args.shard:
        # each device still sees one chunk of games per launch (mirrors
        # simulate_slate_summaries)
        chunk_pairs *= ndev
    chunk_pairs = min(chunk_pairs, n_pairs)
    if args.shard and not args.summary:
        # raw-scores mode feeds chunks straight to run_pairs, which
        # REFUSES launches not divisible by the mesh — round n up to
        # whole chunks (the summary path already does) so an odd -n
        # can't crash after the compile with no JSON emitted.
        # The clamp above can also make chunk_pairs itself non-mesh-
        # divisible (any -n <= one sharded launch): round chunk_pairs up
        # so 2*chunk_pairs stays divisible by ndev (ADVICE r4)
        import math
        div = ndev // math.gcd(2, ndev)
        if chunk_pairs % div:
            chunk_pairs = -(-chunk_pairs // div) * div
        rounded = -(-n_pairs // chunk_pairs) * chunk_pairs
        if rounded != n_pairs:
            print(f"# --shard raw-scores: n rounded {2*n_pairs:,} -> "
                  f"{2*rounded:,} games (whole sharded launches)",
                  file=sys.stderr)
            n_pairs = rounded

    if args.summary:
        def run_workload(seed0, pairs):
            """Edge-scan workload: scores consumed by device-accumulated
            moments/histograms (api.run_pairs_summary), one transfer."""
            return runner.run_pairs_summary(pairs, seed=seed0,
                                            chunk_pairs=min(chunk_pairs,
                                                            pairs),
                                            collect_stats=stats)

        def sanity(res):
            mean = np.asarray(res.mean_pts)
            return mean, float(np.asarray(res.win_rate)[0])
    else:
        def run_workload(seed0, pairs):
            """n split into pipelined launches (no sync between launches:
            dispatch overlaps and each launch's early-exit tail is
            shorter)."""
            cp = min(chunk_pairs, pairs)
            nc = -(-pairs // cp)
            root = jax.random.PRNGKey(seed0)
            outs = [runner.run_pairs(min(cp, pairs - ci * cp),
                                     key=jax.random.fold_in(root, ci),
                                     collect_players=False,
                                     collect_stats=stats, block=False)
                    for ci in range(nc)]
            jax.block_until_ready([o.score for o in outs])
            return outs

        def sanity(res):
            score = np.concatenate([np.asarray(o.score) for o in res])
            return score.mean(axis=0), float(
                (score[:, 0] > score[:, 1]).mean())

    runs = []

    def timed(seed0, pairs):
        t0 = time.perf_counter()
        res = run_workload(seed0, pairs)
        dt = time.perf_counter() - t0
        gps = 2 * pairs / dt
        runs.append(gps)
        print(f"# run n={2*pairs:,}: {dt:.3f}s -> {gps:,.0f} games/s",
              file=sys.stderr)
        return res

    # compile happens on the first chunk-sized launch
    quick_pairs = min(n_pairs, max(chunk_pairs, 524288))
    if args.shard and not args.summary:
        # keep the first shape on whole sharded launches too
        quick_pairs = min(n_pairs, -(-quick_pairs // chunk_pairs) * chunk_pairs)
    t0 = time.perf_counter()
    run_workload(args.seed, quick_pairs)
    compile_s = time.perf_counter() - t0
    print(f"# compile+first run: {compile_s:.1f}s "
          f"(launches of {2*chunk_pairs:,})", file=sys.stderr)
    outs = timed(args.seed + 500, quick_pairs)
    for r in range(args.repeats):
        if n_pairs == quick_pairs and r == 0 and args.repeats == 1:
            break  # the first timed run already measured this shape once
        outs = timed(args.seed + 1000 * (r + 1), n_pairs)

    mean, win_a = sanity(outs)
    print(f"# sanity: mean {np.asarray(mean, float).round(2).tolist()} "
          f"winA {win_a:.4f}", file=sys.stderr)

    # ---- production lanes: slate-class numbers in the same process ------
    lanes = []
    if args.lanes and args.mode == "table" and not args.shard \
            and not args.smoke:
        from fast_monte_carlo.api import simulate_slate_summaries
        ranked = sp.sort_values("RATING", ascending=False)["team"].tolist()
        games60 = [(ranked[i], ranked[i + 1]) for i in range(0, 120, 2)]
        for lane, np_lane in (("slate_loop_60x65k", 32768),
                              ("sweep3_60x100k", 50000)):
            kw = dict(sp_path=args.sp, n_pairs=np_lane, chunk_pairs=np_lane,
                      artifact_dir=args.artifacts, mode="table",
                      table_quality=args.quality, seed=args.seed,
                      cfg=cfg)   # same rng/engine knobs as the bench
            t0 = time.perf_counter()
            simulate_slate_summaries(games60, **kw)   # builds+compile
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            df = simulate_slate_summaries(games60, **kw)
            dt = time.perf_counter() - t0
            n_lane = int(df.n_games.sum())
            gps = n_lane / dt
            lanes.append({"lane": lane, "games_per_sec": round(gps, 1),
                          "n_games": n_lane, "matchups": len(games60),
                          "warmup_s": round(warm_s, 1),
                          "run_s": round(dt, 3)})
            print(f"# lane {lane}: {gps:,.0f} games/s ({n_lane:,} games in "
                  f"{dt:.2f}s; warmup {warm_s:.0f}s)", file=sys.stderr)

    best = max(runs)
    print(json.dumps({
        "metric": f"full_game_sims_per_sec_single_chip_{args.mode}"
                  + ("_summary" if args.summary else "")
                  + ("_sharded" if args.shard else ""),
        "value": round(best, 1),
        "unit": "games/sec",
        "vs_baseline": round(best / BASELINE_GAMES_PER_SEC, 1),
        "meta": {
            "n_games": 2 * n_pairs, "chunk_games": 2 * chunk_pairs,
            "rng": args.rng, "mode": args.mode,
            "workload": "summary" if args.summary else "raw_scores",
            "stats": stats, "quality": args.quality,
            "ndev": ndev, "sharded": args.shard, "device": device,
            "setup_s": round(build_s, 1), "compile_s": round(compile_s, 1),
            "runs": [round(x, 1) for x in runs],
            "lanes": lanes,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
