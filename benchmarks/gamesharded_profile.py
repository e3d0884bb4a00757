"""Op-profile the game-sharded slate scan (the CLAUDE.md open diagnostic).

Compares SlateRunner(game_shard=True)'s scan-over-games structure with
the per-matchup launch loop at the same per-game batch.  This probe
captures jax.profiler traces of BOTH execution
shapes at the same per-game batch and feeds them through xprof's
op_profile / framework_op_stats converters so the scan body's device-time
breakdown can be compared op-for-op against the launch-loop's.

Phase 'run' (needs the GPU):
  python benchmarks/gamesharded_profile.py run [--games 60] [--pairs 8192]
      [--out /tmp/gs_prof]
Phase 'analyze' (host-only, re-runnable):
  python benchmarks/gamesharded_profile.py analyze /tmp/gs_prof/scan
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def cmd_run(args):
    import jax
    from fast_monte_carlo.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import numpy as np

    from fast_monte_carlo.api import MatchupRunner, SlateRunner
    from fast_monte_carlo.config import SimConfig
    from fast_monte_carlo.data import (
        build_team_context_from_sp_flex, load_sp_flex,
    )
    from fast_monte_carlo.models.heads import load_heads
    from fast_monte_carlo.parallel import game_mesh

    import dataclasses
    import os

    cfg = SimConfig()
    rng = os.environ.get("B_RNG", "threefry")   # B_RNG=rbg: round-3 default
    if rng != "threefry":
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                     rng_impl=rng))
    sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
    ranked = sp.sort_values("RATING", ascending=False)["team"].tolist()
    games = [(ranked[i], ranked[i + 1]) for i in range(0, 2 * args.games, 2)]
    heads = load_heads("/root/reference")
    ms = [(build_team_context_from_sp_flex(a, 2025, 1, sp),
           build_team_context_from_sp_flex(b, 2025, 1, sp))
          for a, b in games]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # --- shape A: scan-over-games (game-sharded layout, 1-device mesh) ---
    t0 = time.perf_counter()
    sr = SlateRunner(ms, heads, cfg, quality="nano", game_shard=True)
    print(f"# stacked build: {time.perf_counter()-t0:.0f}s", flush=True)
    mesh = game_mesh(jax.devices()[:1])

    def scan_run(seed):
        df = sr.run_summaries(args.pairs, seed=seed, chunk_pairs=args.pairs,
                              mesh=mesh)
        return int(df.n_games.sum())

    t0 = time.perf_counter()
    n_games = scan_run(0)
    print(f"# scan compile+first: {time.perf_counter()-t0:.0f}s "
          f"({n_games:,} games)", flush=True)
    t0 = time.perf_counter()
    scan_run(1)
    dt = time.perf_counter() - t0
    print(f"# scan warm: {dt:.2f}s -> {n_games/dt:,.0f} games/s", flush=True)
    with jax.profiler.trace(str(out / "scan")):
        t0 = time.perf_counter()
        scan_run(2)
        dt = time.perf_counter() - t0
    print(f"# scan traced: {dt:.2f}s -> {n_games/dt:,.0f} games/s", flush=True)

    # --- shape B: per-matchup launch loop (config-#3 structure) at the
    # same per-game batch.  One matchup's tables x args.games launches is
    # structurally identical to the 60-matchup loop (same program, same
    # table shapes) and skips 59 more MatchupRunner builds.
    r0 = MatchupRunner(ms[0][0], ms[0][1], heads, cfg, mode="table",
                       table_quality="nano")

    def loop_run(seed):
        # ONE gating transfer only: each np.asarray synchronizes with the
        # device; 60 of them inside the timed region would understate the
        # loop
        import jax.random as jr
        root = jr.PRNGKey(seed)
        summs = [r0.run_pairs_summary(args.pairs, key=jr.fold_in(root, gi),
                                      chunk_pairs=args.pairs, block=False)
                 for gi in range(args.games)]
        _ = np.asarray(summs[-1].n)
        return args.games * 2 * args.pairs

    t0 = time.perf_counter()
    n_loop = loop_run(0)
    print(f"# loop compile+first: {time.perf_counter()-t0:.0f}s "
          f"({n_loop:,} games)", flush=True)
    t0 = time.perf_counter()
    loop_run(1)
    dt = time.perf_counter() - t0
    print(f"# loop warm: {dt:.2f}s -> {n_loop/dt:,.0f} games/s", flush=True)
    with jax.profiler.trace(str(out / "loop")):
        t0 = time.perf_counter()
        loop_run(2)
        dt = time.perf_counter() - t0
    print(f"# loop traced: {dt:.2f}s -> {n_loop/dt:,.0f} games/s", flush=True)
    print(f"# traces under {out}/scan and {out}/loop")


def _walk(node, path, rows):
    m = node.get("metrics") or {}
    kids = node.get("children") or []
    if not kids and m:
        rows.append((m.get("rawTime", m.get("time", 0.0)),
                     "/".join(path + [node.get("name", "?")])))
    for k in kids:
        _walk(k, path + [node.get("name", "?")], rows)


def cmd_analyze(args):
    from xprof.convert import raw_to_tool_data as rtd
    d = Path(args.dir)
    xplanes = sorted(d.rglob("*.xplane.pb"))
    if not xplanes:
        sys.exit(f"no .xplane.pb under {d}")
    paths = [str(p) for p in xplanes]
    print(f"# {len(paths)} xplane file(s)")
    for tool in ("op_profile", "framework_op_stats"):
        try:
            data, _ctype = rtd.xspace_to_tool_data(paths, tool, {})
        except Exception as e:  # keep going; tools vary by xprof build
            print(f"## {tool}: FAILED {e}")
            continue
        raw = d / f"{tool}.json"
        raw.write_bytes(data if isinstance(data, bytes) else data.encode())
        print(f"## {tool}: {raw} ({raw.stat().st_size:,} B)")
        try:
            j = json.loads(data)
        except Exception:
            continue
        if tool == "op_profile":
            root = j.get("byCategory") or j.get("byProgram") or {}
            rows = []
            _walk(root, [], rows)
            rows.sort(reverse=True)
            tot = sum(t for t, _ in rows) or 1.0
            print(f"### top self-time leaves (of {tot:.3g} total)")
            for t, name in rows[:25]:
                print(f"  {100*t/tot:6.2f}%  {name}")


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--games", type=int, default=60)
    r.add_argument("--pairs", type=int, default=8192)
    r.add_argument("--out", default="/tmp/gs_prof")
    r.set_defaults(fn=cmd_run)
    a = sub.add_parser("analyze")
    a.add_argument("dir")
    a.set_defaults(fn=cmd_analyze)
    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
