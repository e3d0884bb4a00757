"""Command-line entry points.

    python -m fast_monte_carlo.cli sim "Team 030" "Team 041" \
        --sp seeded:0 --artifacts seeded:0 -n 1000 --save
    python -m fast_monte_carlo.cli edges --base team030_team041_wk1_sims.csv \
        --team-a "Team 030" --team-b "Team 041" --spread -3 --total 50.5
    python -m fast_monte_carlo.cli slate --games games.csv --sp ... -n 10000
    python -m fast_monte_carlo.cli bench --mode table -n 100000

`--sp` takes an SP+ csv path and `--artifacts` a model-artifact
directory; ``seeded:<int>`` selects the seeded set for either (the
artifact default is ``seeded:0``).

(The reference has no CLI — parameters are edited in __main__ blocks,
fast_monte_carlo_cfb.py:1727-1759; this replaces that workflow.)
"""
from __future__ import annotations

import argparse
import sys
import time


def _cmd_sim(args) -> int:
    from .api import csv_base_from, simulate_upcoming_matchup

    cfg = None
    heads = None
    if getattr(args, "reconstructed", False):
        # full-fidelity reconstructed mode: recovered ML play policy +
        # repo-trained stage-2 + non-unit temperature overlay
        from .config import reconstructed_config
        from .models.heads import load_reconstructed_heads
        cfg = reconstructed_config()
        heads = load_reconstructed_heads(args.artifacts)
    if getattr(args, "sd_mode", "axis") != "axis":
        import dataclasses

        from .config import SimConfig
        cfg = cfg or SimConfig()
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                     sd_mode=args.sd_mode))
    save = csv_base_from(args.team_a, args.team_b, args.week) if args.save else None
    sims_df, players_df, summary, a, b, meta = simulate_upcoming_matchup(
        args.team_a, args.team_b, year=args.year, week=args.week,
        sp_path=args.sp, artifact_dir=args.artifacts, focus_csv=args.focus,
        n=args.n, collect_players=args.players, save_csv=save, mode=args.mode,
        seed=args.seed, cfg=cfg, shard=args.shard, heads=heads)
    print(summary)
    pairs = max(1, len(sims_df) // 2)
    print(f"\nTiming: {meta['total_time_sec']:.2f}s total | {pairs} sims "
          f"| {pairs/meta['total_time_sec']:.2f} sims/sec "
          f"| sim-only {meta['sim_time_sec']:.2f}s | I/O {meta['io_time_sec']:.2f}s")
    if save:
        print(f"saved scores_{save} / players_{save}")
    return 0


def _cmd_live(args) -> int:
    """In-game win probability from a mid-game situation (no reference
    counterpart — its simulate_game is kickoff-only)."""
    from .api import simulate_live_game, situation_from_fields
    from .config import SimConfig
    from .edge import market_odds_from_summary, summary_moneyline

    sa, sb = (int(v) for v in args.score.split("-"))
    sit = situation_from_fields(
        ytg=args.ytg, offense=args.offense, sec=args.sec,
        quarter=args.quarter, clock=args.clock, down=args.down,
        dist=args.dist, score_a=sa, score_b=sb)
    sec, offense = sit.sec, sit.offense
    row, summary = simulate_live_game(
        args.team_a, args.team_b, sit, sp_path=args.sp, year=args.year,
        week=args.week, n_games=args.n, artifact_dir=args.artifacts,
        focus_csv=args.focus, mode=args.mode, table_quality=args.quality,
        seed=args.seed, shard=args.shard)
    qsec = SimConfig().clock.quarter_seconds
    qtr = 4 - (int(sec) - 1) // qsec      # the engine's own period formula
    clock = int(sec) - (4 - qtr) * qsec   # seconds left in that quarter
    print(f"{args.team_a} {sa} - {sb} {args.team_b} | "
          f"Q{qtr} {clock // 60}:{clock % 60:02d} | "
          f"{'AB'[offense]} ball, down {args.down} & {args.dist:g} "
          f"at ytg {args.ytg:g}")
    print(f"win: {args.team_a} {row['win_a']:.3f} / {args.team_b} "
          f"{row['win_b']:.3f} / tie {row['tie']:.3f}   "
          f"(n={row['n_games']})")
    print(f"proj: {row['mean_a']:.1f} - {row['mean_b']:.1f} "
          f"(margin {row['mean_margin_a']:+.1f}, total {row['mean_total']:.1f})")
    ml = summary_moneyline(summary, args.team_a, args.team_b)
    print(f"fair moneyline: {ml}")
    if args.spread is not None or args.total is not None:
        print(market_odds_from_summary(summary, args.team_a, args.team_b,
                                       spread=args.spread, total=args.total))
    return 0


def _cmd_fourth(args) -> int:
    """4th-down decision chart: forced go/FG/punt win probabilities next to
    the engine's sampled policy (no reference counterpart — handle_fourth
    always samples, fast_monte_carlo_cfb.py:1394-1421)."""
    from .api import evaluate_fourth_down, situation_from_fields

    sa, sb = (int(v) for v in args.score.split("-"))
    sit = situation_from_fields(
        ytg=args.ytg, offense=args.offense, sec=args.sec,
        quarter=args.quarter, clock=args.clock, down=4,
        dist=args.dist, score_a=sa, score_b=sb)
    sec, offense = sit.sec, sit.offense
    res = evaluate_fourth_down(
        args.team_a, args.team_b, sit, sp_path=args.sp, year=args.year,
        week=args.week, n_games=args.n, artifact_dir=args.artifacts,
        focus_csv=args.focus, mode=args.mode, table_quality=args.quality,
        seed=args.seed)
    off_team = (args.team_a, args.team_b)[offense]
    print(f"{args.team_a} {sa} - {sb} {args.team_b} | 4th & {args.dist:g} "
          f"at ytg {args.ytg:g}, {sec}s left | {off_team} ball")
    for choice in ("policy", "go", "fg", "punt"):
        if choice not in res["choices"]:
            continue
        row = res["choices"][choice]
        extra = (f"  (make prob {row['fg_make_prob']:.2f})"
                 if choice == "fg" else "")
        mark = "  <-- best" if choice == res["best"] else ""
        print(f"  {choice:<7s} win({off_team}) {row['win_off']:.4f}   "
              f"margin {row['mean_margin_off']:+.2f}{extra}{mark}")
    print(f"  best {res['best']} vs policy: {res['best_vs_policy_pp']:+.2f}pp"
          f"   (MC scale ~{res['se_pp']:.2f}pp/choice; deltas are "
          "CRN-paired)")
    return 0


def _cmd_parlay(args) -> int:
    """Same-game parlay pricing off the joint per-trial distribution (no
    reference counterpart — edge_finder.py only prices marginals)."""
    import json

    from .api import simulate_parlay
    from .edge import print_parlay_readable

    raw = args.legs
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    legs = json.loads(raw)
    if not isinstance(legs, list):
        raise SystemExit("--legs must be a JSON array of leg objects "
                         "(or @path to one)")
    if args.tease is not None:
        from .edge import tease_legs
        legs = tease_legs(legs, args.tease)
        print(f"[teaser: every leg moved {args.tease:+g} points in the "
              "bettor's favor; pushes void and reduce]")
    rr = None
    if args.rr is not None:
        try:
            rr = [int(k) for k in args.rr.split(",")]
        except ValueError:
            raise SystemExit(f"--rr wants a size or comma list of sizes "
                             f"(e.g. 2 or 2,3), got {args.rr!r}")
    res = simulate_parlay(
        args.team_a, args.team_b, legs, sp_path=args.sp, year=args.year,
        week=args.week, n_pairs=args.n, artifact_dir=args.artifacts,
        focus_csv=args.focus, mode=args.mode, table_quality=args.quality,
        seed=args.seed, shard=args.shard, price=args.price,
        correlations=args.corr, round_robin=rr)
    print_parlay_readable(res)
    if args.corr:
        print("\nLeg win-indicator correlations:")
        print(res["leg_corr"].round(3).to_string())
    if rr is not None:
        from .edge import print_round_robin_readable
        print_round_robin_readable(res["round_robin"])
    if args.json:
        from .serve import jsonable
        print(json.dumps(jsonable(res)))
    return 0


def _parse_line_pair(spec: str, flag: str):
    """Parse a LOW,HIGH line pair for the middle flags."""
    try:
        lo, hi = (float(x) for x in spec.split(","))
    except ValueError:
        raise SystemExit(
            f"{flag} wants two comma-separated lines (e.g. -3.5,7.5), "
            f"got {spec!r}")
    return lo, hi


def _middle_specs(args):
    """The (mid_spread, mid_total) kwargs both edges paths share."""
    return dict(
        mid_spread=(None if args.mid_spread is None else
                    _parse_line_pair(args.mid_spread, "--mid-spread")),
        mid_total=(None if args.mid_total is None else
                   _parse_line_pair(args.mid_total, "--mid-total")))


def _cmd_edges(args) -> int:
    if args.device:
        return _cmd_edges_device(args)
    mids = _middle_specs(args)  # bad --mid specs fail before any pricing
    want_mid = any(v is not None for v in mids.values())
    from .edge import find_edges
    if (args.spread is not None or args.total is not None
            or args.props is not None or not want_mid):
        # middles-only invocations skip the main report (game_market_odds
        # refuses to price without a quoted line); everything else —
        # including a middles+props call — keeps the full
        # spread/total/ML/props printout
        find_edges(csv_base=args.base, team_a=args.team_a,
                   team_b=args.team_b, spread=args.spread, total=args.total,
                   props_csv=args.props, directory=args.dir)
    want_alt = args.alt and (args.spread is not None
                             or args.total is not None)
    if want_alt or want_mid:
        from .edge import find_saved_files, load_table
        scores_path, _ = find_saved_files(args.base, team_a=args.team_a,
                                          team_b=args.team_b,
                                          directory=args.dir)
        sims = load_table(scores_path)
    if want_alt:
        from .edge import alt_lines_from_sims, print_alt_lines
        print_alt_lines(alt_lines_from_sims(
            sims, args.team_a, args.team_b,
            spread=args.spread, total=args.total, width=args.alt_width,
            step=args.alt_step))
    if want_mid:
        from .edge import middles_from_sims, print_middle_readable
        for res in middles_from_sims(sims, args.team_a, args.team_b,
                                     **mids).values():
            print_middle_readable(res)
    return 0


def _cmd_prop(args) -> int:
    """One player prop off saved sims (players_* table), optionally with
    the alternate-line ladder around the quote."""
    from .edge import player_prop_odds, player_prop_ladder

    res = player_prop_odds(args.base, args.team, args.player, args.stat,
                           args.line, role=args.role, directory=args.dir)
    print(f"\n=== {res['player']} ({res['team']}, {res['role']}) "
          f"{res['stat']} {res['line']:g} ===")
    print(f"  Over:  {res['p_over']:.1%} fair {res['american_over']:+d}   "
          f"Under: {res['p_under']:.1%} fair {res['american_under']:+d}"
          + (f"   push {res['push_rate']:.1%}" if res["push_rate"] else ""))
    print(f"  mean {res['mean']:.1f}  median {res['median']:.1f}  "
          f"p75 {res['p75']:.1f}  p90 {res['p90']:.1f}")
    print(f"  Best side at -110: {res['best_side']} "
          f"(edge {res['edge']:+.2f}%, EV ${res['ev_per_$100']:+.2f}/$100)")
    if args.ladder:
        tbl = player_prop_ladder(args.base, args.team, args.player,
                                 args.stat, args.line, role=args.role,
                                 directory=args.dir, width=args.width,
                                 step=args.step, price=args.price)
        print("\nAlternate lines (same samples as the quote):")
        print(tbl.drop(columns=["team", "player", "stat"])
              .to_string(index=False))
    return 0


def _cmd_edges_device(args) -> int:
    """Device-resident edge scan: simulate and reduce on the accelerator —
    spread/total/ML from on-device histograms, props from device pstats.
    No sim files touch disk (reference equivalent: edge_finder.py:586-614
    over saved CSVs)."""
    import jax
    import numpy as np

    from .api import MatchupRunner
    from .data import build_team_context_from_sp_flex, load_sp_flex
    from .edge import (
        market_odds_from_summary, print_game_market_readable,
        print_prop_table, scan_props_device,
    )
    from .models.heads import load_heads
    from .parallel import summarize_scores

    if not args.sp:
        print("edges --device needs --sp (it simulates in-process)",
              file=sys.stderr)
        return 2
    mids = _middle_specs(args)  # bad --mid specs fail before the sim runs
    sp = load_sp_flex(args.sp)
    a = build_team_context_from_sp_flex(args.team_a, args.year, args.week, sp,
                                        focus_csv=args.focus)
    b = build_team_context_from_sp_flex(args.team_b, args.year, args.week, sp,
                                        focus_csv=args.focus)
    heads = load_heads(args.artifacts)
    runner = MatchupRunner(a, b, heads, mode=args.mode,
                           table_quality=args.quality, shard=args.shard)
    want_players = bool(args.props)
    t0 = time.perf_counter()
    if args.n > 65536 and not want_players:
        # large market-only scans: pipelined launches with device-side
        # moment accumulation (api.run_pairs_summary; n rounds up to whole launches so every launch shares
        # one compiled shape); props need per-game pstats, so the prop
        # path stays single-launch
        summary = runner.run_pairs_summary(args.n, seed=args.seed)
    else:
        out = runner.run_pairs(args.n, seed=args.seed,
                               collect_players=want_players,
                               collect_stats=False)
        summary = jax.jit(summarize_scores)(out.score)
    from .utils.transfer import fetch_tree
    summary = fetch_tree(summary)  # markets read 3 leaves: one transfer
    n_games = int(np.asarray(summary.n))
    dt = time.perf_counter() - t0
    res = market_odds_from_summary(summary, args.team_a, args.team_b,
                                   spread=args.spread, total=args.total)
    print_game_market_readable(res)
    if args.alt and (args.spread is not None or args.total is not None):
        from .edge import alt_lines_from_summary, print_alt_lines
        print_alt_lines(alt_lines_from_summary(
            summary, args.team_a, args.team_b, spread=args.spread,
            total=args.total, width=args.alt_width, step=args.alt_step))
    if any(v is not None for v in mids.values()):
        from .edge import middles_from_summary, print_middle_readable
        for r in middles_from_summary(summary, args.team_a, args.team_b,
                                      **mids).values():
            print_middle_readable(r)
    if args.props:
        df = scan_props_device(out, a, b, args.props)
        print_prop_table(df)
    print(f"\n[{n_games} games simulated + reduced on "
          f"{jax.devices()[0].platform} in {dt:.2f}s]")
    return 0


def _slate_contexts(args, games):
    """Build (team_a, team_b) contexts + heads once for the SlateRunner
    branches of `slate` (game-sharded and batched share this block)."""
    from .data import build_team_context_from_sp_flex, load_sp_flex
    from .models.heads import load_heads

    sp = load_sp_flex(args.sp)
    ms = [(build_team_context_from_sp_flex(a, args.year, args.week, sp),
           build_team_context_from_sp_flex(b, args.year, args.week, sp))
          for a, b in games]
    return ms, load_heads(args.artifacts)


def _cmd_slate(args) -> int:
    import pandas as pd

    if getattr(args, "lines", None) and args.batched and args.shard == "none":
        # fail before simulating: the batched path has no device-histogram
        # summaries, so it cannot price markets
        print("--lines needs a summary slate path (drop --batched, or use "
              "--shard trial|game); no simulation run")
        return 2
    games = [tuple(r) for r in pd.read_csv(args.games).iloc[:, :2].itertuples(index=False)]
    lines_df = pd.read_csv(args.lines) if getattr(args, "lines", None) else None
    summaries = None
    t0 = time.perf_counter()
    if args.shard == "trial" or (lines_df is not None and not args.batched
                                 and args.shard == "none"):
        # the RECOMMENDED multi-chip slate: per-matchup launches, trial
        # axis sharded over the full mesh, moments psum'd per chunk.
        # --lines also routes the unsharded default here: market pricing
        # needs the device-histogram summaries this path accumulates.
        from .api import simulate_slate_summaries
        res = simulate_slate_summaries(
            games, sp_path=args.sp, year=args.year, week=args.week,
            n_pairs=args.n, artifact_dir=args.artifacts, mode=args.mode,
            table_quality=args.quality, shard=args.shard == "trial",
            return_summaries=lines_df is not None)
        df, summaries = res if lines_df is not None else (res, None)
    elif args.shard == "game":
        # game-sharded layout: each device holds only its own matchups'
        # nano tables, whole slate in ONE launch — the multi-chip game-
        # axis layout; needs fusible matchups
        from .api import SlateRunner

        ms, heads = _slate_contexts(args, games)
        sr = SlateRunner(ms, heads, quality=args.quality, game_shard=True)
        res = sr.run_summaries(args.n, return_summaries=lines_df is not None)
        df, summaries = res if lines_df is not None else (res, None)
    elif args.batched:
        from .api import SlateRunner

        ms, heads = _slate_contexts(args, games)
        sr = SlateRunner(ms, heads,
                         quality=args.quality if args.quality in
                         ("turbo", "nano", "fused") else "fused")
        out = sr.run(args.n)
        df = sr.summaries(out)
    else:
        from .api import simulate_slate
        df = simulate_slate(games, sp_path=args.sp, year=args.year, week=args.week,
                            n=args.n, artifact_dir=args.artifacts, mode=args.mode,
                            table_quality=args.quality)
    print(df.to_string(index=False))
    total_games = int(df["n_games"].sum())
    dt = time.perf_counter() - t0
    print(f"\n{len(games)} matchups x {args.n} pairs = {total_games} games "
          f"in {dt:.1f}s ({total_games/dt:,.0f} games/s incl. table builds)")
    if lines_df is not None:
        from .edge import print_slate_edges, slate_market_table
        print_slate_edges(slate_market_table(games, summaries, lines_df))
    if getattr(args, "props", None):
        from .api import simulate_slate_props
        from .edge import print_prop_table
        pdf = simulate_slate_props(
            games, sp_path=args.sp, props_csv=args.props, year=args.year,
            week=args.week, n_pairs=args.props_n, mode=args.mode,
            artifact_dir=args.artifacts, table_quality=args.quality,
            focus_csv=args.focus, min_abs_edge_pct=args.min_edge,
            shard=args.shard == "trial")
        print_prop_table(pdf)
    return 0


def _cmd_season(args) -> int:
    """Season win-total projection: per-game slate sims -> exact
    Poisson-binomial win-count distribution (api.project_season)."""
    import pandas as pd

    from .api import project_season
    from .edge import print_season_readable

    if (args.opponents is None) == (args.games is None):
        print("pass exactly one of --opponents or --games; no simulation run")
        return 2
    opps = ([s.strip() for s in args.opponents.split(",") if s.strip()]
            if args.opponents else None)
    games = ([tuple(r) for r in
              pd.read_csv(args.games).iloc[:, :2].itertuples(index=False)]
             if args.games else None)
    t0 = time.perf_counter()
    res = project_season(
        args.team, opponents=opps, games=games, line=args.line,
        sp_path=args.sp, year=args.year, week=args.week, n_pairs=args.n,
        artifact_dir=args.artifacts, mode=args.mode,
        table_quality=args.quality, seed=args.seed, shard=args.shard)
    dt = time.perf_counter() - t0
    sched = res["schedule"]
    for _, row in sched.iterrows():
        us, them = (("mean_a", "mean_b") if row["team_side"] == "a"
                    else ("mean_b", "mean_a"))
        print(f"  vs {str(row['opponent']):<24s} p_win "
              f"{row['p_win_team']:.4f}  (proj {row[us]:.1f}-{row[them]:.1f})")
    print_season_readable(res)
    total = int(sched["n_games"].sum())
    print(f"\n[{len(sched)} matchups x {args.n} pairs = {total} games "
          f"in {dt:.1f}s]")
    return 0


def _cmd_backtest(args) -> int:
    """Score the simulator against actual finals (backtest.py): win-prob
    calibration, point accuracy, and PIT distribution checks."""
    import pandas as pd

    from .backtest import backtest_slate, print_backtest_readable

    results = pd.read_csv(args.results)
    need = {"team_a", "team_b", "score_a", "score_b"}
    if not need <= set(results.columns):
        print(f"--results needs columns {sorted(need)}, got "
              f"{list(results.columns)}")
        return 2
    games = ([tuple(r) for r in
              pd.read_csv(args.games).iloc[:, :2].itertuples(index=False)]
             if args.games else
             [(r.team_a, r.team_b) for r in results.itertuples(index=False)])
    rep = backtest_slate(
        games, results, sp_path=args.sp, year=args.year, week=args.week,
        n_pairs=args.n, artifact_dir=args.artifacts, mode=args.mode,
        table_quality=args.quality, seed=args.seed, shard=args.shard,
        bins=args.bins)
    print_backtest_readable(rep)
    return 0


def _cmd_serve(args) -> int:
    """Run the resident simulation service (see serve.py)."""
    from .serve import ServeConfig, serve_forever

    warm_games = None
    if args.warm:
        import pandas as pd
        warm_games = [tuple(r) for r in
                      pd.read_csv(args.warm).iloc[:, :2].itertuples(index=False)]
    serve_forever(
        ServeConfig(sp_path=args.sp, artifact_dir=args.artifacts,
                    year=args.year, week=args.week, mode=args.mode,
                    table_quality=args.quality, focus_csv=args.focus,
                    shard=args.shard, max_n_pairs=args.max_pairs,
                    max_games=args.max_games, deadline_s=args.deadline,
                    aot_dir=args.aot),
        host=args.host, port=args.port, warm_games=warm_games)
    return 0


def _cmd_bench(args) -> int:
    """Run bench.py's main in THIS process: a child process would need the
    card while this one may already hold it."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "bench.py"
    spec = importlib.util.spec_from_file_location("fmc_bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench.main(["--mode", args.mode, "-n", str(args.n)])


def _cmd_train(args) -> int:
    """Offline training pipeline entry (SURVEY §2.2 recipes): reads an
    ml_*-style plays table, trains the requested heads, writes artifacts
    (plus *_eval.json metric dumps) into --out."""
    import pandas as pd

    from .train import pipeline as P

    df = pd.read_csv(args.data)
    if "goal_to_go" not in df.columns:
        df = P.derive_state_features(df)
    heads = [h.strip() for h in args.heads.split(",") if h.strip()]
    for h in heads:
        if h == "stage1":
            print("stage1 ->", P.train_stage1(df, args.out))
        elif h == "stage2":
            print("stage2 ->", P.train_stage2(df, args.out))
        elif h == "fumble":
            print("fumble ->", P.train_fumble(df, args.out))
        elif h == "play":
            print("play ->", P.train_play_policy(df, args.out,
                                                 binary=not args.multiclass))
        elif h in ("pass", "run", "sack"):
            sub = df
            if h == "sack" and "pass_outcome" in df.columns:
                sub = df[df["pass_outcome"] == "sack"]
            for pth in P.train_quantile_heads(sub, h, args.out,
                                              n_estimators=args.trees):
                print(f"{h} quantiles ->", pth)
        else:
            print(f"unknown head {h!r} (use stage1,stage2,fumble,play,"
                  f"pass,run,sack)", file=sys.stderr)
            return 2
    return 0


def _enable_compile_cache() -> None:
    """Persistent XLA compile cache (utils.compile_cache): without it every
    fresh CLI process re-pays the compile of the scan program."""
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()


def _arg_offense(s: str) -> str:
    """argparse validator: clean error instead of a KeyError traceback."""
    if s.strip().lower() not in ("a", "b"):
        raise argparse.ArgumentTypeError(f"offense must be A or B, got {s!r}")
    return s


def _arg_score(s: str) -> str:
    parts = s.split("-")
    if len(parts) != 2 or not all(p.strip().isdigit() for p in parts):
        raise argparse.ArgumentTypeError(
            f"score must look like 21-17, got {s!r}")
    return s


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fast_monte_carlo")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sim", help="simulate one matchup")
    ps.add_argument("team_a")
    ps.add_argument("team_b")
    ps.add_argument("--sp", required=True, help="SP+ csv path (schema A or B) or seeded:<int>")
    ps.add_argument("-n", type=int, default=1000, help="number of PAIRS")
    ps.add_argument("--year", type=int, default=2025)
    ps.add_argument("--week", type=int, default=1)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--mode", default="table", choices=["table", "exact", "analytic"])
    ps.add_argument("--artifacts", default="seeded:0")
    ps.add_argument("--focus", default=None, help="focus players csv")
    ps.add_argument("--players", action="store_true", help="collect player stats")
    ps.add_argument("--save", action="store_true")
    ps.add_argument("--shard", action="store_true",
                    help="shard the trial axis over all devices")
    ps.add_argument("--reconstructed", action="store_true",
                    help="full-fidelity reconstructed mode: recovered ML "
                         "play policy + repo-trained stage-2 + non-unit "
                         "temperature (config.reconstructed_config + the "
                         "committed artifact overlay)")
    ps.add_argument("--sd-mode", default="axis", dest="sd_mode",
                    choices=["axis", "frozen", "marginal", "cachewarm"],
                    help="score_diff treatment for the table heads "
                         "(EngineConfig.sd_mode; see config.py notes)")
    ps.set_defaults(fn=_cmd_sim)

    pg = sub.add_parser(
        "live", help="in-game win probability from a mid-game state")
    pg.add_argument("team_a")
    pg.add_argument("team_b")
    pg.add_argument("--sp", required=True, help="SP+ csv path")
    pg.add_argument("--offense", default="A", type=_arg_offense,
                    help="side with the ball: A or B")
    pg.add_argument("--sec", type=int, default=None,
                    help="seconds remaining in the GAME (overrides "
                         "--quarter/--clock)")
    pg.add_argument("--quarter", type=int, default=1, choices=[1, 2, 3, 4])
    pg.add_argument("--clock", default=None,
                    help="MM:SS remaining in the quarter (default 15:00)")
    pg.add_argument("--down", type=int, default=1, choices=[1, 2, 3, 4])
    pg.add_argument("--dist", type=float, default=10.0,
                    help="yards to the first-down marker")
    pg.add_argument("--ytg", type=float, required=True,
                    help="yards to the opponent goal line (1-99)")
    pg.add_argument("--score", default="0-0", type=_arg_score,
                    help="current score as A-B, e.g. 21-17")
    pg.add_argument("-n", type=int, default=65536, help="number of GAMES")
    pg.add_argument("--spread", type=float, default=None,
                    help="live spread quote (team A perspective)")
    pg.add_argument("--total", type=float, default=None,
                    help="live total quote")
    pg.add_argument("--year", type=int, default=2025)
    pg.add_argument("--week", type=int, default=1)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--mode", default="table",
                    choices=["table", "exact", "analytic"])
    pg.add_argument("--quality", default="nano")
    pg.add_argument("--focus", default=None)
    pg.add_argument("--artifacts", default="seeded:0")
    pg.add_argument("--shard", action="store_true",
                    help="shard the trial axis over all devices")
    pg.set_defaults(fn=_cmd_live)

    pf = sub.add_parser(
        "fourth", help="4th-down decision chart (forced go/fg/punt vs policy)")
    pf.add_argument("team_a")
    pf.add_argument("team_b")
    pf.add_argument("--sp", required=True, help="SP+ csv path")
    pf.add_argument("--offense", default="A", type=_arg_offense,
                    help="side with the ball: A or B")
    pf.add_argument("--sec", type=int, default=None,
                    help="seconds remaining in the GAME (overrides "
                         "--quarter/--clock)")
    pf.add_argument("--quarter", type=int, default=4, choices=[1, 2, 3, 4])
    pf.add_argument("--clock", default=None,
                    help="MM:SS remaining in the quarter (default 15:00)")
    pf.add_argument("--dist", type=float, required=True,
                    help="yards to the first-down marker")
    pf.add_argument("--ytg", type=float, required=True,
                    help="yards to the opponent goal line (1-99)")
    pf.add_argument("--score", default="0-0", type=_arg_score,
                    help="current score as A-B, e.g. 21-17")
    pf.add_argument("-n", type=int, default=65536,
                    help="number of GAMES per choice")
    pf.add_argument("--year", type=int, default=2025)
    pf.add_argument("--week", type=int, default=1)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--mode", default="table",
                    choices=["table", "exact", "analytic"])
    pf.add_argument("--quality", default="nano")
    pf.add_argument("--focus", default=None)
    pf.add_argument("--artifacts", default="seeded:0")
    pf.set_defaults(fn=_cmd_fourth)

    pp = sub.add_parser(
        "parlay", help="price a same-game parlay off the joint distribution")
    pp.add_argument("team_a")
    pp.add_argument("team_b")
    pp.add_argument("--sp", required=True, help="SP+ csv path")
    pp.add_argument(
        "--legs", required=True,
        help='JSON array of legs, or @path to a JSON file.  Leg kinds: '
             '{"kind":"spread","team":...,"line":-3.5}, '
             '{"kind":"moneyline","team":...}, '
             '{"kind":"total","side":"over|under","line":55.5}, '
             '{"kind":"prop","team":...,"player":...,"stat":"pass_yds",'
             '"side":"over|under","line":249.5}')
    pp.add_argument("-n", type=int, default=32768, help="number of PAIRS")
    pp.add_argument("--price", type=int, default=None,
                    help="quoted American price for the ticket, e.g. +450")
    pp.add_argument("--year", type=int, default=2025)
    pp.add_argument("--week", type=int, default=1)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--mode", default="table",
                    choices=["table", "exact", "analytic"])
    pp.add_argument("--quality", default="nano")
    pp.add_argument("--focus", default=None,
                    help="focus-players csv (needed for prop legs)")
    pp.add_argument("--artifacts", default="seeded:0")
    pp.add_argument("--shard", action="store_true",
                    help="shard the trial axis over all devices")
    pp.add_argument("--json", action="store_true",
                    help="also print the raw result dict as JSON")
    pp.add_argument("--tease", type=float, default=None,
                    help="price as a teaser: shift every spread/total leg "
                         "this many points in the bettor's favor "
                         "(moneyline/prop legs are refused)")
    pp.add_argument("--corr", action="store_true",
                    help="also print the pairwise leg win-indicator "
                         "correlation matrix (same trial sample)")
    pp.add_argument("--rr", default=None, metavar="K[,K...]",
                    help="also price the round robin: every K-leg "
                         "combination as its own ticket off the same "
                         "trials (e.g. --rr 2 or --rr 2,3)")
    pp.set_defaults(fn=_cmd_parlay)

    pe = sub.add_parser("edges", help="betting edges over saved sims")
    pe.add_argument("--base", default=None)
    pe.add_argument("--team-a", required=True)
    pe.add_argument("--team-b", required=True)
    pe.add_argument("--spread", type=float, default=None)
    pe.add_argument("--total", type=float, default=None)
    pe.add_argument("--props", default=None)
    pe.add_argument("--dir", default=".")
    pe.add_argument("--device", action="store_true",
                    help="simulate + reduce on the accelerator (no files)")
    pe.add_argument("--sp", default=None, help="SP+ csv (with --device)")
    pe.add_argument("-n", type=int, default=65536,
                    help="pairs (with --device); large market-only scans "
                         "round n UP to whole 32768-pair launches so every "
                         "launch shares one compiled shape — the printed "
                         "game count is the true number simulated")
    pe.add_argument("--year", type=int, default=2025)
    pe.add_argument("--week", type=int, default=1)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--mode", default="table")
    pe.add_argument("--quality", default="nano")
    pe.add_argument("--focus", default=None)
    pe.add_argument("--shard", action="store_true",
                    help="with --device: shard the trial axis over all "
                         "devices (per-device moments + one psum)")
    pe.add_argument("--alt", action="store_true",
                    help="print alternate spread/total ladders around the "
                         "quoted lines (same distribution, zero extra sim)")
    pe.add_argument("--alt-width", type=float, default=12.0,
                    help="ladder half-width in points (default 12)")
    pe.add_argument("--alt-step", type=float, default=1.0,
                    help="ladder step in points (default 1)")
    pe.add_argument("--mid-spread", default=None, metavar="TEAM_LINE,OPP_LINE",
                    help="price a spread middle: hold team-a at the first "
                         "line and team-b at the second (negative first "
                         "lines need the = form: --mid-spread=-3.5,7.5)")
    pe.add_argument("--mid-total", default=None, metavar="OVER,UNDER",
                    help="price a total middle: Over the first line and "
                         "Under the second (e.g. 51.5,57.5)")
    pe.add_argument("--artifacts", default="seeded:0")
    pe.set_defaults(fn=_cmd_edges)

    pr = sub.add_parser(
        "prop", help="price one player prop off saved sims")
    pr.add_argument("team")
    pr.add_argument("player")
    pr.add_argument("stat", help="e.g. pass_yds / rush_yds / rec_yds / INT")
    pr.add_argument("line", type=float)
    pr.add_argument("--base", default=None,
                    help="saved-sim base name (players_<base> table)")
    pr.add_argument("--dir", default=".")
    pr.add_argument("--role", default=None,
                    help="qb/rush/target (default: inferred from the stat)")
    pr.add_argument("--ladder", action="store_true",
                    help="print the alternate-line ladder around the quote "
                         "(same samples, zero extra sim)")
    pr.add_argument("--width", type=float, default=None,
                    help="ladder half-width (default by stat family)")
    pr.add_argument("--step", type=float, default=None,
                    help="ladder step (default by stat family)")
    pr.add_argument("--price", type=int, default=-110)
    pr.set_defaults(fn=_cmd_prop)

    pl = sub.add_parser("slate", help="simulate a slate of matchups")
    pl.add_argument("--games", required=True, help="csv with team_a,team_b columns")
    pl.add_argument("--sp", required=True)
    pl.add_argument("-n", type=int, default=1000)
    pl.add_argument("--year", type=int, default=2025)
    pl.add_argument("--week", type=int, default=1)
    pl.add_argument("--mode", default="table")
    pl.add_argument("--quality", default="nano")
    pl.add_argument("--shard", default="none",
                    choices=["none", "trial", "game"],
                    help="multi-device slate: 'trial' shards each "
                         "matchup's trial axis over the mesh (recommended);"
                         " 'game' gives each device its own matchups' "
                         "tables (for memory-bound table sets)")
    pl.add_argument("--batched", action="store_true",
                    help="run the whole slate as one compiled program "
                         "(('game','trial') layout)")
    pl.add_argument("--lines", default=None,
                    help="csv of market lines (team_a[,team_b],spread,"
                         "total; spread from team_a's perspective): prints "
                         "per-matchup spread/total/moneyline edges priced "
                         "off the device summaries (routes the unsharded "
                         "default through the summary sweep)")
    pl.add_argument("--props", default=None,
                    help="prop sheet csv (team,player,stat,yards): scans "
                         "the whole slate's player props with per-matchup "
                         "player-collection sims reduced on device "
                         "(separate from the score-only slate sims above)")
    pl.add_argument("--props-n", type=int, default=8192, dest="props_n",
                    help="pairs per matchup for the prop sims")
    pl.add_argument("--min-edge", type=float, default=2.0, dest="min_edge",
                    help="min |edge| %% to show a prop (reference: 2)")
    pl.add_argument("--focus", default=None,
                    help="focus players csv for prop rosters")
    pl.add_argument("--artifacts", default="seeded:0")
    pl.set_defaults(fn=_cmd_slate)

    pn = sub.add_parser(
        "season", help="season win-total projection (exact Poisson-"
                       "binomial over per-game slate sims)")
    pn.add_argument("team")
    pn.add_argument("--opponents", default=None,
                    help="comma-separated opponent names (team takes "
                         "side A in every matchup)")
    pn.add_argument("--games", default=None,
                    help="csv with team_a,team_b columns; team must "
                         "appear in every row")
    pn.add_argument("--sp", required=True, help="SP+ csv path")
    pn.add_argument("--line", type=float, default=None,
                    help="season win-total quote, e.g. 8.5")
    pn.add_argument("-n", type=int, default=50000, help="PAIRS per matchup")
    pn.add_argument("--year", type=int, default=2025)
    pn.add_argument("--week", type=int, default=1)
    pn.add_argument("--seed", type=int, default=0)
    pn.add_argument("--mode", default="table")
    pn.add_argument("--quality", default="nano")
    pn.add_argument("--artifacts", default="seeded:0")
    pn.add_argument("--shard", action="store_true",
                    help="shard each matchup's trial axis over the mesh")
    pn.set_defaults(fn=_cmd_season)

    pk = sub.add_parser(
        "backtest", help="score the sim against actual finals "
                         "(calibration, accuracy, PIT)")
    pk.add_argument("--results", required=True,
                    help="csv of finals: team_a,team_b,score_a,score_b "
                         "(either orientation)")
    pk.add_argument("--games", default=None,
                    help="optional csv of matchups to simulate (default: "
                         "the results rows themselves)")
    pk.add_argument("--sp", required=True,
                    help="SP+ csv AS OF the games' week (pregame ratings "
                         "— postgame ratings would leak the outcomes)")
    pk.add_argument("-n", type=int, default=32768, help="PAIRS per matchup")
    pk.add_argument("--bins", type=int, default=10,
                    help="reliability-table probability bins")
    pk.add_argument("--year", type=int, default=2025)
    pk.add_argument("--week", type=int, default=1)
    pk.add_argument("--seed", type=int, default=0)
    pk.add_argument("--mode", default="table")
    pk.add_argument("--quality", default="nano")
    pk.add_argument("--artifacts", default="seeded:0")
    pk.add_argument("--shard", action="store_true",
                    help="shard each matchup's trial axis over the mesh")
    pk.set_defaults(fn=_cmd_backtest)

    pb = sub.add_parser("bench", help="run the benchmark harness")
    pb.add_argument("--mode", default="table")
    pb.add_argument("-n", type=int, default=100000)
    pb.set_defaults(fn=_cmd_bench)

    pt = sub.add_parser("train", help="train model heads from a plays csv")
    pt.add_argument("--data", required=True, help="ml_*-style plays csv")
    pt.add_argument("--out", required=True, help="artifact output directory")
    pt.add_argument("--heads", default="stage1,stage2,fumble,play",
                    help="comma list: stage1,stage2,fumble,play,pass,run,sack")
    pt.add_argument("--multiclass", action="store_true",
                    help="5-class play model (default binary run/pass)")
    pt.add_argument("--trees", type=int, default=400,
                    help="n_estimators for the quantile heads")
    pt.set_defaults(fn=_cmd_train)

    pv = sub.add_parser(
        "serve", help="resident HTTP service (warm heads/tables/programs)")
    pv.add_argument("--sp", required=True, help="SP+ csv path")
    pv.add_argument("--artifacts", default="seeded:0")
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8787)
    pv.add_argument("--year", type=int, default=2025)
    pv.add_argument("--week", type=int, default=1)
    pv.add_argument("--mode", default="table")
    pv.add_argument("--quality", default="nano")
    pv.add_argument("--focus", default=None)
    pv.add_argument("--shard", action="store_true",
                    help="default requests to trial-sharded launches")
    pv.add_argument("--warm", default=None,
                    help="games csv to pre-compile against at startup")
    pv.add_argument("--max-pairs", type=int, default=2_000_000,
                    dest="max_pairs", help="per-request n_pairs ceiling")
    pv.add_argument("--max-games", type=int, default=80, dest="max_games",
                    help="per-request slate size ceiling")
    pv.add_argument("--deadline", type=float, default=None,
                    help="per-request admission deadline (seconds): shed "
                         "requests with 503 when queue wait exceeds it "
                         "(omit or <=0: never shed)")
    pv.add_argument("--aot", default=None, metavar="DIR",
                    help="AOT executable snapshot dir: first compile of "
                         "each launch program is snapshotted here and "
                         "every later process boot loads it instead of "
                         "compiling (wipe the dir on library upgrades)")
    pv.set_defaults(fn=_cmd_serve)

    args = p.parse_args(argv)
    _enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
