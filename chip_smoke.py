#!/usr/bin/env python3
"""Smoke run of the simulator's main path on a GPU, through its entry points.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --multi   # four cards: the sharded paths only

Inputs are the seeded artifact set (``seeded:0``: heads at the published
shapes, a 137-team SP+ sheet).  Phases on one card:

  main       table mode, nano tables, rbg, score-only: 1,048,576 games
             through MatchupRunner.run_pairs_summary in 65,536-game launches
  reference  the same program on the CPU backend in this process (16,384
             games) agrees with the card within 4 sigma
  precision  nano_select 'dot' and 'chain' give bitwise-equal scores
  exact      exact mode (per-play forest walks) agrees with table mode
  serve      serve.SimService behind a ThreadingHTTPServer answers /sim,
             /live and /slate

Each phase prints its seconds and key numbers; any failed check raises and
the script exits non-zero.  Without a GPU it exits non-zero before any
phase runs.  The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.request

SEEDED = "seeded:0"
TEAMS = ("Team 030", "Team 041")
SLATE = (("Team 001", "Team 002"), ("Team 010", "Team 020"),
         ("Team 050", "Team 060"), ("Team 100", "Team 120"))

# games per phase; a rehearsal on the CPU may shrink them
SIZES = dict(main=1 << 20, chunk=1 << 16, cpu=1 << 14, precision=1 << 16,
             exact=1024, exact_table=1 << 14, serve_pairs=1 << 15,
             slate_pairs=1 << 14, multi=1 << 20)


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Env:
    """Seeded inputs shared by the phases."""

    def __init__(self):
        from fast_monte_carlo.config import SimConfig
        from fast_monte_carlo.data import (
            build_team_context_from_sp_flex, load_sp_flex,
        )
        from fast_monte_carlo.models.heads import load_heads

        self.sp = load_sp_flex(SEEDED)
        self.a, self.b = (build_team_context_from_sp_flex(t, 2025, 1, self.sp)
                          for t in TEAMS)
        self.heads = load_heads(SEEDED)
        self.cfg = SimConfig()                         # threefry
        self.cfg_rbg = self.engine(rng_impl="rbg")

    def engine(self, **kw):
        return self.cfg.replace(engine=dataclasses.replace(self.cfg.engine,
                                                           **kw))

    def runner(self, cfg, mode="table", swap=False, **kw):
        from fast_monte_carlo.api import MatchupRunner

        a, b = (self.b, self.a) if swap else (self.a, self.b)
        return MatchupRunner(a, b, self.heads, cfg, mode=mode,
                             table_quality="nano", **kw)


def _np(x):
    import numpy as np

    return np.asarray(x, dtype=float)


def summary_numbers(s) -> dict:
    return {"n": int(_np(s.n)), "win": _np(s.win_rate).round(4).tolist(),
            "tie": round(float(_np(s.tie_rate)), 4),
            "mean": _np(s.mean_pts).round(3).tolist(),
            "sd": _np(s.sd_pts).round(3).tolist()}


def check_summary(s, n: int, what: str) -> None:
    w, tie, mean = _np(s.win_rate), float(_np(s.tie_rate)), _np(s.mean_pts)
    check(int(_np(s.n)) == n, f"{what}: n={int(_np(s.n))}, asked {n}")
    check(abs(w.sum() + tie - 1.0) < 1e-5, f"{what}: win+tie={w.sum()+tie}")
    check(all(5.0 < m < 50.0 for m in mean) and 25.0 < mean.sum() < 90.0,
          f"{what}: mean points {mean} out of range")


def check_agree(s1, s2, what: str) -> dict:
    """Win rate and mean points of two summaries within 4 sigma of the
    two-sample difference."""
    n1, n2 = float(_np(s1.n)), float(_np(s2.n))
    w1, w2 = _np(s1.win_rate)[0], _np(s2.win_rate)[0]
    p = (w1 * n1 + w2 * n2) / (n1 + n2)
    tol_w = 4.0 * (p * (1 - p) * (1 / n1 + 1 / n2)) ** 0.5
    check(abs(w1 - w2) < tol_w,
          f"{what}: win rate {w1:.4f} vs {w2:.4f}, bound {tol_w:.4f}")
    out = {"win_diff": round(abs(w1 - w2), 5), "win_bound": round(tol_w, 5)}
    sd1, sd2 = _np(s1.sd_pts), _np(s2.sd_pts)
    for t in (0, 1):
        d = abs(_np(s1.mean_pts)[t] - _np(s2.mean_pts)[t])
        tol = 4.0 * (sd1[t] ** 2 / n1 + sd2[t] ** 2 / n2) ** 0.5
        check(d < tol, f"{what}: team {t} mean points differ by {d:.3f}, "
                       f"bound {tol:.3f}")
        out[f"mean_diff_{t}"] = round(d, 4)
        out[f"mean_bound_{t}"] = round(tol, 4)
    return out


def phase(name: str, fn, *args):
    t0 = time.perf_counter()
    res, info = fn(*args)
    info = {"seconds": round(time.perf_counter() - t0, 1), **info}
    print(f"[{name}] ok {json.dumps(info)}", flush=True)
    return res


def phase_main(env: Env, card: str):
    n, chunk = SIZES["main"], SIZES["chunk"]
    t0 = time.perf_counter()
    r = env.runner(env.cfg_rbg)
    setup_s = time.perf_counter() - t0
    # the first run compiles every program the timed run uses, including
    # the eager accumulation of moments across launches
    t0 = time.perf_counter()
    r.run_pairs_summary(n // 2, seed=1, chunk_pairs=chunk // 2)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = r.run_pairs_summary(n // 2, seed=0, chunk_pairs=chunk // 2)
    run_s = time.perf_counter() - t0
    check_summary(s, n, "main")
    return s, {"games_per_s": round(n / run_s, 1), "games": n,
               "launch_games": chunk, "run_s": round(run_s, 3),
               "setup_s": round(setup_s, 1),
               "compile_and_first_run_s": round(compile_s, 1),
               "card": card, **summary_numbers(s)}


def phase_reference(env: Env, s_gpu):
    """The same program on the CPU backend: statistics agree; with
    threefry the share of bitwise-identical games is printed."""
    import jax
    import numpy as np

    n = SIZES["cpu"]
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        s_cpu = env.runner(env.cfg_rbg).run_pairs_summary(
            n // 2, seed=2, chunk_pairs=n // 2)
        jax.block_until_ready(s_cpu)
    check_summary(s_cpu, n, "reference (cpu)")
    info = check_agree(s_gpu, s_cpu, "card vs cpu")

    def scores():
        out = env.runner(env.cfg).run_pairs(
            n // 2, seed=3, collect_players=False, collect_stats=False)
        return np.asarray(out.score)

    sc_gpu = scores()
    with jax.default_device(cpu):
        sc_cpu = scores()
    same = float((sc_gpu == sc_cpu).all(axis=1).mean())
    return None, {"cpu_games": n, **info,
                  "threefry_identical_game_share": round(same, 4)}


def phase_precision(env: Env):
    import numpy as np

    n = SIZES["precision"]
    got = {}
    for sel in ("dot", "chain"):
        out = env.runner(env.engine(nano_select=sel)).run_pairs(
            n // 2, seed=4, collect_players=False, collect_stats=False)
        got[sel] = np.asarray(out.score)
    same = bool(np.array_equal(got["dot"], got["chain"]))
    check(same, "nano_select dot and chain scores differ: "
                f"{int((got['dot'] != got['chain']).any(axis=1).sum())} "
                f"of {n} games")
    return None, {"games": n, "bitwise_equal": same}


def phase_exact(env: Env):
    """Exact mode vs table mode, held to tests/test_table_mode.py's bounds."""
    from fast_monte_carlo.stats import TS

    def run(mode, n, seed):
        r = env.runner(env.cfg, mode=mode)
        out = r.run_pairs(n // 2, seed=seed, collect_players=False)
        return _np(out.score), _np(out.stats)

    e_sc, e_st = run("exact", SIZES["exact"], 5)
    t_sc, t_st = run("table", SIZES["exact_table"], 6)
    check(not (e_st != e_st).any(), "exact mode stats hold NaN")
    info = {"exact_games": len(e_sc), "table_games": len(t_sc)}
    for c in (0, 1):
        d = abs(t_sc[:, c].mean() - e_sc[:, c].mean())
        check(d < 2.5, f"exact vs table: team {c} mean points differ {d:.2f}")
        info[f"mean_pts_{c}"] = [round(e_sc[:, c].mean(), 2),
                                 round(t_sc[:, c].mean(), 2)]
    dw = abs((t_sc[:, 0] > t_sc[:, 1]).mean() - (e_sc[:, 0] > e_sc[:, 1]).mean())
    check(dw < 0.09, f"exact vs table: win rate differs {dw:.3f}")
    info["win_diff"] = round(float(dw), 4)
    em, tm = e_st.mean(axis=0), t_st.mean(axis=0)
    for key, tol in (("plays", 3.0), ("punts", 1.0), ("INT", 0.6),
                     ("sacks", 0.7)):
        for c in (0, 1):
            d = abs(tm[c, TS[key]] - em[c, TS[key]])
            check(d < tol, f"exact vs table: {key} team {c} differ {d:.2f}")
    return None, info


def _post(base: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"{path}: HTTP {r.status}")
        return json.loads(r.read())


def phase_serve(env: Env):
    from fast_monte_carlo.serve import ServeConfig, SimService, make_server

    svc = SimService(ServeConfig(sp_path=SEEDED, artifact_dir=SEEDED,
                                 mode="table", table_quality="nano"))
    srv = make_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    ta, tb = TEAMS
    np_sim, np_slate = SIZES["serve_pairs"], SIZES["slate_pairs"]
    info = {}
    try:
        t0 = time.perf_counter()
        out = _post(base, "/sim", {"team_a": ta, "team_b": tb,
                                   "n_pairs": np_sim, "spread": -3.5,
                                   "total": 50.5})
        info["sim_s"] = round(time.perf_counter() - t0, 2)
        s = out["summary"]
        check(s["n_games"] == 2 * np_sim and 0.0 < s["win_a"] < 1.0,
              f"/sim summary {s}")
        check({"spread", "total"} <= set(out["markets"]), "/sim markets")
        t0 = time.perf_counter()
        out = _post(base, "/live", {
            "team_a": ta, "team_b": tb, "offense": "A", "quarter": 4,
            "clock": "05:00", "down": 2, "dist": 7, "ytg": 35,
            "score_a": 21, "score_b": 17, "n_games": 2 * np_sim})
        info["live_s"] = round(time.perf_counter() - t0, 2)
        live = out["live"]
        check(live["n_games"] == 2 * np_sim and live["score_a"] == 21
              and live["mean_a"] >= 21 and live["mean_b"] >= 17
              and 0.0 < live["win_a"] < 1.0, f"/live row {live}")
        info["live_win_a"] = round(live["win_a"], 4)
        t0 = time.perf_counter()
        out = _post(base, "/slate", {"games": [list(g) for g in SLATE],
                                     "n_pairs": np_slate})
        info["slate_s"] = round(time.perf_counter() - t0, 2)
        rows = out["summaries"]
        check(len(rows) == len(SLATE)
              and all(r["n_games"] == 2 * np_slate for r in rows)
              and all(0.0 < r["win_a"] < 1.0 for r in rows),
              f"/slate rows {rows}")
        info["slate_win_a"] = [round(r["win_a"], 3) for r in rows]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=60)
    return None, info


def phase_multi(env: Env, card: str):
    """Trial-sharded summaries and the game-sharded slate over four cards,
    against one card, plus the layout-determinism and uneven-split
    checks."""
    import jax
    import numpy as np

    from fast_monte_carlo.api import SlateRunner
    from fast_monte_carlo.parallel import game_mesh, simulate_moments_sharded

    devs = jax.devices()[:4]
    check(len(devs) == 4, f"--multi needs 4 devices, found {len(devs)}")
    n, chunk = SIZES["multi"], SIZES["chunk"]
    info = {"card": card}

    # every timed run follows an untimed run of the same shape, so no
    # compile lands inside the timing; each card sees `chunk`-game launches
    def timed(run):
        run(1)
        t0 = time.perf_counter()
        out = run(0)
        return out, time.perf_counter() - t0

    rs = env.runner(env.cfg_rbg, shard=True)
    s4, dt = timed(lambda seed: rs.run_pairs_summary(
        n // 2, seed=seed, chunk_pairs=2 * chunk))
    check_summary(s4, n, "sharded")
    info["sharded_games_per_s"] = round(n / dt, 1)
    r1 = env.runner(env.cfg_rbg)
    s1, dt1 = timed(lambda seed: r1.run_pairs_summary(
        n // 2, seed=10 + seed, chunk_pairs=chunk // 2))
    info["one_card_games_per_s"] = round(n / dt1, 1)
    info["sharded_vs_one"] = check_agree(s4, s1, "4 cards vs 1")

    # (seed, ndev) determinism of the sharded stream, and the uneven-n guard
    cfg_r, heads_fn = rs._resolved(False)
    fo = np.arange(chunk) % 2
    ms = [simulate_moments_sharded(rs.pack, cfg_r, heads_fn, rs.heads_state,
                                   jax.random.PRNGKey(2), chunk, fo)
          for _ in range(2)]
    check(all(np.array_equal(np.asarray(x), np.asarray(y))
              for x, y in zip(*ms)), "sharded stream is not deterministic")
    try:
        simulate_moments_sharded(rs.pack, cfg_r, heads_fn, rs.heads_state,
                                 jax.random.PRNGKey(3), chunk + 1,
                                 np.arange(chunk + 1) % 2)
    except ValueError as e:
        check("not divisible" in str(e), f"wrong uneven-n error: {e}")
    else:
        raise SmokeFailure("uneven trial count silently accepted")
    want = 3 * 4 + 1                        # neither chunk- nor mesh-even
    s3 = rs.run_pairs_summary(want, seed=5, chunk_pairs=2 * 4)
    n3 = int(_np(s3.n))
    check(n3 >= 2 * want and n3 % (2 * 4) == 0,
          f"uneven request {want} pairs ran {n3} games")
    info["uneven_request"] = [want, n3]

    # game-sharded slate: 3 matchups on 4 cards exercises the padding
    games = [(env.a, env.b), (env.a, env.b), (env.b, env.a)]
    gs = SlateRunner(games, env.heads, env.cfg_rbg, quality="nano",
                     game_shard=True)
    per = n // 8
    (df, summ), dt = timed(lambda seed: gs.run_summaries(
        per // 2, seed=seed, chunk_pairs=chunk // 2, mesh=game_mesh(devs),
        return_summaries=True))
    df2 = gs.run_summaries(per // 2, seed=0, chunk_pairs=chunk // 2,
                           mesh=game_mesh(devs))
    check((df.win_a == df2.win_a).all() and (df.mean_a == df2.mean_a).all(),
          "game-sharded slate is not deterministic")
    check(len(df) == 3 and (df.n_games == per).all(), f"slate rows {df}")
    info["slate_games_per_s"] = round(3 * per / dt, 1)
    s1_ba = env.runner(env.cfg_rbg, swap=True).run_pairs_summary(
        per // 2, seed=11, chunk_pairs=chunk // 2)
    for gi, ref in ((0, s1), (1, s1), (2, s1_ba)):
        info[f"slate_{gi}_vs_one"] = check_agree(
            summ[gi], ref, f"slate matchup {gi} vs 1 card")
    return None, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: only the sharded paths and the "
                         "one-card runs they are compared with")
    args = ap.parse_args(argv)

    import jax

    n_dev = 4 if args.multi else 1
    if jax.default_backend() != "gpu" or len(jax.devices()) < n_dev:
        print(f"chip_smoke: needs {n_dev} GPU(s); jax found "
              f"{jax.default_backend()} x{len(jax.devices())}",
              file=sys.stderr)
        return 1
    import fast_monte_carlo  # noqa: F401  (fails outside the repo)
    from fast_monte_carlo.utils.compile_cache import enable_compile_cache

    card = card_line()
    print(card, flush=True)
    print(f"jax {jax.__version__} devices {jax.devices()}", flush=True)
    print(f"compile cache {enable_compile_cache()}", flush=True)

    env = phase("setup", lambda: (Env(), {}))
    if args.multi:
        phase("multi", phase_multi, env, card)
    else:
        s = phase("main", phase_main, env, card)
        phase("reference", phase_reference, env, s)
        phase("precision", phase_precision, env)
        phase("exact", phase_exact, env)
        phase("serve", phase_serve, env)
    dev = jax.devices()[0]
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
