"""The resident HTTP serving layer (serve.py): routing, JSON contract,
warm-state reuse, and error surfaces — all through a real ThreadingHTTPServer
on a loopback port (analytic mode keeps each request sub-second on CPU)."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest


@pytest.fixture(scope="module")
def server(reference_dir):
    from fast_monte_carlo.serve import ServeConfig, SimService, make_server

    cfg = ServeConfig(sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
                      artifact_dir=str(reference_dir), mode="analytic",
                      max_n_pairs=4096, max_games=2)
    service = SimService(cfg)
    srv = make_server(service, port=0)  # free port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(server):
    base, _ = server
    code, out = _get(base + "/health")
    assert code == 200
    assert out["status"] == "ok"
    assert out["device_count"] >= 1
    assert out["config"]["mode"] == "analytic"


def test_sim_with_markets(server):
    base, _ = server
    code, out = _post(base + "/sim", {
        "team_a": "Kansas State", "team_b": "Iowa State",
        "n_pairs": 256, "spread": -3.5, "total": 55.5})
    assert code == 200, out
    s = out["summary"]
    assert s["team_a"] == "Kansas State" and s["n_games"] == 512
    assert 0.0 < s["win_a"] < 1.0
    ml = out["moneyline"]
    assert ml["team"]["p_win"] + ml["opp"]["p_win"] <= 1.0 + 1e-9
    mk = out["markets"]
    # both quoted markets priced; surviving a JSON round-trip already
    # proves every leaf is a plain python scalar
    assert {"spread", "total"} <= set(mk)
    assert isinstance(mk["spread"], dict) and isinstance(mk["total"], dict)


def test_sim_alt_ladders(server):
    base, _ = server
    code, out = _post(base + "/sim", {
        "team_a": "Kansas State", "team_b": "Iowa State",
        "n_pairs": 256, "spread": -3.5, "total": 55.5,
        "alt": {"width": 3, "step": 1}})
    assert code == 200, out
    alt = out["alt"]
    assert {"spread", "total"} <= set(alt)
    assert len(alt["spread"]) == 7 and len(alt["total"]) == 7
    # the quoted line's ladder row agrees with the main market row
    mk = out["markets"]
    mid = next(r for r in alt["spread"] if r["spread"] == -3.5)
    assert mid["p_cover"] == pytest.approx(mk["spread"]["p_cover"])
    covers = [r["p_cover"] for r in alt["spread"]]
    assert covers == sorted(covers)  # more points = easier cover


def test_sim_alt_ladder_cap_is_400(server):
    base, _ = server
    code, out = _post(base + "/sim", {
        "team_a": "Kansas State", "team_b": "Iowa State",
        "n_pairs": 256, "spread": -3.5,
        "alt": {"width": 500, "step": 0.5}})
    assert code == 400
    assert "capped" in out["error"]


def test_slate_with_lines(server):
    base, _ = server
    code, out = _post(base + "/slate", {
        "games": [["Kansas State", "Iowa State"], ["Texas", "Ohio State"]],
        "n_pairs": 256,
        "lines": [{"team_a": "Kansas State", "spread": -3.5, "total": 55.5}]})
    assert code == 200, out
    assert len(out["summaries"]) == 2
    assert len(out["markets"]) == 2
    row = out["markets"][0]
    assert row["team_a"] == "Kansas State"
    assert np.isfinite(row["p_win_a"])
    assert out["elapsed_s"] > 0


def test_warm_state_reused_across_requests(server):
    """Repeat requests must hit the warm path: the resident heads memo and
    device-table caches persist across requests (the whole point of the
    serving shape vs the reference's process-per-question loop)."""
    base, service = server
    _post(base + "/sim", {"team_a": "Kansas State", "team_b": "Iowa State",
                          "n_pairs": 256})
    code, h = _get(base + "/health")
    assert code == 200
    assert h["heads_memo"] >= 1
    assert h["requests"] >= 2
    assert service._requests == h["requests"]


def test_props_inline_rows(server):
    base, _ = server
    code, out = _post(base + "/props", {
        "games": [["Kansas State", "Iowa State"]],
        "n_pairs": 128,
        "props": [{"team": "Kansas State", "player": "Unknown",
                   "pos": "QB", "stat": "pass_yards", "yards": 210.5}]})
    assert code == 200, out
    assert isinstance(out["props"], list)


def test_live_endpoint(server):
    """In-game win probability over the wire: quarter/clock sugar, live
    market pricing, and the input guards."""
    base, _ = server
    body = {"team_a": "Kansas State", "team_b": "Iowa State",
            "offense": "B", "quarter": 4, "clock": "07:00", "down": 2,
            "dist": 7, "ytg": 35, "score_a": 21, "score_b": 17,
            "n_games": 512, "spread": -3.5, "total": 55.5}
    code, out = _post(base + "/live", body)
    assert code == 200, out
    row = out["live"]
    assert row["n_games"] == 512
    assert row["offense"] == 1 and row["sec"] == 7 * 60
    assert 0.0 <= row["win_a"] <= 1.0
    assert row["mean_a"] >= 21.0 and row["mean_b"] >= 17.0
    assert {"spread", "total"} <= set(out["markets"])
    assert out["moneyline"]["team"]["name"] == "Kansas State"
    # explicit sec beats quarter/clock; repeat states answer warm
    code, out2 = _post(base + "/live", {**body, "sec": 420})
    assert code == 200 and out2["live"]["sec"] == 420
    # guards: bad offense / quarter / n_games
    for bad in ({"offense": "C"}, {"quarter": 5, "clock": "1:00"},
                {"n_games": 10**9}, {"ytg": 0}):
        code, err = _post(base + "/live", {**body, **bad})
        assert code == 400, (bad, err)


def test_parlay_endpoint(server):
    """Same-game parlay pricing over the wire + its guards."""
    base, _ = server
    body = {"team_a": "Kansas State", "team_b": "Iowa State",
            "n_pairs": 256, "price": 260,
            "legs": [{"kind": "moneyline", "team": "Kansas State"},
                     {"kind": "total", "side": "over", "line": 49.5}]}
    code, out = _post(base + "/parlay", {**body, "correlations": True})
    assert code == 200, out
    res = out["parlay"]
    assert res["n"] == 512
    assert len(res["leg_corr"]) == 2  # 2x2 matrix, JSON records
    assert 0.0 <= res["p_all_win"] <= min(
        leg["p_win"] for leg in res["legs"]) + 1e-9
    assert {"fair_american", "correlation_mult", "ev_$100"} <= set(res)
    # guards: empty/oversized legs, unknown team, unknown kind
    for bad_legs in ([], [{"kind": "moneyline", "team": "KSU"}] * 21,
                     [{"kind": "moneyline", "team": "Ohio State"}],
                     [{"kind": "teaser", "team": "Kansas State"}],
                     ["moneyline"]):  # JSON string, not an object -> 400
        code, err = _post(base + "/parlay", {**body, "legs": bad_legs})
        assert code == 400, (bad_legs, err)
    # round robin rides the same request (priced card, JSON-clean)
    code, out = _post(base + "/parlay", {**body, "round_robin": [1, 2]})
    assert code == 200, out
    rr = out["parlay"]["round_robin"]
    assert rr["n_tickets"] == 3 and rr["by"] == [1, 2]
    assert all("ev_$100" in t for t in rr["tickets"])  # price applied
    # bad size specs are 400s, not 500s; JSON true (bool ⊂ int) and
    # non-integral floats are rejected rather than silently coerced
    for bad_rr in ("2", [0], [9], True, [2.5], [], [2, True]):
        code, err = _post(base + "/parlay", {**body, "round_robin": bad_rr})
        assert code == 400, (bad_rr, err)


def test_season_endpoint(server):
    """Season win-total projection over the wire + its guards."""
    base, _ = server
    body = {"team": "Kansas State",
            "opponents": ["Iowa State", "Kansas"],
            "n_pairs": 256, "line": 1.5}
    code, out = _post(base + "/season", body)
    assert code == 200, out
    res = out["season"]
    assert res["games"] == 2 and len(res["pmf"]) == 3
    assert abs(sum(res["pmf"]) - 1.0) < 1e-6
    assert res["p_at_least"][0] == 1.0
    assert {"p_over", "p_under", "american_over", "best"} <= set(res)
    assert len(res["schedule"]) == 2
    assert [r["p_win_team"] for r in res["schedule"]] == res["p_wins"]
    # guards: missing team, both/neither schedule forms, oversize list,
    # team absent from a games row
    code, err = _post(base + "/season", {"opponents": ["Kansas"]})
    assert code == 400 and "team" in err["error"]
    code, err = _post(base + "/season", {"team": "Kansas State"})
    assert code == 400
    code, err = _post(base + "/season", {
        **body, "games": [["Kansas State", "Kansas"]]})
    assert code == 400
    code, err = _post(base + "/season",
                      {**body, "opponents": ["a", "b", "c"]})
    assert code == 400 and "opponents" in err["error"]
    code, err = _post(base + "/season", {
        "team": "Kansas State", "n_pairs": 64,
        "games": [["Texas", "Ohio State"]]})
    assert code == 400 and "include" in err["error"]


def test_bad_body_and_unknown_route(server):
    base, _ = server
    code, out = _post(base + "/slate", {"n_pairs": 64})  # missing games
    assert code == 400 and "error" in out
    code, out = _post(base + "/nope", {})
    assert code == 404
    # oversize n_pairs rejected by the per-request guard
    code, out = _post(base + "/sim", {
        "team_a": "Kansas State", "team_b": "Iowa State", "n_pairs": 10**9})
    assert code == 400 and "n_pairs" in out["error"]


def test_request_cost_guards(server):
    """A request must not be able to escalate its own cost: mode overrides
    outside {configured, analytic} and oversized games lists are rejected
    before any simulation."""
    base, _ = server
    # mode='exact' would hold the service lock for a long time
    code, out = _post(base + "/sim", {
        "team_a": "Kansas State", "team_b": "Iowa State",
        "n_pairs": 64, "mode": "exact"})
    assert code == 400 and "mode" in out["error"]
    # games list past max_games (fixture: 2) — each matchup builds tables
    code, out = _post(base + "/slate", {
        "games": [["A", "B"], ["C", "D"], ["E", "F"]], "n_pairs": 64})
    assert code == 400 and "games list" in out["error"]


def test_sim_sharded_over_mesh(server):
    """shard=true requests route each launch through the trial-sharded
    shard_map path (8-device CPU mesh from conftest) and must agree with
    the health/JSON contract."""
    base, _ = server
    code, out = _post(base + "/sim", {
        "team_a": "Kansas State", "team_b": "Iowa State",
        "n_pairs": 256, "shard": True})
    assert code == 200, out
    assert out["summary"]["n_games"] >= 512  # whole-launch round-up allowed
    assert 0.0 < out["summary"]["win_a"] < 1.0


def test_concurrent_requests_serialize_cleanly(server):
    """The service lock serializes device work; concurrent clients must
    both succeed (queued), not error or interleave."""
    import concurrent.futures as cf

    base, _ = server
    body = {"team_a": "Kansas State", "team_b": "Iowa State", "n_pairs": 128}
    with cf.ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(lambda i: _post(base + "/sim", {**body, "seed": i}),
                           range(4)))
    for code, out in outs:
        assert code == 200
        assert 0.0 < out["summary"]["win_a"] < 1.0


def test_warm_precompiles(server):
    """service.warm(games) runs a tiny slate so the first real request
    skips table builds and program compiles."""
    base, service = server
    out = service.warm([("Kansas State", "Iowa State")], n_pairs=32)
    assert out["heads"] == "loaded"
    assert "1 matchups" in out["compiled"]


@pytest.mark.slow
@pytest.mark.skipif("FMC_SOAK" not in __import__("os").environ,
                    reason="serving soak is opt-in (FMC_SOAK=1)")
def test_serving_soak_no_unbounded_growth(server):
    """100 requests across rotating matchups: memo caches stay inside
    their FIFO caps and host RSS growth stays bounded — the leak class
    the resident-process design must not have."""
    import resource

    base, _ = server
    teams = ["Kansas State", "Iowa State", "Texas", "Ohio State", "Georgia"]
    _post(base + "/sim", {"team_a": teams[0], "team_b": teams[1],
                          "n_pairs": 128})  # warm before baselining RSS
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    for i in range(100):
        a, b = teams[i % len(teams)], teams[(i + 1) % len(teams)]
        code, out = _post(base + "/sim", {"team_a": a, "team_b": b,
                                          "n_pairs": 128, "seed": i})
        assert code == 200, out
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    code, h = _get(base + "/health")
    from fast_monte_carlo.models.heads import _HEADS_MEMO_MAX
    assert h["heads_memo"] <= _HEADS_MEMO_MAX
    assert h["device_tables"] <= 128  # _DEVICE_TABLE_CACHE_MAX
    # ru_maxrss is KB on Linux; allow 256MB of growth for jit caches
    assert rss1 - rss0 < 256 * 1024, (rss0, rss1)


def test_jsonable_handles_numpy_and_nan():
    import pandas as pd

    from fast_monte_carlo.serve import jsonable

    out = jsonable({"a": np.float32(1.5), "b": np.int64(2),
                    "c": float("nan"), "d": np.array([1.0, 2.0]).tolist(),
                    "e": pd.DataFrame({"x": [np.nan, 1.0]})})
    assert out == {"a": 1.5, "b": 2, "c": None, "d": [1.0, 2.0],
                   "e": [{"x": None}, {"x": 1.0}]}
    json.dumps(out)  # must be encodable


def test_live_curve_endpoint(server):
    """Batch form of /live: S situations priced in one launch."""
    base, _ = server
    body = {"team_a": "Kansas State", "team_b": "Iowa State",
            "n_games_per": 256,
            "situations": [
                {"offense": "A", "sec": 2400, "ytg": 75, "score_a": 7,
                 "score_b": 7},
                {"offense": "B", "quarter": 4, "clock": "05:00", "down": 3,
                 "dist": 4, "ytg": 55, "score_a": 14, "score_b": 17},
            ]}
    code, out = _post(base + "/live", body)
    assert code == 200, out
    curve = out["curve"]
    assert len(curve) == 2
    assert curve[0]["sec"] == 2400 and curve[1]["sec"] == 300
    for row in curve:
        assert row["n_games"] == 256
        assert 0.0 <= row["win_a"] <= 1.0
    # guards: empty list, batch budget
    for bad in ({"situations": []},
                {"situations": body["situations"], "n_games_per": 10**8}):
        code, err = _post(base + "/live", {**body, **bad})
        assert code == 400, (bad, err)


@pytest.mark.slow   # four forced-choice launches; ~1.5 min standalone
def test_fourth_endpoint(server):
    """4th-down decision chart over the wire."""
    base, _ = server
    body = {"team_a": "Kansas State", "team_b": "Iowa State",
            "offense": "A", "quarter": 4, "clock": "04:00", "dist": 2,
            "ytg": 30, "score_a": 20, "score_b": 21, "n_games": 512}
    code, out = _post(base + "/fourth", body)
    assert code == 200, out
    res = out["fourth"]
    assert set(res["choices"]) == {"policy", "go", "fg", "punt"}
    assert res["best"] in ("go", "fg", "punt")
    assert res["situation"]["down"] == 4
    # guards: non-4th down, n_games budget
    for bad in ({"down": 2}, {"n_games": 10**9}):
        code, err = _post(base + "/fourth", {**body, **bad})
        assert code == 400, (bad, err)


def test_deadline_guard_and_latency(reference_dir):
    """Admission deadline: a request queued behind the device lock past
    cfg.deadline_s is shed with 503 BEFORE any device work; /health
    reports per-endpoint p50/p95 latency off completed requests only."""
    import time

    from fast_monte_carlo.serve import ServeConfig, SimService, make_server

    cfg = ServeConfig(sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
                      artifact_dir=str(reference_dir), mode="analytic",
                      max_n_pairs=4096, max_games=2, deadline_s=0.2)
    service = SimService(cfg)
    srv = make_server(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        body = {"team_a": "Kansas State", "team_b": "Iowa State",
                "n_pairs": 64}
        code, out = _post(base + "/sim", body)
        assert code == 200, out
        n_ok = service._requests
        with service._lock:   # simulate a long-running device request
            t0 = time.perf_counter()
            code, err = _post(base + "/sim", body)
            waited = time.perf_counter() - t0
        assert code == 503 and "deadline" in err["error"]
        assert 0.15 <= waited < 5.0          # shed at ~deadline, not hang
        assert service._requests == n_ok     # shed before device work
        code, h = _get(base + "/health")
        assert code == 200
        lat = h["latency"]["sim"]
        assert lat["n"] == 1                 # only the completed request
        assert lat["p95_ms"] >= lat["p50_ms"] > 0
    finally:
        srv.shutdown()
        srv.server_close()


def _wait_for_waiters(service, n, timeout=30.0):
    """Poll until n requests have registered in open /sim batches."""
    import time as _time
    t0 = _time.perf_counter()
    while _time.perf_counter() - t0 < timeout:
        with service._batch_lock:
            got = sum(it.waiters for b in service._sim_batches.values()
                      for it in b.items.values())
        if got >= n:
            return got
        _time.sleep(0.02)
    raise AssertionError(f"only {got}/{n} requests registered")


def _patched_slate_counter():
    import fast_monte_carlo.api as api
    calls = []
    real = api.simulate_slate_summaries

    def counted(games, *a, **k):
        calls.append(tuple(games))
        return real(games, *a, **k)

    return api, real, counted, calls


def test_sim_coalescing_identical_requests(server):
    """Concurrent IDENTICAL /sim requests share ONE device launch
    (VERDICT r4 #4): with the device lock held, four arrivals pile into
    one batch; on release one slate launch answers all four with
    identical summaries."""
    base, service = server
    api, real, counted, calls = _patched_slate_counter()
    body = {"team_a": "Kansas State", "team_b": "Iowa State",
            "n_pairs": 128, "seed": 77}
    outs = [None] * 4

    def go(i):
        outs[i] = _post(base + "/sim", body)

    api.simulate_slate_summaries = counted
    service._lock.acquire()
    held = True
    try:
        ts = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        _wait_for_waiters(service, 4)
        service._lock.release()
        held = False
        for t in ts:
            t.join(timeout=120)
        assert [o[0] for o in outs] == [200] * 4, outs
        sums = [o[1]["summary"] for o in outs]
        assert all(s == sums[0] for s in sums)
        assert calls == [(("Kansas State", "Iowa State"),)]  # ONE launch
        _, h = _get(base + "/health")
        assert h["coalesced"] >= 3
    finally:
        if held:
            service._lock.release()
        api.simulate_slate_summaries = real


def test_sim_coalescing_distinct_matchups_batch_into_slate(server):
    """Distinct queued matchups in the same (n, mode, shard, seed) group
    answer from ONE slate launch carrying both games."""
    base, service = server
    api, real, counted, calls = _patched_slate_counter()
    bodies = [{"team_a": "Kansas State", "team_b": "Iowa State",
               "n_pairs": 128, "seed": 78},
              {"team_a": "Alabama", "team_b": "Georgia",
               "n_pairs": 128, "seed": 78}]
    outs = [None] * 2

    def go(i):
        outs[i] = _post(base + "/sim", bodies[i])

    api.simulate_slate_summaries = counted
    service._lock.acquire()
    held = True
    try:
        ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        _wait_for_waiters(service, 2)
        service._lock.release()
        held = False
        for t in ts:
            t.join(timeout=120)
        assert [o[0] for o in outs] == [200] * 2, outs
        assert outs[0][1]["summary"]["team_a"] == "Kansas State"
        assert outs[1][1]["summary"]["team_a"] == "Alabama"
        assert len(calls) == 1 and set(calls[0]) == {
            ("Kansas State", "Iowa State"), ("Alabama", "Georgia")}
    finally:
        if held:
            service._lock.release()
        api.simulate_slate_summaries = real


def test_sim_batch_bad_matchup_fails_alone(server):
    """One unknown team in a coalesced batch must NOT fail its
    batch-mates: the leader falls back to per-matchup launches and each
    request sees only its own outcome (old /sim semantics)."""
    base, service = server
    bodies = [{"team_a": "Kansas State", "team_b": "Iowa State",
               "n_pairs": 128, "seed": 79},
              {"team_a": "Nowhere University", "team_b": "Iowa State",
               "n_pairs": 128, "seed": 79}]
    outs = [None] * 2

    def go(i):
        outs[i] = _post(base + "/sim", bodies[i])

    service._lock.acquire()
    held = True
    try:
        ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        _wait_for_waiters(service, 2)
        service._lock.release()
        held = False
        for t in ts:
            t.join(timeout=120)
        by_team = {b["team_a"]: o for b, o in zip(bodies, outs)}
        assert by_team["Kansas State"][0] == 200, by_team
        assert by_team["Nowhere University"][0] in (400, 500)
    finally:
        if held:
            service._lock.release()


def test_sim_coalescing_deadline_sheds_followers(reference_dir):
    """The admission deadline bounds a follower's wait too: with the
    device lock held past deadline_s, queued identical requests shed 503
    instead of hanging, and the service keeps answering afterwards."""
    import time as _time

    from fast_monte_carlo.serve import ServeConfig, SimService, make_server

    cfg = ServeConfig(sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
                      artifact_dir=str(reference_dir), mode="analytic",
                      max_n_pairs=4096, deadline_s=0.6)
    service = SimService(cfg)
    srv = make_server(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        body = {"team_a": "Kansas State", "team_b": "Iowa State",
                "n_pairs": 64}
        outs = [None] * 2

        def go(i):
            outs[i] = _post(base + "/sim", body)

        service._lock.acquire()
        try:
            ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
            for t in ts:
                t.start()
            _wait_for_waiters(service, 2)
            _time.sleep(1.0)    # past the 0.6s deadline
        finally:
            service._lock.release()
        for t in ts:
            t.join(timeout=60)
        assert [o[0] for o in outs] == [503, 503], outs
        code, out = _post(base + "/sim", body)   # lock free: serves again
        assert code == 200, out
    finally:
        srv.shutdown()
        srv.server_close()


def test_sim_calibration_body_field(server):
    """Opt-in market calibration through the /sim body: total_shift moves
    the priced total market; bad fields 400."""
    base, _ = server
    body = {"team_a": "Kansas State", "team_b": "Iowa State",
            "n_pairs": 256, "spread": -3.5, "total": 44.5, "seed": 5}
    code, plain = _post(base + "/sim", body)
    assert code == 200, plain
    code, calib = _post(base + "/sim",
                        {**body, "calibration": {"total_shift": -10.0}})
    assert code == 200, calib
    assert calib["markets"]["total"]["mean_total"] == pytest.approx(
        plain["markets"]["total"]["mean_total"] - 10.0, abs=1e-6)
    assert calib["markets"]["total"]["p_over"] \
        < plain["markets"]["total"]["p_over"]
    # margin untouched when only the total shifts
    assert calib["markets"]["spread"]["p_cover"] == \
        plain["markets"]["spread"]["p_cover"]
    assert calib["moneyline"] == plain["moneyline"]
    # the alt ladder honors the same calibration: its row AT the quoted
    # total matches the calibrated main market (rows can never disagree)
    code, out = _post(base + "/sim",
                      {**body, "alt": {"width": 2, "step": 1},
                       "calibration": {"total_shift": -10.0}})
    assert code == 200, out
    row = [r for r in out["alt"]["total"]
           if r["total"] == pytest.approx(44.5)][0]
    assert row["p_over"] == pytest.approx(
        out["markets"]["total"]["p_over"], abs=1e-9)
    code, out = _post(base + "/sim", {**body, "calibration": {"nope": 1}})
    assert code == 400 and "unknown calibration fields" in out["error"]
    code, out = _post(base + "/sim",
                      {**body, "calibration": {"total_scale": -1}})
    assert code == 400


def test_live_single_flight_identical_requests(server):
    """Identical concurrent /live requests share ONE device computation
    (generic single-flight; the live-polling pattern), and the shared
    answer equals what each would have computed alone."""
    import fast_monte_carlo.api as api
    base, service = server
    body = {"team_a": "Kansas State", "team_b": "Iowa State",
            "offense": "B", "quarter": 4, "clock": "06:30", "down": 2,
            "dist": 7, "ytg": 35, "score_a": 21, "score_b": 17,
            "n_games": 512, "seed": 91}
    calls = []
    real = api.simulate_live_game

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    api.simulate_live_game = counted
    outs = [None] * 3

    def go(i):
        outs[i] = _post(base + "/live", body)

    service._lock.acquire()
    held = True
    try:
        ts = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        # wait until all three registered on the in-flight entry
        import time as _time
        t0 = _time.perf_counter()
        while _time.perf_counter() - t0 < 30:
            with service._batch_lock:
                if sum(it.waiters for it in service._inflight.values()) >= 3:
                    break
            _time.sleep(0.02)
        service._lock.release()
        held = False
        for t in ts:
            t.join(timeout=120)
        assert [o[0] for o in outs] == [200] * 3, outs
        rows = [o[1]["live"] for o in outs]
        assert rows[1] == rows[0] and rows[2] == rows[0]
        assert len(calls) == 1                      # ONE launch for three
        # solo request with a different body computes separately
        code, solo = _post(base + "/live", {**body, "seed": 92})
        assert code == 200 and len(calls) == 2
    finally:
        if held:
            service._lock.release()
        api.simulate_live_game = real
