"""Same-game parlay pricing (edge.parlay_odds / api.simulate_parlay).

The reference's edge_finder.py prices every market from its own marginal
distribution (spread :308-313, total :321-332, props :168-231) and has no
joint-ticket capability at all; these tests pin the new joint settlement
against a pure-numpy reference implementation (hand-countable scale) and
against host-side recomputation on real sims.
"""
import json

import numpy as np
import pandas as pd
import pytest

from fast_monte_carlo.edge import parlay_odds, resolve_parlay_legs


class _Tbl:
    def __init__(self, names, tracked=None):
        self.names = list(names)
        self.tracked = [True] * len(self.names) if tracked is None else tracked


class _Ctx:
    def __init__(self, name, qb=(), rush=(), target=()):
        self.name = name
        self.qb, self.rush, self.target = _Tbl(qb), _Tbl(rush), _Tbl(target)


class _Out:
    """Minimal stand-in for a GameState: parlay_odds reads .score/.pstats."""

    def __init__(self, score, pstats):
        import jax.numpy as jnp

        self.score = jnp.asarray(score, jnp.int32)
        self.pstats = jnp.asarray(pstats, jnp.float32)


def _settle_reference(score, pstats, legs, a, b):
    """Pure-numpy mirror of the settlement rules (the test's oracle)."""
    margins = (score[:, 0] - score[:, 1]).astype(np.float32)
    totals = score.sum(axis=1).astype(np.float32)
    role_i = {"pass_yds": (0, 2), "rush_yds": (1, 2), "rec_yds": (2, 2),
              "INT": (0, 4)}
    win, push = [], []
    for leg in legs:
        k = leg["kind"]
        if k == "spread":
            sgn = 1.0 if leg["team"] == a.name else -1.0
            v, thr, over = margins * sgn, -float(leg["line"]), True
        elif k == "moneyline":
            sgn = 1.0 if leg["team"] == a.name else -1.0
            v, thr, over = margins * sgn, 0.0, True
        elif k == "total":
            v, thr, over = totals, float(leg["line"]), leg["side"] == "over"
        else:
            side = 0 if leg["team"] == a.name else 1
            tc = a if side == 0 else b
            role, col = role_i[leg["stat"]]
            tbl = [tc.qb, tc.rush, tc.target][role]
            slot = tbl.names.index(leg["player"])
            v = pstats[:, side, role, slot, col].astype(np.float32)
            thr, over = float(leg["line"]), leg["side"] == "over"
        w = (v > thr) if over else (v < thr)
        p = np.abs(v - thr) <= 1e-9
        win.append(w & ~p)
        push.append(p)
    win, push = np.stack(win, 1), np.stack(push, 1)
    lose = ~(win | push)
    n = len(score)
    return {
        "leg_win": win.mean(0), "leg_push": push.mean(0),
        "p_all_win": win.all(1).mean(),
        "p_lose": lose.any(1).mean(),
        "p_void": push.all(1).mean(),
        "n": n,
    }


@pytest.fixture(scope="module")
def tiny_out():
    a = _Ctx("Alpha", qb=["QB A"], rush=["RB A"], target=["WR A"])
    b = _Ctx("Beta", qb=["QB B"], rush=["RB B"], target=["WR B"])
    score = np.array([[28, 24], [24, 28], [30, 30], [28, 24], [45, 10],
                      [20, 21]])
    pstats = np.zeros((6, 2, 3, 1, 6), dtype=np.float32)
    pstats[:, 0, 0, 0, 2] = [260, 240, 250, 300, 0, 250.5]   # QB A pass_yds
    pstats[:, 1, 1, 0, 2] = [80, 120, 60, 99.5, 140, 30]     # RB B rush_yds
    return a, b, _Out(score, pstats), score, pstats


LEG_SETS = [
    # spread+total with pushes (totals land exactly on 52 three times)
    [{"kind": "spread", "team": "Alpha", "line": -3.5},
     {"kind": "total", "side": "over", "line": 52}],
    # moneyline with a tie trial (margin 0 -> push) + an under
    [{"kind": "moneyline", "team": "Beta"},
     {"kind": "total", "side": "under", "line": 55}],
    # prop legs both sides, incl. a zero-stat (sat-out) trial and an exact
    # line hit (250 vs 250 -> push)
    [{"kind": "prop", "team": "Alpha", "player": "QB A", "stat": "pass_yds",
      "side": "over", "line": 250},
     {"kind": "prop", "team": "Beta", "player": "RB B", "stat": "rush_yds",
      "side": "under", "line": 99.5}],
    # everything at once
    [{"kind": "spread", "team": "Beta", "line": 3.5},
     {"kind": "total", "side": "over", "line": 41},
     {"kind": "moneyline", "team": "Alpha"},
     {"kind": "prop", "team": "Alpha", "player": "QB A", "stat": "pass_yds",
      "side": "over", "line": 199.5}],
]


@pytest.mark.parametrize("legs", LEG_SETS)
def test_parlay_hand_counts(tiny_out, legs):
    a, b, out, score, pstats = tiny_out
    res = parlay_odds(out, a, b, legs, price=-110)
    want = _settle_reference(score, pstats, legs, a, b)
    assert res["n"] == want["n"]
    for i, leg in enumerate(res["legs"]):
        assert leg["p_win"] == pytest.approx(want["leg_win"][i], abs=1e-6)
        assert leg["p_push"] == pytest.approx(want["leg_push"][i], abs=1e-6)
    assert res["p_all_win"] == pytest.approx(want["p_all_win"], abs=1e-6)
    assert res["p_lose"] == pytest.approx(want["p_lose"], abs=1e-6)
    assert res["p_void"] == pytest.approx(want["p_void"], abs=1e-6)
    # identity checks
    assert res["p_all_win"] + res["p_lose"] + res["p_void"] \
        + res["p_win_reduced"] == pytest.approx(1.0, abs=5e-6)
    assert res["p_independent"] == pytest.approx(
        float(np.prod(want["leg_win"])), abs=1e-5)
    # refund semantics: p_parlay conditions on decisive outcomes only
    # (voids AND reduced wins return the stake), matching the EV/Kelly
    assert res["p_parlay"] == pytest.approx(
        want["p_all_win"] / max(want["p_all_win"] + want["p_lose"], 1e-12),
        abs=1e-6)
    # quoted-price block present and finite
    assert res["price"] == -110
    assert np.isfinite(res["ev_$100"]) and np.isfinite(res["edge_pct"])


def test_parlay_exclusive_legs_price_zero(tiny_out):
    a, b, out, *_ = tiny_out
    res = parlay_odds(out, a, b, [{"kind": "moneyline", "team": "Alpha"},
                                  {"kind": "moneyline", "team": "Beta"}])
    assert res["p_all_win"] == 0.0
    assert res["correlation_mult"] == 0.0


def test_parlay_redundant_legs_correlate(tiny_out):
    """A team's ML and its -0.5 cover coincide trial-by-trial -> joint prob
    is the ML marginal itself, double the independence product here."""
    a, b, out, score, _ = tiny_out
    res = parlay_odds(out, a, b, [
        {"kind": "moneyline", "team": "Alpha"},
        {"kind": "spread", "team": "Alpha", "line": -0.5}])
    p_ml = ((score[:, 0] - score[:, 1]) > 0).mean()
    assert res["p_all_win"] == pytest.approx(p_ml, abs=1e-6)
    assert res["correlation_mult"] == pytest.approx(1.0 / p_ml, abs=1e-3)


def test_parlay_leg_validation(tiny_out):
    a, b, out, *_ = tiny_out
    with pytest.raises(ValueError, match="not in this matchup"):
        resolve_parlay_legs(a, b, [{"kind": "moneyline", "team": "Gamma"}])
    with pytest.raises(ValueError, match="unknown prop stat"):
        resolve_parlay_legs(a, b, [{"kind": "prop", "team": "Alpha",
                                    "player": "QB A", "stat": "yeets",
                                    "side": "over", "line": 1}])
    with pytest.raises(ValueError, match="not tracked"):
        resolve_parlay_legs(a, b, [{"kind": "prop", "team": "Alpha",
                                    "player": "Nobody", "stat": "pass_yds",
                                    "side": "over", "line": 1}])
    with pytest.raises(ValueError, match="side 'over' or 'under'"):
        resolve_parlay_legs(a, b, [{"kind": "total", "side": "above",
                                    "line": 55}])
    with pytest.raises(ValueError, match="unknown parlay leg kind"):
        resolve_parlay_legs(a, b, [{"kind": "teaser", "team": "Alpha"}])
    with pytest.raises(ValueError, match="at least one leg"):
        resolve_parlay_legs(a, b, [])
    with pytest.raises(ValueError, match="must be an object"):
        resolve_parlay_legs(a, b, ["moneyline"])  # JSON string, not object


def test_priced_metrics_are_internally_consistent(tiny_out):
    """edge_pct and ev_$100 must agree in sign at any quote: both use the
    same refund semantics (the pre-fix p_parlay counted reduced wins as
    losses while the EV refunded them, so the two could contradict)."""
    a, b, out, *_ = tiny_out
    legs = [{"kind": "spread", "team": "Alpha", "line": -3.5},
            {"kind": "total", "side": "over", "line": 52}]  # pushes exist
    res = parlay_odds(out, a, b, legs, price=-110)
    assert res["p_win_reduced"] > 0  # the case that used to contradict
    fair = res["fair_american"]
    for quote in (-150, -110, 120, 300):
        r = parlay_odds(out, a, b, legs, price=quote)
        # positive edge iff the quote beats fair, and EV agrees (both are
        # zero exactly at the fair price)
        if r["edge_pct"] > 0.5:
            assert r["ev_$100"] > 0, (quote, fair, r)
        if r["edge_pct"] < -0.5:
            assert r["ev_$100"] < 0, (quote, fair, r)


def test_prop_leg_requires_player_stats(tiny_out):
    import jax.numpy as jnp

    a, b, out, score, _ = tiny_out
    nop = _Out(score, np.zeros((6, 1, 1, 1, 1), np.float32))
    nop.pstats = jnp.asarray(nop.pstats)
    with pytest.raises(ValueError, match="collect_players=True"):
        parlay_odds(nop, a, b, [{"kind": "prop", "team": "Alpha",
                                 "player": "QB A", "stat": "pass_yds",
                                 "side": "over", "line": 1}])
    # game-only legs are fine without player stats
    res = parlay_odds(nop, a, b, [{"kind": "moneyline", "team": "Alpha"}])
    assert 0 < res["p_all_win"] < 1


def test_parlay_correlations(tiny_out):
    """Leg-indicator correlation matrix vs numpy's corrcoef on the same
    win indicators."""
    from fast_monte_carlo.edge import parlay_correlations

    a, b, out, score, pstats = tiny_out
    legs = [{"kind": "moneyline", "team": "Alpha"},
            {"kind": "spread", "team": "Alpha", "line": -0.5},
            {"kind": "total", "side": "over", "line": 52},
            {"kind": "prop", "team": "Alpha", "player": "QB A",
             "stat": "pass_yds", "side": "over", "line": 245.5}]
    df = parlay_correlations(out, a, b, legs)
    assert df.shape == (4, 4) and list(df.index) == list(df.columns)

    w = _settle_reference(score, pstats, legs, a, b)  # noqa: F841 (labels)
    # rebuild the win indicators directly
    wins = []
    margins = (score[:, 0] - score[:, 1]).astype(np.float32)
    wins.append(margins > 0)
    wins.append(margins > 0.5)
    wins.append(score.sum(1) > 52)
    wins.append(pstats[:, 0, 0, 0, 2] > 245.5)
    want = np.corrcoef(np.stack(wins).astype(float))
    assert np.allclose(df.to_numpy(), want, atol=1e-5, equal_nan=True)
    # ML and -0.5 cover are the same event here -> correlation 1
    assert df.iloc[0, 1] == pytest.approx(1.0, abs=1e-6)


def test_cross_game_parlay_exact_product(tiny_out):
    """Independent blocks multiply exactly: verify against brute-force
    settlement over the cartesian product of the two games' trials."""
    from fast_monte_carlo.edge import cross_game_parlay

    a, b, out, score, pstats = tiny_out
    c = _Ctx("Gamma", qb=["QB C"])
    d = _Ctx("Delta", qb=["QB D"])
    score2 = np.array([[35, 10], [21, 24], [27, 27], [17, 13]])
    out2 = _Out(score2, np.zeros((4, 2, 3, 1, 6), np.float32))

    legs1 = [{"kind": "spread", "team": "Alpha", "line": -3.5},
             {"kind": "total", "side": "over", "line": 52}]
    legs2 = [{"kind": "moneyline", "team": "Gamma"}]
    blk1 = parlay_odds(out, a, b, legs1)
    blk2 = parlay_odds(out2, c, d, legs2)
    res = cross_game_parlay([blk1, blk2], price=700)

    # brute force: settle every (trial_i, trial_j) pair jointly
    w1 = _settle_reference(score, pstats, legs1, a, b)
    w2 = _settle_reference(score2, np.zeros((4, 2, 3, 1, 6), np.float32),
                           legs2, c, d)
    assert res["p_all_win"] == pytest.approx(
        w1["p_all_win"] * w2["p_all_win"], abs=1e-5)
    assert res["p_lose"] == pytest.approx(
        1 - (1 - w1["p_lose"]) * (1 - w2["p_lose"]), abs=1e-5)
    assert res["p_void"] == pytest.approx(
        w1["p_void"] * w2["p_void"], abs=1e-5)
    assert res["p_all_win"] + res["p_lose"] + res["p_void"] \
        + res["p_win_reduced"] == pytest.approx(1.0, abs=5e-6)
    # legs carry their game tag; within-game correlation multiplies through
    assert len(res["legs"]) == 3 and all("game" in leg for leg in res["legs"])
    assert res["correlation_mult"] == pytest.approx(
        blk1["correlation_mult"] * blk2["correlation_mult"], abs=1e-3)
    assert "ev_$100" in res and "edge_pct" in res
    # same game twice is refused
    with pytest.raises(ValueError, match="same game"):
        cross_game_parlay([blk1, parlay_odds(out, a, b, legs2 := [
            {"kind": "moneyline", "team": "Alpha"}])])
    # printer handles the cross shape
    from fast_monte_carlo.edge import print_parlay_readable
    print_parlay_readable(res)


# --------------------------------------------------------------------------
# real-engine integration
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sim_env(reference_dir, tmp_path_factory):
    from fast_monte_carlo.api import MatchupRunner
    from fast_monte_carlo.config import SimConfig
    from fast_monte_carlo.data import (
        build_team_context_from_sp_flex, load_sp_flex)
    from fast_monte_carlo.models.heads import load_heads

    rows = [dict(team="Kansas State", player="KSU QB", pos="QB", usage=90,
                 stat="pass_yards", yards=250),
            dict(team="Kansas State", player="KSU WR", pos="WR", usage=40,
                 stat="rec_yards", yards=70),
            dict(team="Iowa State", player="ISU RB", pos="RB", usage=70,
                 stat="rush_yards", yards=85)]
    focus = tmp_path_factory.mktemp("parlay") / "players.csv"
    pd.DataFrame(rows).to_csv(focus, index=False)

    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp,
                                        focus_csv=str(focus))
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp,
                                        focus_csv=str(focus))
    heads = load_heads(str(reference_dir))
    runner = MatchupRunner(a, b, heads, SimConfig(), mode="table")
    out = runner.run_pairs(256, seed=11, collect_players=True)
    return a, b, out, str(focus)


def test_parlay_matches_host_recomputation(sim_env):
    a, b, out, _ = sim_env
    legs = [{"kind": "spread", "team": "Iowa State", "line": 2.5},
            {"kind": "total", "side": "under", "line": 54.5},
            {"kind": "prop", "team": "Kansas State", "player": "KSU QB",
             "stat": "pass_yds", "side": "over", "line": 225.5}]
    res = parlay_odds(out, a, b, legs, price=600)
    want = _settle_reference(np.asarray(out.score), np.asarray(out.pstats),
                             legs, a, b)
    assert res["p_all_win"] == pytest.approx(want["p_all_win"], abs=1e-6)
    for i, leg in enumerate(res["legs"]):
        assert leg["p_win"] == pytest.approx(want["leg_win"][i], abs=1e-6)
    # half-point lines: no pushes anywhere
    assert res["p_void"] == 0.0 and res["p_win_reduced"] == 0.0
    assert res["p_parlay"] == res["p_all_win"]


def test_parlay_correlation_real_sim(sim_env):
    """The favorite's ML and a modest cover number are positively
    correlated through the shared game script."""
    a, b, out, _ = sim_env
    fav = a.name if float(np.asarray(out.score)[:, 0].mean()) >= float(
        np.asarray(out.score)[:, 1].mean()) else b.name
    res = parlay_odds(out, a, b, [
        {"kind": "moneyline", "team": fav},
        {"kind": "spread", "team": fav, "line": 10.5}])
    assert res["correlation_mult"] > 1.05
    assert res["p_all_win"] <= min(l["p_win"] for l in res["legs"]) + 1e-12


def test_simulate_parlay_end_to_end(reference_dir, sim_env):
    from fast_monte_carlo.api import simulate_parlay

    *_, focus = sim_env
    res = simulate_parlay(
        "Kansas State", "Iowa State",
        [{"kind": "moneyline", "team": "Kansas State"},
         {"kind": "total", "side": "over", "line": 49.5}],
        sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
        n_pairs=128, focus_csv=focus, mode="analytic", price=300)
    assert res["n"] == 256
    assert 0 <= res["p_all_win"] <= res["p_parlay"] <= 1
    assert set(res) >= {"legs", "fair_american", "correlation_mult",
                        "p_independent", "ev_$100", "edge_pct"}
    # a bad leg fails BEFORE any simulation
    with pytest.raises(ValueError, match="not in this matchup"):
        simulate_parlay(
            "Kansas State", "Iowa State",
            [{"kind": "moneyline", "team": "Ohio State"}],
            sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
            n_pairs=128, mode="analytic")


def test_cli_parlay(reference_dir, tmp_path, capsys):
    from fast_monte_carlo.cli import main

    legs = [{"kind": "moneyline", "team": "Kansas State"},
            {"kind": "total", "side": "under", "line": 60.5}]
    p = tmp_path / "legs.json"
    p.write_text(json.dumps(legs))
    rc = main(["parlay", "Kansas State", "Iowa State",
               "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
               "--legs", f"@{p}", "-n", "128", "--mode", "analytic",
               "--price", "+275", "--json"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Same-game parlay" in out and "Correlation multiplier" in out
    payload = json.loads(out.strip().rsplit("\n", 1)[-1])
    assert payload["n"] == 256 and "fair_american" in payload


def test_cli_parlay_tease(reference_dir, tmp_path, capsys):
    """--tease prices the ticket at shifted lines through the same path;
    a moneyline leg makes the teaser invalid (edge.tease_legs refuses)."""
    from fast_monte_carlo.cli import main

    legs = [{"kind": "spread", "team": "Kansas State", "line": -7.5},
            {"kind": "total", "side": "under", "line": 48.5}]
    p = tmp_path / "legs.json"
    p.write_text(json.dumps(legs))
    args = ["parlay", "Kansas State", "Iowa State",
            "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
            "--legs", f"@{p}", "-n", "128", "--mode", "analytic", "--json"]
    rc = main(args + ["--tease", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "teaser" in out
    teased = json.loads(out.strip().rsplit("\n", 1)[-1])
    # shifted lines show in the leg labels and the ticket can only get
    # more likely than the un-teased ticket
    labels = " ".join(l["label"] for l in teased["legs"])
    assert "-1.5" in labels and "54.5" in labels
    rc = main(args)
    straight = json.loads(capsys.readouterr().out.strip()
                          .rsplit("\n", 1)[-1])
    assert rc == 0
    assert teased["p_parlay"] >= straight["p_parlay"]

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"kind": "moneyline",
                                "team": "Kansas State"}]))
    with pytest.raises(ValueError, match="spread/total"):
        main(["parlay", "Kansas State", "Iowa State",
              "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
              "--legs", f"@{bad}", "-n", "128", "--mode", "analytic",
              "--tease", "6"])
