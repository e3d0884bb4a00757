"""Bit-exact pin of every edge.py market function against golden outputs
captured from the pre-refactor implementation (tests/data/edge_golden.json,
generated by tests/data/make_edge_golden.py).

The round-3 rewrite of the file-based market internals (shared Dist core)
must keep every output dict — keys, values, rounding — identical."""
import json
from pathlib import Path

import pytest

from fast_monte_carlo import edge as E

GOLDEN = json.loads(
    (Path(__file__).parent / "data" / "edge_golden.json").read_text())


@pytest.fixture(scope="module")
def frames():
    import sys
    sys.path.insert(0, str(Path(__file__).parent / "data"))
    from make_edge_golden import synth_frames
    sims, players = synth_frames()
    players = players.assign(team_low=players.team.str.lower(),
                             player_low=players.player.str.lower())
    return sims, players


def assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), f"{path}: keys differ"
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-12), f"{path}: {got} != {want}"
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


def test_game_market_golden(frames):
    sims, _ = frames
    got = E.game_market_odds(None, "Alpha", "Beta", spread=-3.5, total=51.5,
                             sims=sims)
    assert_same(got, GOLDEN["game_market"])
    got = E.game_market_odds(None, "Alpha", "Beta", spread=-3.0, total=52.0,
                             sims=sims)
    assert_same(got, GOLDEN["game_market_int_lines"])


def test_moneyline_golden(frames):
    sims, _ = frames
    assert_same(E.moneyline_from_sims(None, "Alpha", "Beta", sims=sims),
                GOLDEN["moneyline"])


def test_prop_golden(frames):
    _, players = frames
    got = E.player_prop_odds(None, "Alpha", "QB One", "pass_yards", 250.5,
                             players_df=players)
    assert_same(got, GOLDEN["prop_qb"])
    got = E.player_prop_odds(None, "Alpha", "RB One", "rush_yards", 80.0,
                             players_df=players)
    assert_same(got, GOLDEN["prop_rb"])


def test_odds_helpers_golden():
    o = GOLDEN["odds"]
    assert [E.prob_to_american(p) for p in
            (0.01, 0.25, 0.5, 0.5238, 0.75, 0.99)] == o["prob_to_american"]
    assert [E.ev_per_100(0.55, -110),
            E.ev_per_100(0.45, 120)] == pytest.approx(o["ev_per_100"])
    assert [E.ev_per_100_at_minus110(0.55, 0.02)] == pytest.approx(
        o["ev_minus110"])
    assert [E.american_implied_prob(-110),
            E.american_implied_prob(150)] == pytest.approx(o["implied"])
    for got, want in zip([E.best_side_ev(0.58), E.best_side_ev(0.40)],
                         o["best_side"]):
        assert got["side"] == want["side"]
        assert got["ev"] == pytest.approx(want["ev"])
        assert got["edge"] == pytest.approx(want["edge"])
