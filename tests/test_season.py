"""Season win-total projection (edge.season_win_pmf / api.project_season).

The composition is exact — distinct games are independent sims, so the
win-count distribution is the Poisson-binomial over the per-game win
probabilities.  Referees: brute-force enumeration over all outcome
combinations, the closed-form binomial at equal p, and hand-countable
market cases.  No reference counterpart (edge_finder.py prices single
matchups only).
"""
import itertools

import numpy as np
import pytest

from fast_monte_carlo.edge import (
    prob_to_american, season_win_market, season_win_pmf,
)


def _brute_pmf(ps):
    pmf = np.zeros(len(ps) + 1)
    for outcome in itertools.product([0, 1], repeat=len(ps)):
        pr = np.prod([p if o else 1 - p for p, o in zip(ps, outcome)])
        pmf[sum(outcome)] += pr
    return pmf


def test_pmf_matches_brute_force_enumeration():
    ps = [0.9, 0.42, 0.65, 0.5, 0.08, 0.77]
    np.testing.assert_allclose(season_win_pmf(ps), _brute_pmf(ps),
                               rtol=0, atol=1e-12)


def test_pmf_equal_p_is_binomial():
    n, p = 12, 0.61
    from math import comb
    expect = np.array([comb(n, k) * p**k * (1 - p)**(n - k)
                       for k in range(n + 1)])
    np.testing.assert_allclose(season_win_pmf([p] * n), expect, atol=1e-12)


def test_pmf_edge_cases():
    np.testing.assert_allclose(season_win_pmf([]), [1.0])
    np.testing.assert_allclose(season_win_pmf([1.0, 1.0]), [0, 0, 1.0])
    np.testing.assert_allclose(season_win_pmf([0.0, 1.0]), [0, 1.0, 0])
    assert season_win_pmf([0.3] * 14).sum() == pytest.approx(1.0, abs=1e-12)
    with pytest.raises(ValueError, match="not a probability"):
        season_win_pmf([0.5, 1.2])
    with pytest.raises(ValueError, match="not a probability"):
        season_win_pmf([float("nan")])


def test_market_hand_countable():
    # certain win + coin flip: wins ~ {1: .5, 2: .5}
    res = season_win_market([1.0, 0.5], line=1.5, team="X")
    assert res["mean_wins"] == pytest.approx(1.5)
    assert res["p_over"] == pytest.approx(0.5)
    assert res["p_under"] == pytest.approx(0.5)
    assert res["push_rate"] == 0.0
    assert res["american_over"] == prob_to_american(0.5)
    assert res["p_at_least"] == [1.0, 1.0, 0.5]
    # integer line pushes on exactly that many wins
    res1 = season_win_market([1.0, 0.5], line=1)
    assert res1["push_rate"] == pytest.approx(0.5)
    assert res1["p_over"] == pytest.approx(0.5)
    assert res1["p_under"] == 0.0
    # no line -> distribution only
    res2 = season_win_market([0.5, 0.5])
    assert "p_over" not in res2 and res2["games"] == 2
    assert res2["pmf"] == [0.25, 0.5, 0.25]


def test_market_best_side_ev_sign():
    res = season_win_market([0.9] * 10, line=7.5)
    # mean 9 wins: Over 7.5 is heavily favored at -110
    assert res["best"]["side"] == "Over"
    assert res["best"]["ev"] > 0


def test_market_best_side_is_push_aware():
    """Integer lines push — the best side must NOT count push mass as the
    other side winning (the push-blind best_side_ev would report a
    fabricated +EV here)."""
    # wins ~ {0: .25, 1: .5, 2: .25}; line 1 pushes half the time
    res = season_win_market([0.5, 0.5], line=1, price=-110)
    assert res["push_rate"] == pytest.approx(0.5)
    b = res["best"]
    # either side: win .25, lose .25, push .5 -> EV = .25*90.909 - .25*100
    assert b["ev"] == pytest.approx(0.25 * (100 / 1.1) - 25.0, abs=0.01)
    assert b["ev"] < 0 and b["kelly"] == 0.0
    # conditional (push-excluded) edge vs the -110 implied break-even
    assert b["edge"] == pytest.approx(0.5 - 110 / 210, abs=1e-6)
    # a side that literally cannot lose prices accordingly
    res2 = season_win_market([1.0, 0.5], line=1, price=-110)
    b2 = res2["best"]
    assert b2["side"] == "Over" and b2["kelly"] == pytest.approx(1.0)
    assert b2["ev"] == pytest.approx(0.5 * (100 / 1.1), abs=0.01)


@pytest.fixture(scope="module")
def season_result(reference_dir):
    from fast_monte_carlo.api import project_season

    sp = str(reference_dir / "PregameSPPlus2025_1.csv")
    # team appears as side A once and side B once — exercises side pick-up
    return project_season(
        "Kansas State",
        games=[("Kansas State", "Iowa State"), ("Kansas", "Kansas State")],
        line=1.5, sp_path=sp, n_pairs=256, mode="analytic", seed=3)


def test_project_season_composes_slate(season_result, reference_dir):
    from fast_monte_carlo.api import simulate_slate_summaries

    res = season_result
    sched = res["schedule"]
    assert list(sched["team_side"]) == ["a", "b"]
    assert list(sched["opponent"]) == ["Iowa State", "Kansas"]
    # p_win_team reads the right side's win rate off the slate rows
    sp = str(reference_dir / "PregameSPPlus2025_1.csv")
    df = simulate_slate_summaries(
        [("Kansas State", "Iowa State"), ("Kansas", "Kansas State")],
        sp_path=sp, n_pairs=256, mode="analytic", seed=3)
    np.testing.assert_allclose(
        res["p_wins"], [df.iloc[0]["win_a"], df.iloc[1]["win_b"]], atol=5e-7)
    # the composed pmf is the convolution of exactly those two games
    np.testing.assert_allclose(
        res["pmf"], season_win_pmf(res["p_wins"]), atol=5e-7)
    assert sum(res["pmf"]) == pytest.approx(1.0, abs=1e-6)
    assert res["games"] == 2 and "p_over" in res


def test_cli_season(reference_dir, capsys):
    from fast_monte_carlo.cli import main

    sp = str(reference_dir / "PregameSPPlus2025_1.csv")
    rc = main([
        "season", "Kansas State", "--opponents", "Iowa State,Kansas",
        "--sp", sp, "--line", "1.5", "-n", "256", "--mode", "analytic",
        "--artifacts", str(reference_dir),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Season win total: Kansas State (2 games)" in out
    assert "P(at least k wins)" in out and "best side" in out
    # exactly one of --opponents/--games required
    assert main(["season", "X", "--sp", sp]) == 2


def test_project_season_validation(reference_dir):
    from fast_monte_carlo.api import project_season

    sp = str(reference_dir / "PregameSPPlus2025_1.csv")
    with pytest.raises(ValueError, match="exactly one"):
        project_season("Kansas State", sp_path=sp)
    with pytest.raises(ValueError, match="exactly one"):
        project_season("Kansas State", opponents=["Kansas"],
                       games=[("a", "b")], sp_path=sp)
    with pytest.raises(ValueError, match="doesn't include"):
        project_season("Kansas State", games=[("Kansas", "Iowa State")],
                       sp_path=sp)
