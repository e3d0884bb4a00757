"""Kelly staking math (edge.kelly_fraction) and its wiring into the
parlay/season priced outputs.  Referees: the closed-form no-push Kelly,
hand-computed cases, and a numeric grid check that f* maximizes
E[log bankroll] in the push-aware three-outcome model."""
import numpy as np
import pytest

from fast_monte_carlo.edge import kelly_fraction, season_win_market


def test_classic_no_push_formula():
    # even money: f* = 2p - 1
    assert kelly_fraction(0.6, 100) == pytest.approx(0.2)
    # -110: b = 10/11, q = .45 -> (pb - q)/b
    assert kelly_fraction(0.55, -110) == pytest.approx(
        (0.55 * 10 / 11 - 0.45) / (10 / 11))
    # +450 underdog
    p, b = 0.25, 4.5
    assert kelly_fraction(p, 450) == pytest.approx((p * b - 0.75) / b)


def test_negative_edge_floors_at_zero():
    assert kelly_fraction(0.5, -110) == 0.0
    assert kelly_fraction(0.01, 100) == 0.0
    assert kelly_fraction(0.0, 100, p_push=1.0) == 0.0  # degenerate


def test_push_aware_cases():
    # can't lose -> bet the max
    assert kelly_fraction(0.5, 100, p_push=0.5) == pytest.approx(1.0)
    # pure push mass shrinks p_lose, raising f* vs the no-push quote
    assert kelly_fraction(0.5, 100, p_push=0.2) > kelly_fraction(0.5, 100)


@pytest.mark.parametrize("p_win,p_push,price",
                         [(0.58, 0.0, -110), (0.45, 0.1, 150),
                          (0.62, 0.05, -135), (0.3, 0.25, 320)])
def test_maximizes_log_wealth(p_win, p_push, price):
    b = (100 / -price) if price < 0 else price / 100
    p_lose = 1 - p_win - p_push

    def growth(f):
        return (p_win * np.log1p(f * b) + p_lose * np.log1p(-f)
                + p_push * 0.0)

    f_star = kelly_fraction(p_win, price, p_push)
    grid = np.linspace(0, 0.999, 4000)
    assert growth(f_star) >= growth(grid).max() - 1e-6
    if f_star > 0:
        assert abs(grid[np.argmax(growth(grid))] - f_star) < 1e-3


def test_wired_into_season_market():
    res = season_win_market([0.9] * 10, line=7.5, price=-110)
    b = res["best"]
    p_best = res["p_over"] if b["side"] == "Over" else res["p_under"]
    assert b["kelly"] == pytest.approx(
        kelly_fraction(p_best, -110, p_push=res["push_rate"]), abs=1e-4)
    assert 0.0 < b["kelly"] <= 1.0


def test_wired_into_cross_game_parlay():
    from fast_monte_carlo.edge import cross_game_parlay

    blk = {"team": "A", "opp": "B", "legs": [], "p_all_win": 0.5,
           "p_lose": 0.4, "p_void": 0.02, "p_independent": 0.5}
    res = cross_game_parlay([blk], price=150)
    # p_no_lose = .6, push mass = .6 - .5 = .1
    assert res["kelly"] == pytest.approx(
        kelly_fraction(0.5, 150, p_push=0.1), abs=1e-4)
