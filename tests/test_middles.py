"""Middle pricing (edge.middle_odds / spread_middle / total_middle).

Referees: direct per-outcome payoff enumeration on hand-built samples
(the EV must equal the expectation of the two tickets' joint payoffs),
probability identities against the Dist queries the main markets use,
and samples-vs-histogram representation parity.  No reference
counterpart — edge_finder.py prices one line per market (:283-336), so a
cross-line window is unaskable there.
"""
import numpy as np
import pandas as pd
import pytest

from fast_monte_carlo.edge import (
    Dist, middle_odds, middles_from_sims, middles_from_summary,
    spread_middle, total_middle,
)

VALS = np.array([-2.0, 0.0, 3.5, 4.0, 5.0, 7.5, 9.0, 12.0])


def _enumerate_ev(values, low, high, price_low, price_high):
    """Joint payoff of ($100 over `low`) + ($100 under `high`) per trial."""
    def profit(price):
        return 100 * (100 / (-price)) if price < 0 else float(price)

    w_lo, w_hi = profit(price_low), profit(price_high)
    ev = 0.0
    for x in values:
        pay = 0.0
        pay += w_lo if x > low else (0.0 if x == low else -100.0)
        pay += w_hi if x < high else (0.0 if x == high else -100.0)
        ev += pay / len(values)
    return ev


def test_middle_odds_hand_count():
    d = Dist.from_values(VALS)
    res = middle_odds(d, 3.5, 7.5)
    assert res["p_middle"] == pytest.approx(2 / 8)        # {4, 5}
    assert res["p_low_leg_only"] == pytest.approx(2 / 8)  # {9, 12}
    assert res["p_high_leg_only"] == pytest.approx(2 / 8)  # {-2, 0}
    assert res["p_push_low"] == pytest.approx(1 / 8)
    assert res["p_push_high"] == pytest.approx(1 / 8)
    assert res["ev_$100_each"] == pytest.approx(
        _enumerate_ev(VALS, 3.5, 7.5, -110, -110), abs=0.01)


@pytest.mark.parametrize("prices", [(-110, -110), (-105, 115), (100, -120)])
@pytest.mark.parametrize("window", [(3.5, 7.5), (0.0, 9.0), (-2.0, 12.0)])
def test_middle_ev_equals_enumeration(window, prices):
    rng = np.random.default_rng(3)
    vals = rng.normal(5.0, 8.0, size=2000).round()  # integers: pushes exist
    d = Dist.from_values(vals)
    res = middle_odds(d, *window, price_low=prices[0], price_high=prices[1])
    assert res["ev_$100_each"] == pytest.approx(
        _enumerate_ev(vals, *window, *prices), abs=0.01)
    # outcome partition covers everything exactly once
    assert (res["p_middle"] + res["p_low_leg_only"] + res["p_high_leg_only"]
            + res["p_push_low"] + res["p_push_high"]) == pytest.approx(
        1.0, abs=1e-9)


def test_middle_window_validation():
    d = Dist.from_values(VALS)
    with pytest.raises(ValueError, match="empty"):
        middle_odds(d, 7.5, 3.5)
    with pytest.raises(ValueError, match="empty"):
        middle_odds(d, 4.0, 4.0)
    with pytest.raises(ValueError, match="empty"):
        spread_middle(d, "A", "B", -7.5, 3.5)  # window (7.5, 3.5): none


def test_spread_middle_classic_shape():
    """Favorite -3.5 + dog +7.5 cashes both on a 4-7 point win."""
    margins = Dist.from_values(np.array([1.0, 4.0, 6.0, 7.0, 8.0, -3.0]))
    res = spread_middle(margins, "Fav", "Dog", -3.5, 7.5)
    assert res["legs"] == ["Fav -3.5", "Dog +7.5"]
    assert res["low"] == 3.5 and res["high"] == 7.5
    assert res["p_middle"] == pytest.approx(3 / 6)  # {4, 6, 7}
    # identity with the margin Dist's own window query
    assert res["p_middle"] == pytest.approx(
        margins.over(3.5) - margins.over(7.5) - margins.push(7.5), abs=1e-12)


def test_total_middle_and_sims_adapter():
    totals = np.array([48.0, 52.0, 54.0, 55.0, 57.5, 60.0, 63.0, 51.5])
    res = total_middle(Dist.from_values(totals), 51.5, 57.5)
    assert res["legs"] == ["Over 51.5", "Under 57.5"]
    assert res["p_middle"] == pytest.approx(3 / 8)  # {52, 54, 55}
    assert res["p_push_low"] == pytest.approx(1 / 8)
    assert res["p_push_high"] == pytest.approx(1 / 8)

    margins = totals - 50.0  # any margins; frame needs both
    pts = (totals + margins) / 2.0
    opp = (totals - margins) / 2.0
    sims = pd.DataFrame([{"team": "A", "opp": "B", "pts": a, "opp_pts": b}
                         for a, b in zip(pts, opp)])
    out = middles_from_sims(sims, "A", "B", mid_total=(51.5, 57.5),
                            mid_spread=(-1.5, 6.5))
    assert out["total"]["p_middle"] == pytest.approx(3 / 8)
    d = Dist.from_values(margins)
    assert out["spread"]["p_middle"] == pytest.approx(
        d.over(1.5) - d.over(6.5) - d.push(6.5), abs=1e-12)
    with pytest.raises(ValueError, match="no rows"):
        middles_from_sims(sims, "B", "A", mid_total=(51.5, 57.5))


def test_middles_summary_vs_samples_parity():
    """The histogram (device) representation prices the same middle as the
    raw samples at integer support."""
    from fast_monte_carlo.parallel import summarize_scores

    rng = np.random.default_rng(11)
    margins = rng.normal(4.0, 13.0, size=4096).round().astype(int)
    totals = np.clip(rng.normal(55.0, 11.0, size=4096).round(), 0,
                     None).astype(int)
    pts_a = ((totals + margins) / 2.0).round().astype(int)
    pts_b = pts_a - margins
    score = np.stack([pts_a, pts_b], axis=1)
    import jax.numpy as jnp
    summary = summarize_scores(jnp.asarray(score, jnp.int32))

    got = middles_from_summary(summary, "A", "B", mid_spread=(-2.5, 6.5),
                               mid_total=(50.5, 58.5))
    m = Dist.from_values((score[:, 0] - score[:, 1]).astype(float))
    t = Dist.from_values(score.sum(axis=1).astype(float))
    want_s = spread_middle(m, "A", "B", -2.5, 6.5)
    want_t = total_middle(t, 50.5, 58.5)
    for k in ("p_middle", "p_low_leg_only", "p_high_leg_only",
              "ev_$100_each"):
        assert got["spread"][k] == pytest.approx(want_s[k], abs=1e-6)
        assert got["total"][k] == pytest.approx(want_t[k], abs=1e-6)


def test_print_middle(capsys):
    from fast_monte_carlo.edge import print_middle_readable

    res = spread_middle(Dist.from_values(VALS), "A", "B", -3.5, 7.5)
    print_middle_readable(res)
    text = capsys.readouterr().out
    assert "Middle: A -3.5 / B +7.5" in text and "P(both win)" in text


def test_cli_edges_middle(tmp_path, capsys, monkeypatch):
    """File-path CLI: --mid-spread/--mid-total price off the saved sims."""
    from fast_monte_carlo.cli import main

    rng = np.random.default_rng(5)
    margins = rng.normal(5.0, 12.0, size=512).round()
    totals = np.clip(rng.normal(54.0, 10.0, size=512).round(), 0, None)
    pts_a = ((totals + margins) / 2.0).round()
    pts_b = pts_a - margins
    rows = [{"team": "Kansas State", "opp": "Iowa State", "pts": a,
             "opp_pts": b} for a, b in zip(pts_a, pts_b)]
    rows += [{"team": "Iowa State", "opp": "Kansas State", "pts": b,
              "opp_pts": a} for a, b in zip(pts_a, pts_b)]
    pd.DataFrame(rows).to_csv(tmp_path / "scores_ks_isu.csv", index=False)

    rc = main(["edges", "--base", "ks_isu", "--team-a", "Kansas State",
               "--team-b", "Iowa State", "--spread", "-3.5",
               "--mid-spread=-3.5,7.5", "--mid-total", "50.5,57.5",
               "--dir", str(tmp_path)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Middle: Kansas State -3.5 / Iowa State +7.5" in text
    assert "Middle: Over 50.5 / Under 57.5" in text
    with pytest.raises(SystemExit, match="--mid-spread wants"):
        main(["edges", "--base", "ks_isu", "--team-a", "Kansas State",
              "--team-b", "Iowa State", "--mid-spread", "oops",
              "--dir", str(tmp_path)])

    # middles-only + --props must still run the main report (moneyline +
    # prop scan) — it used to be silently dropped when no --spread/--total
    # was quoted (ADVICE r3)
    props = tmp_path / "props.csv"
    pd.DataFrame({"team": ["Kansas State"], "player": ["Avery Johnson"],
                  "stat": ["pass_yards"], "yards": [250.5]}
                 ).to_csv(props, index=False)
    rc = main(["edges", "--base", "ks_isu", "--team-a", "Kansas State",
               "--team-b", "Iowa State", "--mid-total", "50.5,57.5",
               "--props", str(props), "--dir", str(tmp_path)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Fair Moneyline" in text
    assert "Middle: Over 50.5 / Under 57.5" in text
