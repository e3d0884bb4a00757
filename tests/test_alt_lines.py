"""Alternate-line ladders (edge.alt_*_table) and the teaser leg transform.

Referees: the main-market builders the ladder must agree with at the
quoted line (_spread_market/_total_market through game_market_odds /
market_odds_from_summary), probability identities on hand-built samples,
and cover-probability monotonicity in the line.  No reference
counterpart exists — edge_finder.py prices only the single quoted line
(:283-336) — so the fidelity anchor is internal consistency with the
already-referee'd main markets.
"""
import numpy as np
import pandas as pd
import pytest

from fast_monte_carlo.edge import (
    Dist, alt_lines_from_sims, alt_lines_from_summary, alt_spread_table,
    alt_total_table, game_market_odds, ladder_lines,
    market_odds_from_summary, tease_legs,
)


def _sims_frame(margins, totals):
    """Two-perspective scores table like scores_frame writes (pts/opp_pts
    from each side)."""
    pts_a = (np.asarray(totals) + np.asarray(margins)) / 2.0
    pts_b = (np.asarray(totals) - np.asarray(margins)) / 2.0
    rows = [{"team": "A", "opp": "B", "pts": a, "opp_pts": b}
            for a, b in zip(pts_a, pts_b)]
    rows += [{"team": "B", "opp": "A", "pts": b, "opp_pts": a}
             for a, b in zip(pts_a, pts_b)]
    return pd.DataFrame(rows)


@pytest.fixture(scope="module")
def margins():
    rng = np.random.default_rng(7)
    return rng.normal(6.0, 14.0, size=4096).round().astype(int)


@pytest.fixture(scope="module")
def totals():
    rng = np.random.default_rng(8)
    # same parity as margins is irrelevant for these tests; keep integer
    return np.clip(rng.normal(55.0, 12.0, size=4096).round(), 0, None
                   ).astype(int)


def test_ladder_lines_grid():
    g = ladder_lines(-3.5, width=3.0, step=1.0)
    assert g.tolist() == [-6.5, -5.5, -4.5, -3.5, -2.5, -1.5, -0.5]
    assert -3.5 in g
    half = ladder_lines(55.0, width=1.0, step=0.5)
    assert half.tolist() == [54.0, 54.5, 55.0, 55.5, 56.0]
    with pytest.raises(ValueError):
        ladder_lines(0.0, step=0.0)


def test_spread_ladder_matches_main_market_at_quote(margins):
    d = Dist.from_values(margins.astype(float))
    for quote in (-3.5, 3.0, 7.0):
        tbl = alt_spread_table(d, "A", "B", ladder_lines(quote, 4, 1))
        row = tbl.loc[tbl["spread"] == quote].iloc[0]
        sims = _sims_frame(margins, np.full_like(margins, 50))
        main = game_market_odds(None, "A", "B", spread=quote,
                                sims=sims)["spread"]
        assert row["p_cover"] == pytest.approx(main["p_cover"], abs=1e-12)
        assert row["push_rate"] == pytest.approx(main["push_rate"],
                                                 abs=1e-12)
        assert int(row["fair_cover"]) == main["american_cover"]
        assert int(row["fair_notcover"]) == main["american_notcover"]


def test_total_ladder_matches_main_market_at_quote(totals):
    sims = _sims_frame(np.zeros_like(totals), totals)
    for quote in (54.5, 56.0):
        res = alt_lines_from_sims(sims, "A", "B", total=quote, width=3,
                                  step=0.5)
        row = res["total"].loc[res["total"]["total"] == quote].iloc[0]
        main = game_market_odds(None, "A", "B", total=quote,
                                sims=sims)["total"]
        assert row["p_over"] == pytest.approx(main["p_over"], abs=1e-12)
        assert row["push_rate"] == pytest.approx(main["push_rate"],
                                                 abs=1e-12)
        assert int(row["fair_over"]) == main["american_over"]


def test_probability_identities_and_monotonicity(margins, totals):
    md, td = (Dist.from_values(margins.astype(float)),
              Dist.from_values(totals.astype(float)))
    sp = alt_spread_table(md, "A", "B", ladder_lines(-3.0, 12, 0.5))
    tt = alt_total_table(td, ladder_lines(55.0, 12, 0.5))
    # three-way split always sums to 1
    assert np.allclose(sp["p_cover"] + sp["p_notcover"] + sp["push_rate"],
                       1.0, atol=1e-9)
    assert np.allclose(tt["p_over"] + tt["p_under"] + tt["push_rate"], 1.0,
                       atol=1e-9)
    # half-point rows cannot push on integer scores
    assert (sp.loc[sp["spread"] % 1 != 0, "push_rate"] == 0).all()
    assert (tt.loc[tt["total"] % 1 != 0, "push_rate"] == 0).all()
    # more points = easier cover; higher total = harder over
    assert (np.diff(sp["p_cover"].to_numpy()) >= -1e-12).all()
    assert (np.diff(tt["p_over"].to_numpy()) <= 1e-12).all()


def test_hist_and_sample_dists_agree(margins):
    vals = margins.astype(float)
    off = -int(margins.min())
    counts = np.bincount(margins + off)
    support = np.arange(len(counts)) - off
    lines = ladder_lines(-2.5, 10, 0.5)
    a = alt_spread_table(Dist.from_values(vals), "A", "B", lines)
    b = alt_spread_table(Dist.from_hist(counts, support), "A", "B", lines)
    pd.testing.assert_frame_equal(a, b)


def test_alt_lines_from_summary_matches_sims_path(margins, totals):
    import jax

    from fast_monte_carlo.parallel import summarize_scores

    pts_a = (totals + margins) / 2.0
    pts_b = (totals - margins) / 2.0
    # integer scores so the histogram support is exact
    score = np.stack([np.round(pts_a), np.round(pts_b)], axis=1)
    summary = jax.jit(summarize_scores)(score.astype(np.int32))
    m = np.asarray(score[:, 0] - score[:, 1])
    t = np.asarray(score[:, 0] + score[:, 1])
    sims = _sims_frame(m, t)
    got = alt_lines_from_summary(summary, "A", "B", spread=-3.5, total=55.5,
                                 width=6, step=1.0)
    want = alt_lines_from_sims(sims, "A", "B", spread=-3.5, total=55.5,
                               width=6, step=1.0)
    for key in ("spread", "total"):
        g, w = got[key], want[key]
        for col in g.columns:
            if g[col].dtype.kind in "fi":
                assert np.allclose(g[col], w[col], atol=1e-9), (key, col)
    # and the quoted row agrees with the summary main market
    main = market_odds_from_summary(summary, "A", "B", spread=-3.5)["spread"]
    row = got["spread"].loc[got["spread"]["spread"] == -3.5].iloc[0]
    assert row["p_cover"] == pytest.approx(main["p_cover"], abs=1e-12)


def test_tease_legs_shifts_in_bettors_favor():
    legs = [
        {"kind": "spread", "team": "A", "line": -7.5},
        {"kind": "total", "side": "over", "line": 55.5},
        {"kind": "total", "side": "Under", "line": 55.5},
    ]
    teased = tease_legs(legs, 6.0)
    assert teased[0]["line"] == -1.5          # dog/fav gains points
    assert teased[1]["line"] == 49.5          # over drops
    assert teased[2]["line"] == 61.5          # under rises
    # originals unmutated
    assert legs[0]["line"] == -7.5
    # teased lines can only make each leg MORE likely to win
    rng = np.random.default_rng(3)
    margins = Dist.from_values(rng.normal(0, 14, 2000).round())
    totals = Dist.from_values(rng.normal(55, 12, 2000).round())
    assert margins.over(-teased[0]["line"]) >= margins.over(7.5)
    assert totals.over(teased[1]["line"]) >= totals.over(55.5)
    assert totals.under(teased[2]["line"]) >= totals.under(55.5)


def test_tease_legs_refuses_unteasable():
    with pytest.raises(ValueError, match="spread/total"):
        tease_legs([{"kind": "moneyline", "team": "A"}], 6.0)
    with pytest.raises(ValueError, match="spread/total"):
        tease_legs([{"kind": "prop", "team": "A", "player": "x",
                     "stat": "pass_yds", "side": "over", "line": 250.5}], 6)
    with pytest.raises(ValueError, match="side"):
        tease_legs([{"kind": "total", "line": 55.5}], 6.0)
    with pytest.raises(ValueError, match=">= 0"):
        tease_legs([{"kind": "spread", "team": "A", "line": -3.5}], -2.0)
    with pytest.raises(ValueError, match="object/dict"):
        tease_legs(["spread A -3.5"], 6.0)


# ---------------------------------------------------------------------------
# player-prop ladders (edge.player_prop_ladder / alt_prop_table / cli prop)
# ---------------------------------------------------------------------------

def _players_frame(n=1000):
    rng = np.random.default_rng(9)
    qb = pd.DataFrame({"team": "Alpha", "player": "QB One", "role": "QB",
                       "pass_yds": rng.normal(250, 60, n).round()})
    wr = pd.DataFrame({"team": "Alpha", "player": "WR One",
                       "role": "Receiver",
                       "rec": rng.poisson(5.0, n).astype(float),
                       "pass_yds": np.nan})
    return pd.concat([qb, wr], ignore_index=True)


def test_prop_ladder_matches_main_prop_at_quote():
    from fast_monte_carlo.edge import player_prop_ladder, player_prop_odds

    df = _players_frame()
    quote = 249.5
    main = player_prop_odds(None, "Alpha", "QB One", "pass_yards", quote,
                            players_df=df)
    tbl = player_prop_ladder(None, "Alpha", "QB One", "pass_yards", quote,
                             players_df=df)
    # default yardage grid: +/-30 by 5 -> 13 rows, quote included
    assert len(tbl) == 13 and quote in tbl["line"].tolist()
    row = tbl.loc[tbl["line"] == quote].iloc[0]
    assert row["p_over"] == pytest.approx(main["p_over"], abs=1e-4)
    assert int(row["fair_over"]) == main["american_over"]
    assert int(row["fair_under"]) == main["american_under"]
    assert (row["team"], row["player"], row["stat"]) == \
        ("Alpha", "QB One", "pass_yds")
    # over probability is non-increasing up the ladder
    assert (np.diff(tbl["p_over"].to_numpy()) <= 1e-12).all()


def test_prop_ladder_count_stat_grid():
    from fast_monte_carlo.edge import player_prop_ladder

    tbl = player_prop_ladder(None, "Alpha", "WR One", "rec", 4.5,
                             players_df=_players_frame())
    # count-stat default grid: +/-2.5 by 0.5 -> 11 rows
    assert len(tbl) == 11
    assert tbl["line"].tolist() == [2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0,
                                    5.5, 6.0, 6.5, 7.0]
    # integer samples: whole-number rungs carry push mass, half-points none
    assert tbl.loc[tbl["line"] == 4.0, "push_rate"].iloc[0] > 0
    assert tbl.loc[tbl["line"] == 4.5, "push_rate"].iloc[0] == 0


def test_cli_prop_command(tmp_path, capsys):
    from fast_monte_carlo.cli import main

    df = _players_frame()
    pd.DataFrame([{"team": "Alpha", "opp": "Beta", "pts": 28,
                   "opp_pts": 20}]).to_csv(tmp_path / "scores_ab.csv",
                                           index=False)
    df.to_csv(tmp_path / "players_ab.csv", index=False)
    rc = main(["prop", "Alpha", "QB One", "pass_yds", "249.5",
               "--base", "ab", "--dir", str(tmp_path), "--ladder"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "QB One (Alpha, QB) pass_yds 249.5" in out
    assert "Alternate lines" in out and "279.5" in out
    with pytest.raises(ValueError, match="never appears"):
        main(["prop", "Alpha", "Nobody", "pass_yds", "249.5",
              "--base", "ab", "--dir", str(tmp_path)])
