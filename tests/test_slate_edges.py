"""Slate-wide market pricing off device-reduced summaries.

edge.slate_market_table collapses the reference's one-matchup-at-a-time
edge loop (edge_finder.py find_edges :586-614 over :283-336) onto the
per-matchup ScoreSummary histograms the slate paths accumulate on device.
"""
import numpy as np
import pandas as pd
import pytest

from fast_monte_carlo.edge import (
    breakeven_minus110, print_slate_edges, prob_to_american,
    slate_market_table, summary_moneyline,
)
from fast_monte_carlo.parallel.aggregate import (
    MARGIN_OFF, MAX_PTS, ScoreSummary,
)


def _summary(margin_counts: dict, total_counts: dict, n: int) -> ScoreSummary:
    mh = np.zeros(2 * MARGIN_OFF)
    for m, c in margin_counts.items():
        mh[m + MARGIN_OFF] = c
    th = np.zeros(2 * MAX_PTS)
    for t, c in total_counts.items():
        th[t] = c
    return ScoreSummary(
        n=np.float32(n), mean_pts=np.zeros(2), sd_pts=np.zeros(2),
        win_rate=np.zeros(2), tie_rate=np.float32(0.0),
        pts_hist=np.zeros((2, MAX_PTS)), margin_hist=mh, total_hist=th)


def test_dist_hist_matches_samples():
    """The Dist core's two representations — raw per-trial samples (file
    path) and integer-support histograms (device path) — must agree on
    every market query for integer-valued data; all markets in edge.py
    reduce through these five queries."""
    from fast_monte_carlo.edge import Dist

    rng = np.random.default_rng(7)
    vals = rng.integers(-40, 41, size=5000).astype(float)
    support = np.arange(-60, 61).astype(float)
    counts = np.array([(vals == s).sum() for s in support], float)
    dv = Dist.from_values(vals)
    dh = Dist.from_hist(counts, support)
    assert dv.n == dh.n == 5000
    for line in (-7.5, -3.0, -0.5, 0.0, 2.5, 7.0, 10.5):
        assert dv.over(line) == dh.over(line), line
        assert dv.under(line) == dh.under(line), line
        assert dv.push(line) == dh.push(line), line
    assert dv.mean() == pytest.approx(dh.mean(), abs=1e-9)
    # medians may differ by interpolation convention at even n; both must
    # land on or between the two central order statistics
    lo, hi = np.sort(vals)[2499], np.sort(vals)[2500]
    assert lo <= dv.median() <= hi and lo <= dh.median() <= hi


def test_dist_counts_require_support():
    """counts without support must fail loudly at construction, not with an
    opaque NoneType TypeError at the first market query."""
    from fast_monte_carlo.edge import Dist

    with pytest.raises(ValueError, match="requires support"):
        Dist(counts=np.ones(5))


def test_simulate_slate_summaries_empty_slate(reference_dir):
    """An empty games list returns an empty frame (the slate-props
    contract) instead of crashing tree_map on zero summaries."""
    from fast_monte_carlo.api import simulate_slate_summaries

    sp_path = str(reference_dir / "PregameSPPlus2025_1.csv")
    df = simulate_slate_summaries([], sp_path=sp_path, n_pairs=8)
    assert df.empty
    df2, summs = simulate_slate_summaries(
        [], sp_path=sp_path, n_pairs=8, return_summaries=True)
    assert df2.empty and summs == []


def test_summary_moneyline_hand_counts():
    # margins: +3 x60, -7 x30, 0 x10 -> p_a=.6, p_b=.3 (ties to neither)
    s = _summary({3: 60, -7: 30, 0: 10}, {45: 100}, 100)
    ml = summary_moneyline(s, "A", "B")
    assert ml["team"]["p_win"] == 0.6 and ml["opp"]["p_win"] == 0.3
    assert ml["team"]["ml_fair"] == prob_to_american(0.6)
    assert ml["opp"]["ml_fair"] == prob_to_american(0.3)


def test_slate_market_table_hand_counts(capsys):
    # cover iff margin > 2.5 at spread -2.5 -> 60/100
    s1 = _summary({3: 60, -7: 30, 0: 10}, {40: 25, 50: 75}, 100)
    s2 = _summary({10: 80, -3: 20}, {55: 100}, 100)   # no line row
    lines = pd.DataFrame(
        [{"team_a": "Alpha St.", "spread": -2.5, "total": 45.5}])
    df = slate_market_table([("Alpha St.", "Beta"), ("Gamma", "Delta")],
                            [s1, s2], lines)
    r = df.iloc[0]
    assert r.p_cover_a == pytest.approx(0.6)
    assert r.fair_cover_a == prob_to_american(0.6)
    assert r.p_over == pytest.approx(0.75)
    assert r.spread_bet == "Alpha St. -2.5"
    assert r.total_bet == "Over 45.5"
    be = breakeven_minus110()
    assert r.spread_edge_pct == pytest.approx(100 * (0.6 - be), abs=0.01)
    assert r.total_edge_pct == pytest.approx(100 * (0.75 - be), abs=0.01)
    r2 = df.iloc[1]
    assert r2.p_win_a == pytest.approx(0.8)
    assert pd.isna(r2.spread) and pd.isna(r2.total)
    print_slate_edges(df)
    out = capsys.readouterr().out
    assert "Slate Market Edges" in out and "Alpha St." in out


def test_slate_market_table_underdog_sides():
    # p_cover .3 -> bet the other side at +2.5; p_over .2 -> Under
    s = _summary({3: 30, -7: 70}, {40: 80, 50: 20}, 100)
    lines = pd.DataFrame([{"spread": -2.5, "total": 45.5}])  # positional
    df = slate_market_table([("A", "B")], [s], lines)
    assert df.iloc[0].spread_bet == "B +2.5"
    assert df.iloc[0].total_bet == "Under 45.5"


def test_simulate_slate_props(reference_dir, tmp_path):
    """Slate-wide prop scan: per-matchup device reductions, deferred
    transfers; rows for teams outside the slate (or untracked players) are
    skipped; each surviving row is bitwise-equal to the single-matchup
    scan_props_device at the same fold_in key (the refactor's regression
    check)."""
    import jax

    from fast_monte_carlo.api import MatchupRunner, simulate_slate_props
    from fast_monte_carlo.data import (
        build_team_context_from_sp_flex, load_sp_flex,
    )
    from fast_monte_carlo.edge import scan_props_device
    from fast_monte_carlo.models.heads import load_heads

    sp_path = str(reference_dir / "PregameSPPlus2025_1.csv")
    heads = load_heads(reference_dir)
    # QB names the stage-1 model actually knows -> tracked focus slots
    s1_cats = heads.stage1.layout.categories["passer_name"]
    s1_used = sorted(set(heads.stage1.used_cat_locals("passer_name").tolist()))
    teams = ["Kansas State", "Iowa State", "Alabama", "Georgia"]
    rows = []
    for t, qi in zip(teams, s1_used[:4]):
        rows.append(dict(team=t, player=s1_cats[qi], pos="QB", usage=80,
                         stat="pass_yards", yards=250.5))
        rows.append(dict(team=t, player=f"{t} Back", pos="RB", usage=60,
                         stat="rush_yards", yards=80.5))
    rows.append(dict(team="Nowhere U", player="Ghost", pos="QB", usage=50,
                     stat="pass_yards", yards=10.0))
    focus = tmp_path / "players.csv"
    pd.DataFrame(rows).to_csv(focus, index=False)

    games = [("Kansas State", "Iowa State"), ("Alabama", "Georgia")]
    df = simulate_slate_props(
        games, sp_path=sp_path, props_csv=str(focus), focus_csv=str(focus),
        n_pairs=96, mode="analytic", seed=5, min_abs_edge_pct=0.0)
    assert len(df) == 8   # QB + RB per team; the Nowhere U row skipped
    assert set(df.matchup) == {"Kansas State vs Iowa State",
                               "Alabama vs Georgia"}
    for _, r in df.iterrows():
        assert 0.0 <= r.p_over <= 1.0 and 0.0 <= r.p_under <= 1.0
        assert int(r.samples) > 0

    # single-matchup path at the same key reproduces matchup 0's rows
    sp = load_sp_flex(sp_path)
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp,
                                        focus_csv=str(focus))
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp,
                                        focus_csv=str(focus))
    runner = MatchupRunner(a, b, heads, mode="analytic")
    out = runner.run_pairs(96, key=jax.random.fold_in(jax.random.PRNGKey(5), 0),
                           collect_players=True)
    single = scan_props_device(out, a, b, str(focus), min_abs_edge_pct=0.0)
    assert len(single) == 4
    sub = df[df.matchup == "Kansas State vs Iowa State"]
    for _, srow in single.iterrows():
        drow = sub[(sub.player == srow.player) & (sub.stat == srow.stat)]
        assert len(drow) == 1, (srow.player, srow.stat)
        drow = drow.iloc[0]
        for col in ("p_over", "p_under", "mean", "median", "samples",
                    "edge_pct", "ev_$100"):
            assert srow[col] == drow[col], col


def test_simulate_slate_props_sharded(reference_dir, tmp_path):
    """shard=True shards each prop sim's trial axis over the 8-device mesh;
    the reduction jit consumes sharded pstats (GSPMD inserts the sums).
    Sharded and unsharded scans agree within MC error."""
    from fast_monte_carlo.api import simulate_slate_props
    from fast_monte_carlo.models.heads import load_heads

    heads = load_heads(reference_dir)
    s1_cats = heads.stage1.layout.categories["passer_name"]
    qb = s1_cats[sorted(
        set(heads.stage1.used_cat_locals("passer_name").tolist()))[0]]
    focus = tmp_path / "players.csv"
    pd.DataFrame([dict(team="Kansas State", player=qb, pos="QB", usage=80,
                       stat="pass_yards", yards=230.5)]).to_csv(focus,
                                                                index=False)
    kw = dict(sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
              props_csv=str(focus), focus_csv=str(focus), n_pairs=256,
              mode="analytic", seed=9, min_abs_edge_pct=0.0)
    got = simulate_slate_props([("Kansas State", "Iowa State")],
                               shard=True, **kw)
    want = simulate_slate_props([("Kansas State", "Iowa State")],
                                shard=False, **kw)
    assert len(got) == 1 and len(want) == 1
    assert abs(got.iloc[0].p_over - want.iloc[0].p_over) < 0.12
    assert abs(got.iloc[0]["mean"] - want.iloc[0]["mean"]) < 25.0
    assert int(got.iloc[0].samples) > 0


def test_simulate_slate_summaries_return_summaries(reference_dir):
    from fast_monte_carlo.api import simulate_slate_summaries
    from fast_monte_carlo.edge import market_odds_from_summary

    sp_path = str(reference_dir / "PregameSPPlus2025_1.csv")
    games = [("Kansas State", "Iowa State"), ("Alabama", "Georgia")]
    df, summs = simulate_slate_summaries(
        games, sp_path=sp_path, n_pairs=128, mode="analytic", seed=3,
        chunk_pairs=128, return_summaries=True)
    assert len(summs) == 2
    for i in range(2):
        assert int(np.asarray(summs[i].n)) == int(df.iloc[i].n_games)
        assert float(summs[i].margin_hist.sum()) == pytest.approx(
            float(summs[i].n))
    lines = pd.DataFrame([
        {"team_a": "Kansas State", "spread": -3.5, "total": 55.5},
        {"team_a": "Alabama", "spread": 2.5, "total": 51.0},
    ])
    tab = slate_market_table(games, summs, lines)
    mk = market_odds_from_summary(summs[0], "Kansas State", "Iowa State",
                                  spread=-3.5, total=55.5)
    assert tab.iloc[0].p_cover_a == mk["spread"]["p_cover"]
    assert tab.iloc[0].p_over == mk["total"]["p_over"]
    # hist-derived moneyline == the summary's win rate (margin>0 <=> win)
    for i in range(2):
        assert tab.iloc[i].p_win_a == pytest.approx(df.iloc[i].win_a,
                                                    abs=1e-6)


def test_simulate_slate_props_mixed_pad_groups(reference_dir, tmp_path):
    """Matchups whose prop counts pad to DIFFERENT sizes (8 vs 16) land in
    separate stacked-readback groups (api.simulate_slate_props packs one
    (8, P) array per matchup and transfers one stack per padded P); the
    grouped transfer must map every field back to the right matchup.  The
    16-pad matchup is cross-checked bitwise against the single-matchup
    scan_props_device at the same fold_in key."""
    import jax

    from fast_monte_carlo.api import MatchupRunner, simulate_slate_props
    from fast_monte_carlo.data import (
        build_team_context_from_sp_flex, load_sp_flex,
    )
    from fast_monte_carlo.edge import scan_props_device
    from fast_monte_carlo.models.heads import load_heads

    sp_path = str(reference_dir / "PregameSPPlus2025_1.csv")
    heads = load_heads(reference_dir)
    s1_cats = heads.stage1.layout.categories["passer_name"]
    s1_used = sorted(set(heads.stage1.used_cat_locals("passer_name").tolist()))
    teams = ["Kansas State", "Iowa State", "Alabama", "Georgia"]
    rows = []
    for t, qi in zip(teams, s1_used[:4]):
        rows.append(dict(team=t, player=s1_cats[qi], pos="QB", usage=60,
                         stat="pass_yards", yards=250.5))
        rows.append(dict(team=t, player=f"{t} Back", pos="RB", usage=50,
                         stat="rush_yards", yards=80.5))
    # pad matchup 2 past one 8-row bucket: 4 receivers a side -> 16 rows
    for t in ("Alabama", "Georgia"):
        for wi in range(4):
            rows.append(dict(team=t, player=f"{t} WR{wi}", pos="WR",
                             usage=20, stat="rec_yards",
                             yards=40.5 + 5 * wi))
    focus = tmp_path / "players.csv"
    pd.DataFrame(rows).to_csv(focus, index=False)

    games = [("Kansas State", "Iowa State"), ("Alabama", "Georgia")]
    df = simulate_slate_props(
        games, sp_path=sp_path, props_csv=str(focus), focus_csv=str(focus),
        n_pairs=96, mode="analytic", seed=11, min_abs_edge_pct=0.0)
    sub1 = df[df.matchup == "Kansas State vs Iowa State"]
    sub2 = df[df.matchup == "Alabama vs Georgia"]
    assert len(sub1) == 4 and len(sub2) == 12

    # matchup index 1 (the 16-pad group) bitwise vs the single-matchup scan
    sp = load_sp_flex(sp_path)
    a = build_team_context_from_sp_flex("Alabama", 2025, 1, sp,
                                        focus_csv=str(focus))
    b = build_team_context_from_sp_flex("Georgia", 2025, 1, sp,
                                        focus_csv=str(focus))
    runner = MatchupRunner(a, b, heads, mode="analytic")
    out = runner.run_pairs(
        96, key=jax.random.fold_in(jax.random.PRNGKey(11), 1),
        collect_players=True)
    single = scan_props_device(out, a, b, str(focus), min_abs_edge_pct=0.0)
    assert len(single) == 12
    for _, srow in single.iterrows():
        drow = sub2[(sub2.player == srow.player) & (sub2.stat == srow.stat)]
        assert len(drow) == 1, (srow.player, srow.stat)
        drow = drow.iloc[0]
        for col in ("p_over", "p_under", "mean", "median", "samples",
                    "edge_pct", "ev_$100"):
            assert srow[col] == drow[col], col
