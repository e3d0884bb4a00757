"""Backtest/calibration harness (backtest.py).  Referees: hand-computed
Brier/logloss/ECE and PIT cases, orientation-aware join semantics, PIT
uniformity when outcomes really do come from the forecast distribution,
and an end-to-end run off real slate summaries."""
import numpy as np
import pandas as pd
import pytest

from fast_monte_carlo.backtest import (
    calibration_report, join_results, ks_uniform, pit_values,
    point_metrics, win_calibration,
)


def _preds(rows):
    cols = ["team_a", "team_b", "win_a", "mean_margin_a", "mean_total"]
    return pd.DataFrame(rows, columns=cols)


def test_join_results_orientations_and_misses():
    preds = _preds([("Kansas State", "Iowa State", 0.6, 3.0, 50.0),
                    ("Texas", "Ohio State", 0.5, 0.0, 55.0),
                    ("Baylor", "Kansas", 0.5, 1.0, 48.0)])
    results = pd.DataFrame({
        "team_a": ["iowa state", "Texas"],       # reversed / same order
        "team_b": ["KANSAS STATE", "Ohio State"],
        "score_a": [20, 21], "score_b": [27, 21]})
    j = join_results(preds, results)
    assert len(j) == 2  # Baylor game unmatched -> dropped
    ksu = j[j["team_a"] == "Kansas State"].iloc[0]
    assert (ksu["actual_a"], ksu["actual_b"]) == (27, 20)  # flipped back
    assert ksu["actual_margin_a"] == 7 and ksu["won_a"] == 1.0
    tie = j[j["team_a"] == "Texas"].iloc[0]
    assert tie["won_a"] == 0.0 and tie["actual_margin_a"] == 0


def test_join_results_rematch_fifo():
    """The same two teams twice (regular season + championship rematch):
    the k-th prediction row for the pair must score against the k-th
    results row, not have the later final silently overwrite both."""
    preds = _preds([("Kansas State", "Iowa State", 0.6, 3.0, 50.0),
                    ("Iowa State", "Kansas State", 0.4, -3.0, 50.0)])
    results = pd.DataFrame({
        "team_a": ["Kansas State", "iowa state"],
        "team_b": ["Iowa State", "kansas state"],
        "score_a": [24, 31], "score_b": [20, 10]})
    j = join_results(preds, results)
    assert len(j) == 2
    first, second = j.iloc[0], j.iloc[1]
    assert (first["actual_a"], first["actual_b"]) == (24, 20)
    # second prediction row is ISU-first; second result row is ISU 31-10
    assert (second["actual_a"], second["actual_b"]) == (31, 10)
    assert list(j["_pred_index"]) == [0, 1]
    # one result for two predictions: only the first consumes it
    j2 = join_results(preds, results.iloc[:1])
    assert len(j2) == 1 and j2.iloc[0]["_pred_index"] == 0


def test_win_calibration_hand_case():
    p = [0.8, 0.8, 0.2]
    y = [1.0, 0.0, 0.0]
    w = win_calibration(p, y, bins=5)
    assert w["brier"] == pytest.approx((0.04 + 0.64 + 0.04) / 3, abs=1e-5)
    ll = -(np.log(0.8) + np.log(0.2) + np.log(0.8)) / 3
    assert w["logloss"] == pytest.approx(ll, abs=1e-5)
    # bins: [0.0,0.2) holds p=0.2? digitize(edges[1:-1]) puts 0.2 in bin 1
    tb = {(r["bin_lo"], r["bin_hi"]): r for r in w["reliability"]}
    assert tb[(0.8, 1.0)]["n"] == 2
    assert tb[(0.8, 1.0)]["frac_won"] == pytest.approx(0.5)
    # ECE = sum over bins of weight * |gap|
    ece = (2 / 3) * abs(0.5 - 0.8) + (1 / 3) * abs(0.0 - 0.2)
    assert w["ece"] == pytest.approx(ece, abs=1e-5)


def test_point_metrics_hand_case():
    m = point_metrics([3.0, -2.0, 5.0], [1.0, -2.0, 9.0])
    assert m["bias"] == pytest.approx((2 + 0 - 4) / 3, abs=1e-3)
    assert m["mae"] == pytest.approx(2.0)
    assert m["rmse"] == pytest.approx(np.sqrt((4 + 0 + 16) / 3), abs=1e-3)


def test_pit_values_hand_case():
    h = np.array([1.0, 2.0, 1.0])  # support -1, 0, 1
    pit = pit_values([h] * 4, -1.0, [0.0, -1.0, 5.0, -5.0])
    np.testing.assert_allclose(pit, [0.5, 0.125, 1.0, 0.0])


def test_ks_uniform():
    n = 1000
    perfect = (np.arange(n) + 0.5) / n
    assert ks_uniform(perfect) < 0.001
    assert ks_uniform(np.full(n, 0.5)) == pytest.approx(0.5, abs=0.01)


def test_pit_uniform_when_outcomes_match_forecast():
    """If actual outcomes are drawn FROM the forecast histograms, the
    mid-p PIT is uniform — KS below the 95% critical distance."""
    rng = np.random.default_rng(7)
    support0, width = -30.0, 61
    hists, actuals = [], []
    for _ in range(2000):
        center = rng.integers(-8, 9)
        x = np.arange(width) + support0
        h = np.exp(-0.5 * ((x - center) / 9.0) ** 2)
        hists.append(h)
        actuals.append(float(rng.choice(x, p=h / h.sum())))
    pit = pit_values(hists, support0, actuals)
    assert ks_uniform(pit) < 1.36 / np.sqrt(len(pit))
    # a shifted reality is caught loudly
    pit_bad = pit_values(hists, support0, np.asarray(actuals) + 6.0)
    assert ks_uniform(pit_bad) > 3 * 1.36 / np.sqrt(len(pit_bad))


def test_calibration_report_requires_a_match():
    preds = _preds([("A", "B", 0.6, 3.0, 50.0)])
    results = pd.DataFrame({"team_a": ["C"], "team_b": ["D"],
                            "score_a": [10], "score_b": [7]})
    with pytest.raises(ValueError, match="no prediction rows"):
        calibration_report(preds, results)


def test_cli_backtest(reference_dir, tmp_path, capsys):
    from fast_monte_carlo.cli import main

    finals = tmp_path / "finals.csv"
    pd.DataFrame({
        "team_a": ["Kansas State"], "team_b": ["Iowa State"],
        "score_a": [24], "score_b": [21]}).to_csv(finals, index=False)
    rc = main([
        "backtest", "--results", str(finals),
        "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
        "-n", "256", "--mode", "analytic", "--bins", "5",
        "--artifacts", str(reference_dir),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Backtest: 1 games" in out and "brier" in out and "PIT" in out
    # missing required columns is a clean usage error
    bad = tmp_path / "bad.csv"
    pd.DataFrame({"home": ["x"], "away": ["y"]}).to_csv(bad, index=False)
    assert main(["backtest", "--results", str(bad), "--sp", "unused"]) == 2


@pytest.mark.slow
def test_backtest_slate_end_to_end(reference_dir):
    """Full path off real sims: simulate two matchups, score them against
    plausible finals, and check every report block is populated and the
    PIT values are honest probabilities."""
    from fast_monte_carlo.backtest import backtest_slate

    results = pd.DataFrame({
        "team_a": ["Iowa State", "Kansas State"],  # one row reversed
        "team_b": ["Kansas State", "Kansas"],
        "score_a": [20, 31], "score_b": [24, 28]})
    rep = backtest_slate(
        [("Kansas State", "Iowa State"), ("Kansas State", "Kansas")],
        results, sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
        n_pairs=512, mode="analytic", seed=11)
    assert rep["games"] == 2 and rep["win"]["n"] == 2
    assert 0.0 < rep["win"]["brier"] < 1.0
    assert rep["margin"]["rmse"] > 0 and rep["total"]["mae"] > 0
    assert "pit" in rep
    rows = rep["rows"]
    assert ((rows["pit_margin"] > 0) & (rows["pit_margin"] < 1)).all()
    assert ((rows["pit_total"] > 0) & (rows["pit_total"] < 1)).all()
    # the reversed results row joined back in prediction orientation
    ksu = rows[rows["team_b"] == "Iowa State"].iloc[0]
    assert (ksu["actual_a"], ksu["actual_b"]) == (24, 20)


def test_dist_affine_and_market_calibration():
    """Opt-in affine calibration (round 5): Dist.affine shifts location /
    scales dispersion about the mean in BOTH representations; the
    MarketCalibration wrapper keeps spread + moneyline + total mutually
    consistent through market_odds_from_summary."""
    from fast_monte_carlo.edge import Dist, MarketCalibration

    rng = np.random.default_rng(0)
    vals = rng.normal(55.0, 10.0, 4000)
    d = Dist.from_values(vals)
    d2 = d.affine(shift=-15.0)
    assert d2.mean() == pytest.approx(d.mean() - 15.0, abs=1e-9)
    assert d2.n == d.n
    d3 = d.affine(scale=2.0)
    assert d3.mean() == pytest.approx(d.mean(), abs=1e-6)
    assert np.std(d3.values) == pytest.approx(2 * np.std(vals), rel=1e-9)
    # histogram path: support transforms, counts untouched
    cnt = np.array([1.0, 2.0, 3.0])
    h = Dist.from_hist(cnt, np.array([50.0, 55.0, 60.0]))
    h2 = h.affine(shift=-15.0)
    assert h2.mean() == pytest.approx(h.mean() - 15.0, abs=1e-9)
    assert (h2.counts == cnt).all() and h2.n == h.n
    assert h.affine() is h     # identity short-circuits
    c = MarketCalibration(total_shift=-15.0, margin_shift=2.0)
    assert c.total(h).mean() == pytest.approx(h.mean() - 15.0, abs=1e-9)
    assert c.margin(h).mean() == pytest.approx(h.mean() + 2.0, abs=1e-9)


def test_fit_calibration_from_report():
    """fit_calibration returns the negated point biases as shifts, with
    per-shift SEs, consumable by market_odds_from_summary."""
    from fast_monte_carlo.backtest import fit_calibration
    from fast_monte_carlo.edge import MarketCalibration

    rows = pd.DataFrame({
        "mean_margin_a": [5.0, 3.0, -2.0, 6.0],
        "actual_margin_a": [1.0, -1.0, -4.0, 2.0],   # model +3.5 hot
        "mean_total": [60.0, 55.0, 50.0, 58.0],
        "actual_total": [45.0, 41.0, 36.0, 42.0],    # model +14.75 hot
    })
    c, ses = fit_calibration({"rows": rows})
    assert isinstance(c, MarketCalibration)
    assert c.margin_shift == pytest.approx(-3.5)
    assert c.total_shift == pytest.approx(-14.75)
    assert c.margin_scale == 1.0 and c.total_scale == 1.0
    assert ses["margin_shift_se"] > 0 and ses["total_shift_se"] > 0
