"""End-to-end API tests: matchup orchestration, player tracking via a focus
sheet, persistence, box scores, and the edge-finder math."""
import numpy as np
import pandas as pd
import pytest

from fast_monte_carlo import (
    SimConfig, csv_base_from, load_heads, simulate_matchup, summary_frame,
)
from fast_monte_carlo.api import players_frame, scores_frame, simulate_upcoming_matchup
from fast_monte_carlo.boxscore import format_boxscore, mean_boxscore
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo import edge as E
from fast_monte_carlo.store import load_sim_bundle, make_signature, save_sim_bundle


@pytest.fixture(scope="module")
def focus_csv(tmp_path_factory):
    p = tmp_path_factory.mktemp("focus") / "week1_players.csv"
    rows = []
    for team, qb, rb, wr in [
        ("Kansas State", "Avery Johnson", "Dylan Edwards", "Jayce Brown"),
        ("Iowa State", "Rocco Becht", "Carson Hansen", "Jaylin Noel"),
    ]:
        rows += [
            dict(team=team, player=qb, pos="QB", usage=95, stat="pass_yards", yards=250),
            dict(team=team, player=rb, pos="RB", usage=55, stat="rush_yards", yards=80),
            dict(team=team, player=wr, pos="WR", usage=30, stat="rec_yards", yards=70),
        ]
    pd.DataFrame(rows).to_csv(p, index=False)
    return str(p)


@pytest.fixture(scope="module")
def contexts(reference_dir, focus_csv):
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp, focus_csv=focus_csv)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp, focus_csv=focus_csv)
    return a, b


def test_focus_usage_tracked_slots(contexts):
    a, _ = contexts
    assert "Avery Johnson" in a.qb.names
    assert a.qb.tracked[a.qb.names.index("Avery Johnson")]
    # remainder goes to the __Other__ sentinel, untracked
    from fast_monte_carlo.data.usage import OTHER_SENTINEL
    assert OTHER_SENTINEL in a.rush.names
    assert not a.rush.tracked[a.rush.names.index(OTHER_SENTINEL)]
    np.testing.assert_allclose(a.qb.share.sum(), 1.0, atol=1e-9)


@pytest.fixture(scope="module")
def sim_result(contexts, reference_dir):
    a, b = contexts
    heads = load_heads(reference_dir)
    cfg = SimConfig()
    sims_df, players_df, runner = simulate_matchup(
        a, b, heads, n=96, cfg=cfg, collect_players=True, mode="analytic")
    return a, b, sims_df, players_df, runner


def test_scores_frame_schema(sim_result):
    a, b, sims_df, _, _ = sim_result
    assert list(sims_df.columns) == ["team", "opp", "pts", "opp_pts"]
    assert len(sims_df) == 192
    assert set(sims_df.team.unique()) == {a.name, b.name}
    s = summary_frame(sims_df)
    assert set(s.index) == {a.name, b.name}
    assert 0 <= s.win_rate.iloc[0] <= 1


def test_players_frame_tracked_only(sim_result):
    a, b, _, players_df, _ = sim_result
    assert not players_df.empty
    names = set(players_df.player.unique())
    assert "Avery Johnson" in names
    assert "__Other__" not in names
    qb_rows = players_df[(players_df.player == "Avery Johnson") &
                         (players_df.role == "QB")]
    assert (qb_rows.pass_att >= qb_rows.pass_comp).all()
    # receivers' targets >= receptions
    rec = players_df[players_df.role == "Receiver"]
    assert (rec.tgt >= rec.rec).all()


def test_boxscore_formatting(sim_result):
    a, b, _, _, runner = sim_result
    out = runner.run_pairs(4, seed=3, collect_players=False)
    txt = mean_boxscore((a.name, b.name), np.asarray(out.stats))
    assert a.name in txt and "YPA" in txt and "RZ" in txt


def test_store_roundtrip(sim_result, tmp_path):
    a, b, sims_df, players_df, _ = sim_result
    meta = {"teams": [a.name, b.name], "n": len(sims_df), "seed": 0}
    sig = save_sim_bundle(tmp_path / "run1", sims_df.assign(sim_id=range(len(sims_df)), seed=0),
                          players_df, meta)
    games, players, meta2 = load_sim_bundle(tmp_path / "run1")
    assert meta2["signature"] == sig == make_signature(meta)
    assert "margin" in games and "total" in games
    assert len(games) == len(sims_df)


def test_edge_math_parity():
    # odds conversions (edge_finder.py:70-119 golden cases)
    assert E.prob_to_american(0.5) == -100
    assert E.prob_to_american(0.6) == -150
    assert E.prob_to_american(0.4) == 150
    np.testing.assert_allclose(E.american_implied_prob(-110), 110 / 210)
    np.testing.assert_allclose(E.ev_per_100(110 / 210, -110), 0.0, atol=1e-9)
    np.testing.assert_allclose(E.ev_per_100_at_minus110(110 / 210), 0.0, atol=1e-9)
    side = E.best_side_ev(0.60)
    assert side["side"] == "Over" and side["ev"] > 0
    side = E.best_side_ev(0.40)
    assert side["side"] == "Under"


def test_game_market_and_moneyline_from_frames(sim_result):
    a, b, sims_df, players_df, _ = sim_result
    gm = E.game_market_odds(None, a.name, b.name, spread=-3.0, total=55.5,
                            sims=sims_df)
    sp = gm["spread"]
    np.testing.assert_allclose(
        sp["p_cover"] + sp["p_notcover"] + sp["push_rate"], 1.0, atol=2e-6)
    tt = gm["total"]
    np.testing.assert_allclose(
        tt["p_over"] + tt["p_under"] + tt["push_rate"], 1.0, atol=2e-6)
    ml = E.moneyline_from_sims(None, a.name, b.name, sims=sims_df)
    assert 0 <= ml["team"]["p_win"] <= 1

    # prop odds against the in-memory players frame
    pdf = players_df.assign(team_low=players_df.team.str.lower(),
                            player_low=players_df.player.str.lower())
    out = E.player_prop_odds(None, a.name, "Avery Johnson", "pass_yards", 250.0,
                             players_df=pdf)
    assert out["p_over"] + out["p_under"] + out["push_rate"] <= 1.0 + 1e-9
    assert out["best_side"] in ("Over", "Under")


def test_edges_file_flow(sim_result, tmp_path, monkeypatch, focus_csv, capsys):
    a, b, sims_df, players_df, _ = sim_result
    monkeypatch.chdir(tmp_path)
    base = csv_base_from(a.name, b.name, 1)
    sims_df.to_csv(f"scores_{base}", index=False)
    players_df.to_csv(f"players_{base}", index=False)
    E.find_edges(csv_base=base, team_a=a.name, team_b=b.name,
                 spread=-3.0, total=55.5, props_csv=focus_csv,
                 min_abs_edge_pct=0.0)
    out = capsys.readouterr().out
    assert "Game Market" in out and "Fair Moneyline" in out
    assert "Mean Score" in out


@pytest.mark.slow
def test_simulate_upcoming_matchup_end_to_end(reference_dir, focus_csv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sims_df, players_df, summary, a, b, meta = simulate_upcoming_matchup(
        "Kansas State", "Iowa State",
        sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
        artifact_dir=str(reference_dir), focus_csv=focus_csv,
        n=32, collect_players=True, mode="analytic",
        save_csv=csv_base_from("Kansas State", "Iowa State", 1))
    assert meta["sims"] == 32 and meta["total_time_sec"] > 0
    assert (tmp_path / f"scores_{csv_base_from('Kansas State', 'Iowa State', 1)}").exists()
    assert len(sims_df) == 64
    assert not players_df.empty


def test_runner_memo_identity(contexts, reference_dir):
    """The slate drivers' runner memo: same (contexts, heads, cfg, mode,
    quality, shard) -> the same MatchupRunner instance; any knob change ->
    a fresh one.  Contexts/heads are content-memoized singletons, so
    instance identity is the staleness signal."""
    from fast_monte_carlo import api

    a, b = contexts
    heads = load_heads(reference_dir)
    cfg = SimConfig()
    r1 = api._runner_for(a, b, heads, cfg, "analytic", "nano", False)
    assert api._runner_for(a, b, heads, cfg, "analytic", "nano", False) is r1
    assert api._runner_for(a, b, heads, cfg, "analytic", "nano", True) is not r1
    assert api._runner_for(b, a, heads, cfg, "analytic", "nano", False) is not r1


def test_cli_slate_lines(reference_dir, tmp_path, capsys):
    """cli slate --lines: per-matchup market edges priced off the device
    summaries (the unsharded default routes through the summary sweep)."""
    import pandas as pd

    from fast_monte_carlo.cli import main

    games_csv = tmp_path / "games.csv"
    pd.DataFrame({"team_a": ["Kansas State"],
                  "team_b": ["Iowa State"]}).to_csv(games_csv, index=False)
    lines_csv = tmp_path / "lines.csv"
    pd.DataFrame({"team_a": ["Kansas State"], "spread": [-3.5],
                  "total": [55.5]}).to_csv(lines_csv, index=False)
    rc = main([
        "slate", "--games", str(games_csv),
        "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
        "-n", "64", "--mode", "analytic", "--lines", str(lines_csv),
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Slate Market Edges" in out
    assert "Spread Kansas State -3.5" in out
    assert "Total 55.5" in out


def test_cli_slate_lines_batched_rejected_before_sim(tmp_path, capsys):
    """--lines + --batched is knowable-invalid at argument time: the CLI
    must refuse BEFORE simulating (pricing needs device summaries the
    batched path never accumulates)."""
    import pandas as pd

    from fast_monte_carlo.cli import main

    games_csv = tmp_path / "games.csv"
    pd.DataFrame({"team_a": ["A"], "team_b": ["B"]}).to_csv(games_csv, index=False)
    lines_csv = tmp_path / "lines.csv"
    pd.DataFrame({"team_a": ["A"], "spread": [-3.5]}).to_csv(lines_csv, index=False)
    rc = main([
        "slate", "--games", str(games_csv), "--sp", "/nonexistent.csv",
        "-n", "64", "--batched", "--lines", str(lines_csv),
    ])
    out = capsys.readouterr().out
    # rejected up front: nonexistent --sp was never read, nothing simulated
    assert rc == 2
    assert "no simulation run" in out


def test_cli_slate_props(reference_dir, tmp_path, capsys):
    """cli slate --props: whole-slate prop scan with device reductions."""
    import pandas as pd

    from fast_monte_carlo.cli import main

    from fast_monte_carlo.models.heads import load_heads

    heads = load_heads(reference_dir)
    s1_cats = heads.stage1.layout.categories["passer_name"]
    qb = s1_cats[sorted(
        set(heads.stage1.used_cat_locals("passer_name").tolist()))[0]]
    games_csv = tmp_path / "games.csv"
    pd.DataFrame({"team_a": ["Kansas State"],
                  "team_b": ["Iowa State"]}).to_csv(games_csv, index=False)
    props_csv = tmp_path / "props.csv"
    pd.DataFrame({"team": ["Kansas State"], "player": [qb], "pos": ["QB"],
                  "usage": [80], "stat": ["pass_yards"],
                  "yards": [250.5]}).to_csv(props_csv, index=False)
    rc = main([
        "slate", "--games", str(games_csv),
        "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
        "-n", "32", "--mode", "analytic", "--props", str(props_csv),
        "--props-n", "64", "--min-edge", "0", "--focus", str(props_csv),
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Player Props value" in out and "[Passing]" in out


def test_cli_edges_device(reference_dir, tmp_path, capsys):
    """cli edges --device: sim + markets + props entirely on-device."""
    import pandas as pd

    from fast_monte_carlo.cli import main

    props = tmp_path / "props.csv"
    pd.DataFrame({
        "team": ["Kansas State"], "player": ["Unknown"],
        "stat": ["pass_yards"], "yards": [250.5],
    }).to_csv(props, index=False)
    rc = main([
        "edges", "--device", "--team-a", "Kansas State",
        "--team-b", "Iowa State",
        "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
        "-n", "128", "--spread", "-3", "--total", "58.5",
        "--props", str(props), "--quality", "nano",
        "--alt", "--alt-width", "3", "--alt-step", "1",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Game Market" in out and "Total:" in out
    assert "Alternate Spreads" in out and "Alternate Totals" in out
    assert "simulated + reduced on" in out


@pytest.mark.slow
def test_cli_sim_then_file_edges(reference_dir, tmp_path, capsys, monkeypatch):
    """The reference's end-to-end workflow via the CLI: `sim --save` writes
    scores_/players_ files, then the file-based `edges` command (no
    --device) discovers them by fuzzy team match and prints the market
    report (edge_finder.py find_edges :586-614 over saved files)."""
    from fast_monte_carlo.cli import main

    monkeypatch.chdir(tmp_path)
    rc = main([
        "sim", "Kansas State", "Iowa State",
        "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
        "-n", "24", "--mode", "analytic", "--save", "--players",
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "sims/sec" in out and "saved scores_" in out
    saved = list(tmp_path.glob("scores_*"))
    assert saved, "sim --save wrote no scores file"

    rc = main([
        "edges", "--team-a", "Kansas State", "--team-b", "Iowa State",
        "--spread", "-3.5", "--total", "55.5", "--dir", str(tmp_path),
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Game Market" in out and "Moneyline" in out


def test_cli_train(tmp_path, capsys):
    """`cli train` drives the pipeline recipes from a plays csv: train the
    sack quantile heads small and check the artifacts load."""
    import joblib
    import numpy as np
    import pandas as pd

    from fast_monte_carlo.cli import main
    from fast_monte_carlo.train import pipeline as P

    rng = np.random.default_rng(3)
    n = 600
    df = pd.DataFrame({
        "down": rng.integers(1, 5, n), "distance": rng.uniform(1, 15, n).round(1),
        "yardsToGoal": rng.integers(1, 100, n).astype(float),
        "score_diff": rng.integers(-21, 22, n),
        "seconds_remaining": rng.integers(0, 3601, n),
        "offenseTimeouts": 3, "defenseTimeouts": 3,
        "sp_rating_off": rng.normal(5, 10, n).round(1),
        "sp_offense_rating_off": rng.normal(30, 7, n).round(1),
        "sp_defense_rating_def": rng.normal(25, 7, n).round(1),
        "sp_rating_def": rng.normal(5, 10, n).round(1),
        "passer_name": rng.choice(["Qb One", "Qb Two"], n),
        "target_name": rng.choice(["Wr One", "Wr Two"], n),
        "rusher_name": rng.choice(["Rb One", "Rb Two"], n),
        "pass_outcome": rng.choice(["complete", "incomplete", "sack"], n,
                                   p=[0.6, 0.3, 0.1]),
        "yardsGained": -rng.uniform(0, 12, n).round(0),
    })
    df = P.derive_state_features(df)
    data = tmp_path / "plays.csv"
    df.to_csv(data, index=False)
    out_dir = tmp_path / "artifacts"
    rc = main(["train", "--data", str(data), "--out", str(out_dir),
               "--heads", "sack", "--trees", "10"])
    assert rc == 0
    assert "sack quantiles ->" in capsys.readouterr().out
    for q in (10, 50, 90):
        m = joblib.load(out_dir / f"sack_yards_q{q}.joblib")
        assert hasattr(m, "predict")
