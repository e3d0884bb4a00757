"""Table mode with a real focus roster: per-slot table rows, passer-target
pair maps, fused-build fallback, and player-stat parity vs the oracle."""
import numpy as np
import pandas as pd
import pytest

from fast_monte_carlo.api import MatchupRunner, players_frame
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.models.tables import slate_profile
from fast_monte_carlo.oracle import OracleMatchup
from fast_monte_carlo.stats import PC_ATT, PC_YDS, ROLE_PASS, ROLE_REC


@pytest.fixture(scope="module")
def focus_env(reference_dir, tmp_path_factory):
    heads = load_heads(reference_dir)
    # pick player names the stage-1/quantile models actually know, so slot
    # dedupe keeps DISTINCT table rows and the pair map is non-trivial
    s1_cats = heads.stage1.layout.categories["passer_name"]
    pq_t_cats = heads.pass_quants[0].layout.categories["target_name"]
    s1_used = set(heads.stage1.used_cat_locals("passer_name").tolist())
    qb_a, qb_b = [s1_cats[i] for i in sorted(s1_used)[:2]]
    tg_used = set(heads.pass_quants[0].used_cat_locals("target_name").tolist())
    wr_names = [pq_t_cats[i] for i in sorted(tg_used)[:4]]

    rows = []
    for team, qb, wrs in [("Kansas State", qb_a, wr_names[:2]),
                          ("Iowa State", qb_b, wr_names[2:])]:
        rows.append(dict(team=team, player=qb, pos="QB", usage=80,
                         stat="pass_yards", yards=250))
        rows.append(dict(team=team, player=f"{team} Back", pos="RB", usage=60,
                         stat="rush_yards", yards=80))
        for w in wrs:
            rows.append(dict(team=team, player=w, pos="WR", usage=30,
                             stat="rec_yards", yards=60))
    p = tmp_path_factory.mktemp("focus") / "players.csv"
    pd.DataFrame(rows).to_csv(p, index=False)

    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp, focus_csv=str(p))
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp, focus_csv=str(p))
    return heads, a, b, (qb_a, qb_b), str(p)


def test_multislot_tables_and_pair_map(focus_env):
    heads, a, b, qbs, _ = focus_env
    cfg = SimConfig()
    prof = slate_profile()
    r = MatchupRunner(a, b, heads, cfg, mode="table", table_quality="slate")
    th = r.heads_state
    # fused must have fallen back: known passers make stage1 player-dependent
    assert th.fused is None
    assert th.stage1 is not None
    # distinct stage1 rows for the two known QBs + pair table present
    assert th.stage1.row_map.shape == (2, 8)
    assert th.pq.is_pair and th.pq.row_map.shape == (2, 64)

    out = r.run_pairs(192, seed=0, collect_players=True)
    sc = np.asarray(out.score)
    assert 10 < sc.mean() < 60
    ps = np.asarray(out.pstats)
    # tracked QBs accrued attempts
    qb_slot_a = a.qb.names.index(qbs[0])
    assert ps[:, 0, ROLE_PASS, qb_slot_a, PC_ATT].sum() > 0
    df = players_frame(out, a, b)
    assert qbs[0] in set(df.player)


@pytest.mark.slow
def test_player_stats_match_oracle(focus_env):
    heads, a, b, qbs, _ = focus_env
    cfg = SimConfig()
    r = MatchupRunner(a, b, heads, cfg, mode="table", table_quality="slate")
    out = r.run_pairs(768, seed=3, collect_players=True)
    e_ps = np.asarray(out.pstats).mean(axis=0)

    m = OracleMatchup(a, b, heads, cfg)
    rng = np.random.default_rng(0)
    res = [m.simulate_game(i % 2, rng) for i in range(160)]
    o_ps = np.mean([x["pstats"] for x in res], axis=0)

    qb_slot = a.qb.names.index(qbs[0])
    # per-game pass attempts and yards for the tracked QB within loose MC+
    # binning bounds
    e_att = e_ps[0, ROLE_PASS, qb_slot, PC_ATT]
    o_att = o_ps[0, ROLE_PASS, qb_slot, PC_ATT]
    assert abs(e_att - o_att) < max(3.5, 0.15 * o_att), (e_att, o_att)
    e_yds = e_ps[0, ROLE_PASS, qb_slot, PC_YDS]
    o_yds = o_ps[0, ROLE_PASS, qb_slot, PC_YDS]
    assert abs(e_yds - o_yds) < max(45.0, 0.18 * o_yds), (e_yds, o_yds)
    # receivers: total team targets comparable
    e_tgt = e_ps[0, ROLE_REC, :, PC_ATT].sum()
    o_tgt = o_ps[0, ROLE_REC, :, PC_ATT].sum()
    assert abs(e_tgt - o_tgt) < max(3.0, 0.2 * o_tgt), (e_tgt, o_tgt)


def test_scan_props_device(focus_env):
    """On-device prop scan consumes device pstats directly and reproduces
    the file-based player_prop_odds math (edge_finder.py:340-390)."""
    import jax

    from fast_monte_carlo.api import MatchupRunner, players_frame
    from fast_monte_carlo.config import SimConfig
    from fast_monte_carlo.edge import scan_props_device, scan_props_for_matchup

    heads, a, b, qbs, focus_csv = focus_env
    runner = MatchupRunner(a, b, heads, SimConfig(), mode="table")
    out = runner.run_pairs(192, seed=5, collect_players=True)

    df = scan_props_device(out, a, b, focus_csv, min_abs_edge_pct=0.0)
    assert not df.empty
    assert {"team", "player", "stat", "line", "best_side", "edge_pct",
            "p_over", "p_under", "mean", "median"} <= set(df.columns)
    assert ((df.p_over >= 0) & (df.p_over <= 1)).all()
    assert ((df.p_over + df.p_under) <= 1.0 + 1e-9).all()

    # parity with the pandas/file path on the same GameState
    pdf = players_frame(out, a, b)
    want = scan_props_for_matchup(None, a.name, b.name, focus_csv,
                                  min_abs_edge_pct=0.0, players_df=pdf)
    got = df.set_index(["team", "player", "stat"])
    for _, w in want.iterrows():
        g = got.loc[(w["team"], w["player"], w["stat"])]
        # the file path rounds yardages to 1 decimal (players_frame, like the
        # reference flatten); the device path compares raw f32 sums — trials
        # within 0.05 of the line can flip side, so allow a small tolerance
        assert abs(float(g.p_over) - float(w.p_over)) < 0.01, (w, g)
        assert abs(float(g["mean"]) - float(w["mean"])) < 0.05
