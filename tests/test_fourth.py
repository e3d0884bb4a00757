"""4th-down decision evaluation: forced first-play go/fg/punt choices vs
the sampled policy (api.evaluate_fourth_down / MatchupRunner.
run_fourth_decision / FourthDownConfig.force).

No reference counterpart — handle_fourth always samples its policy
(fast_monte_carlo_cfb.py:1394-1421) — so the referees here are
hand-computable one-play endgames (the forced play's outcome distribution
is a closed-form special-teams curve) and internal-consistency checks.
"""
import dataclasses

import numpy as np
import pytest

from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import (
    build_team_context_from_sp_flex, load_sp_flex,
)
from fast_monte_carlo.models import analytic
from fast_monte_carlo.ops.game import Situation


@pytest.fixture(scope="module")
def runner(reference_dir):
    cfg = SimConfig()
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    return MatchupRunner(a, b, None, cfg, mode="analytic")


def _one_play_left(**kw):
    """A 4th down with so little clock the game ends after the first play
    (any play charge >= 5s), making the forced play's outcome the game."""
    base = dict(offense=0, sec=5, down=4, dist=10.0, ytg=20.0,
                score_a=0, score_b=0)
    return Situation(**{**base, **kw})


def test_forced_fg_one_play_endgame(runner):
    """Forced FG with 5s left at the 20, 0-0: win_a == P(make 37-yarder),
    tie == 1 - P(make) — the entire game is one closed-form kick."""
    cfg = runner.cfg
    res = runner.run_fourth_decision(_one_play_left(), n_games=8192,
                                     seed=3, choices=("fg", "punt"))
    p_fg = float(analytic.field_goal_prob(
        20.0 + cfg.st.fg_snap_plus_endzone, cfg))
    fg = res["fg"]
    se = np.sqrt(p_fg * (1 - p_fg) / 8192)
    assert abs(float(fg.win_rate[0]) - p_fg) < 5 * se, \
        (float(fg.win_rate[0]), p_fg)
    assert abs(float(fg.tie_rate) - (1 - p_fg)) < 5 * se
    assert float(fg.mean_pts[1]) == 0.0          # B never touches the ball
    # forced punt from the same state: nobody scores, every game ties
    pt = res["punt"]
    assert float(pt.tie_rate) == 1.0
    assert float(pt.mean_pts[0]) == 0.0


def test_forced_go_worse_than_fg_long_distance(runner):
    """4th-and-10 at the 20 with 5s left: one snap for the TD is far less
    likely than a 37-yard FG, so forced-go win prob must be lower."""
    res = runner.run_fourth_decision(_one_play_left(dist=10.0),
                                     n_games=8192, seed=7,
                                     choices=("go", "fg"))
    wa_go = float(res["go"].win_rate[0])
    wa_fg = float(res["fg"].win_rate[0])
    assert 0.0 <= wa_go < wa_fg, (wa_go, wa_fg)


def test_force_applies_to_first_play_only(runner):
    """Forcing 'punt' from a FULL-clock 4th down must not force the rest
    of the game: both teams still score normally afterwards (a whole-game
    punt force would hold the offense's 4th-down points near zero)."""
    sit = Situation(offense=0, sec=3000, down=4, dist=1.0, ytg=45.0,
                    score_a=0, score_b=0)
    res = runner.run_fourth_decision(sit, n_games=4096, seed=11,
                                     choices=("policy", "punt"))
    mt_punt = float(res["punt"].mean_pts[0] + res["punt"].mean_pts[1])
    mt_policy = float(res["policy"].mean_pts[0] + res["policy"].mean_pts[1])
    assert mt_punt > 20.0, mt_punt          # the game went on normally
    # the single changed play can't move a 50-min game's total by much
    assert abs(mt_punt - mt_policy) < 6.0, (mt_punt, mt_policy)


def test_whole_game_force_differs_from_first_play_force(runner):
    """FourthDownConfig.force on the runner's own cfg forces EVERY 4th
    down (documented foot-gun); the evaluator's first-play-only semantics
    must diverge from it.  All-punt teams attempt no FGs."""
    cfg_all_punt = dataclasses.replace(
        runner.cfg, fourth=dataclasses.replace(runner.cfg.fourth,
                                               force="punt"))
    all_punt = MatchupRunner(runner.team_a, runner.team_b, None,
                             cfg_all_punt, mode="analytic")
    sit = Situation(offense=0, sec=3000, down=4, dist=1.0, ytg=45.0,
                    score_a=0, score_b=0)
    s_all = all_punt.run_live(sit, n_games=2048, seed=2)
    res = runner.run_fourth_decision(sit, n_games=2048, seed=2,
                                     choices=("punt",))
    # every-4th-punt games can only score TDs (7s); first-play-only games
    # keep FGs, so 3-point-granularity scores appear
    pts_all = np.asarray(s_all.pts_hist)[0]
    pts_one = np.asarray(res["punt"].pts_hist)[0]
    fg_scores = [3, 10, 13, 16]     # totals needing at least one FG
    assert sum(int(pts_one[p]) for p in fg_scores) > 0
    assert sum(int(pts_all[p]) for p in fg_scores) == 0


def test_crn_pairing_tightens_deltas(runner):
    """Choices share continuation draw streams: two choices whose forced
    play rarely differs in effect ('fg' and 'punt' from 4th-and-goal at
    the 2 ... both leave B deep) should have deltas far tighter than
    independent 2048-game runs.  Weak-form check: the same call twice is
    bitwise-identical per choice (determinism in (seed, choice))."""
    sit = _one_play_left(ytg=2.0, dist=2.0)
    r1 = runner.run_fourth_decision(sit, n_games=512, seed=5)
    r2 = runner.run_fourth_decision(sit, n_games=512, seed=5)
    for c in r1:
        np.testing.assert_array_equal(np.asarray(r1[c].margin_hist),
                                      np.asarray(r2[c].margin_hist))


def test_validation(runner):
    with pytest.raises(ValueError):   # not a 4th down
        runner.run_fourth_decision(
            Situation(0, 600, 3, 2.0, 30.0, 0, 0), n_games=64)
    with pytest.raises(ValueError):   # unknown choice
        runner.run_fourth_decision(_one_play_left(), n_games=64,
                                   choices=("teleport",))
    with pytest.raises(ValueError, match="n_games"):
        runner.run_fourth_decision(_one_play_left(), n_games=0)
    with pytest.raises(ValueError, match="at least one"):
        runner.run_fourth_decision(_one_play_left(), n_games=64,
                                   choices=())


def test_play_step_force_validation():
    """play_step rejects unknown fourth.force values at trace time."""
    import jax

    from fast_monte_carlo.ops.game import (
        initial_state, make_analytic_heads_eval, play_step,
    )
    from fast_monte_carlo.ops.pack import build_packs
    cfg = SimConfig()
    bad = dataclasses.replace(
        cfg, fourth=dataclasses.replace(cfg.fourth, force="teleport"))
    sp = load_sp_flex("seeded:0")
    a = build_team_context_from_sp_flex("Team 030", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Team 041", 2025, 1, sp)
    from fast_monte_carlo.models.heads import load_heads
    pack, _ = build_packs(a, b, load_heads("seeded:0"), cfg)
    st = initial_state(4, 0, cfg, pack.k)
    with pytest.raises(ValueError):
        play_step(st, jax.random.PRNGKey(0), pack, bad,
                  make_analytic_heads_eval(bad), None, True)


def test_oracle_force_first_closed_form(reference_dir):
    """The oracle's force_first knob reproduces the same closed-form
    one-play endgames as the engine's forced play: fg with 5s left at the
    20 wins iff the 37-yard kick is good; punt ties every game."""
    from fast_monte_carlo.models.heads import load_heads
    from fast_monte_carlo.oracle import OracleMatchup

    cfg = SimConfig()
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    m = OracleMatchup(a, b, load_heads(str(reference_dir)), cfg)
    sit = _one_play_left()
    rng = np.random.default_rng(5)
    n = 400
    fg_scores = np.array([m.simulate_game(0, rng, start=sit,
                                          force_first="fg")["score"]
                          for _ in range(n)], dtype=float)
    p_fg = float(analytic.field_goal_prob(
        20.0 + cfg.st.fg_snap_plus_endzone, cfg))
    win = (fg_scores[:, 0] > fg_scores[:, 1]).mean()
    assert abs(win - p_fg) < 5 * np.sqrt(p_fg * (1 - p_fg) / n)
    assert (fg_scores[:, 1] == 0).all()          # B never touches the ball
    pt = np.array([m.simulate_game(0, rng, start=sit,
                                   force_first="punt")["score"]
                   for _ in range(64)], dtype=float)
    assert (pt == 0).all()                        # nobody scores: all ties
    # guards: needs a down-4 start, and a known choice
    with pytest.raises(ValueError, match="down=4"):
        m.simulate_game(0, rng, force_first="go")
    with pytest.raises(ValueError, match="force"):
        m.simulate_game(0, rng, start=sit, force_first="teleport")


@pytest.mark.slow
def test_forced_continuations_match_oracle(reference_dir):
    """Cross-implementation referee for the 4th-down evaluator: from the
    same down-4 situation, each FORCED first play + full normal
    continuation must produce the same win probability in the engine
    (table mode) and the scalar oracle (force_first) within MC + table-
    quantization bounds.  A swapped or leaky force semantics fails
    loudly — fg and punt sit ~35pp apart here."""
    from fast_monte_carlo.models.heads import load_heads
    from fast_monte_carlo.oracle import OracleMatchup

    cfg = SimConfig()
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    heads = load_heads(str(reference_dir))
    sit = Situation(offense=0, sec=300, down=4, dist=2.0, ytg=30.0,
                    score_a=20, score_b=21)

    eng = MatchupRunner(a, b, heads, cfg, mode="table")
    res = eng.run_fourth_decision(sit, n_games=8192, seed=9,
                                  choices=("go", "fg", "punt"))
    m = OracleMatchup(a, b, heads, cfg)
    rng = np.random.default_rng(11)
    n_o = 1200
    for choice in ("go", "fg", "punt"):
        sc = np.array([m.simulate_game(0, rng, start=sit,
                                       force_first=choice)["score"]
                       for _ in range(n_o)], dtype=float)
        p_o = (sc[:, 0] > sc[:, 1]).mean()
        p_e = float(np.asarray(res[choice].win_rate)[0])
        se = np.sqrt(p_o * (1 - p_o) * (1 / 8192 + 1 / n_o) + 1e-12)
        # 3.5 sigma MC + ~1.5pp table-quantization/cache allowance
        assert abs(p_e - p_o) < 3.5 * se + 0.015, (choice, p_e, p_o, se)


def test_evaluate_fourth_down_end_to_end(reference_dir):
    """Full API: table mode, real SP+ file, response schema + best pick."""
    from fast_monte_carlo.api import evaluate_fourth_down

    sit = Situation(offense=0, sec=240, down=4, dist=2.0, ytg=35.0,
                    score_a=20, score_b=21)
    res = evaluate_fourth_down(
        "Kansas State", "Iowa State", sit,
        sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
        n_games=2048, artifact_dir=str(reference_dir), mode="analytic")
    assert set(res["choices"]) == {"policy", "go", "fg", "punt"}
    assert res["best"] in ("go", "fg", "punt")
    for c, row in res["choices"].items():
        assert 0.0 <= row["win_off"] <= 1.0
        assert row["n_games"] == 2048
    assert "fg_make_prob" in res["choices"]["fg"]
    assert res["situation"]["down"] == 4
    assert isinstance(res["best_vs_policy_pp"], float)


def test_cli_fourth(reference_dir, capsys):
    from fast_monte_carlo.cli import main

    rc = main([
        "fourth", "Kansas State", "Iowa State",
        "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
        "--quarter", "4", "--clock", "04:00", "--dist", "2", "--ytg", "35",
        "--score", "20-21", "-n", "1024", "--mode", "analytic",
        "--artifacts", str(reference_dir),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "policy" in out and "punt" in out and "best" in out
