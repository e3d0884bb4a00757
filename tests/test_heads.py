"""ModelHeads bundle: loading, fallbacks, and analytic components."""
import numpy as np
import pytest

from fast_monte_carlo.config import DEFAULT_CONFIG as CFG
from fast_monte_carlo.models import analytic
from fast_monte_carlo.models.heads import ST1_FEATURES, load_heads


@pytest.fixture(scope="module")
def heads(reference_dir):
    return load_heads(reference_dir)


def _state(down, dist, ytg, sec, sd, n=1):
    row = [down, dist, ytg, int(ytg <= 20), sd, sec, 3, 3,
           15.6, 35.7, 20.6, 11.0,
           int(dist >= ytg - 0.5), int(down == 4 and dist <= 2), int(ytg <= 33),
           1 if sec > 1800 else 2, int((sec % 1800) <= 120)]
    return np.asarray([row] * n, dtype=np.float32)


def test_all_reference_heads_load(heads):
    assert heads.stage1 is not None and heads.stage1.n_trees == 188
    assert heads.stage2 is None  # missing from the snapshot (SURVEY §0.1)
    assert heads.pass_quants and heads.rush_quants and heads.sack_quants
    assert heads.fumble is not None
    assert heads.play is not None and heads.play.n_classes == 5


def test_stage2_fallback_probs(heads):
    x = _state(3, 8, 50, 1500, -3)
    inc, itc, sck = heads.stage2_probs(x, np.array([-1]), np.array([-1]), CFG)
    np.testing.assert_allclose(inc + itc + sck, 1.0, atol=1e-6)
    assert inc[0] > 0.6 and 0.0 < itc[0] < 0.2 and 0.0 < sck[0] < 0.3
    # the reference's nudge shifts mass from sack to INT
    ninc, nint, nsck = analytic.stage2_nudge(inc, itc, sck, CFG)
    assert nsck[0] < sck[0] and nint[0] > itc[0]
    np.testing.assert_allclose(ninc + nint + nsck, 1.0, atol=1e-6)


def test_play_model_recovered(heads):
    """The pickled 5-class play model with baked-in descaling behaves sanely."""
    x12 = lambda down, dist, ytg, sec, sd: np.array(
        [[down, dist, ytg, int(ytg <= 20), sd, sec, 3, 3, 15.6, 35.7, 20.6, 11.0]],
        dtype=np.float32)
    coach = np.array([24])
    p_1st = heads.play_pass_prob(x12(1, 10, 75, 3600, 0), coach, CFG)[0]
    p_3rd8 = heads.play_pass_prob(x12(3, 8, 50, 1500, -3), coach, CFG)[0]
    p_2nd2 = heads.play_pass_prob(x12(2, 2, 30, 2000, 7), coach, CFG)[0]
    assert 0.3 < p_1st < 0.6
    assert p_3rd8 > 0.7
    assert p_2nd2 < p_3rd8


def test_heuristic_play_call_vectorized():
    down = np.array([1, 2, 3, 4, 1])
    dist = np.array([10.0, 7.0, 5.0, 1.0, 10.0])
    ytg = np.array([75.0, 50.0, 30.0, 3.0, 60.0])
    sec = np.array([3600, 1800, 900, 100, 110])
    sd = np.array([0, 0, -3, 0, -7])
    p = analytic.pass_prob_v1(down, dist, ytg, sec, sd, CFG)
    # scalar path must agree with vector path
    for i in range(len(down)):
        ps = analytic.pass_prob_v1(down[i], dist[i], ytg[i], sec[i], sd[i], CFG)
        np.testing.assert_allclose(ps, p[i])
    assert p[2] > p[0]          # 3rd down passes more than 1st
    assert p[4] > p[0]          # two-minute trailing bumps pass rate
    assert (p >= 0.10).all() and (p <= 0.95).all()


def test_go_for_it_table_matches_reference_cases():
    cases = [
        # (ytg, dist, sd, sec) -> expected table prob before 1.15x multiplier
        (85, 1.0, 0, 2000, 0.15),
        (85, 2.0, 0, 2000, 0.05),
        (70, 1.0, 0, 2000, 0.30),
        (55, 3.0, 0, 2000, 0.20),
        (40, 2.0, 0, 2000, 0.65),
        (25, 3.0, 0, 2000, 0.30),
        (15, 2.0, 0, 2000, 0.45),
        (8, 2.0, 0, 2000, 0.85),
        (8, 4.0, 0, 2000, 0.40),
        (8, 5.0, 0, 2000, 0.0),
        (55, 1.0, 0, 2000, 0.60),
        (50, 1.0, 0, 2000, 0.85),  # ytg == 50 falls to the >35 bucket (strict >)
    ]
    for ytg, dist, sd, sec, want in cases:
        got = analytic.go_for_it_prob(np.float32(ytg), np.float32(dist), sd, sec, CFG)
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=str((ytg, dist)))
    # late-game overrides
    np.testing.assert_allclose(
        analytic.go_for_it_prob(np.float32(50), np.float32(8), -3, 200, CFG), 0.90)
    np.testing.assert_allclose(
        analytic.go_for_it_prob(np.float32(30), np.float32(8), -3, 200, CFG), 0.75)
    np.testing.assert_allclose(
        analytic.go_for_it_prob(np.float32(40), np.float32(2), +3, 200, CFG), 0.65 * 0.85)


def test_fg_curve():
    import numpy as np
    d = np.array([25.0, 35.0, 45.0, 52.0, 55.0, 56.0])
    p = analytic.field_goal_prob(d, CFG)
    np.testing.assert_allclose(p, [0.96, 0.92, 0.78, 0.50, 0.50, 0.25])


def test_matchup_functions_match_reference_formulas():
    import math
    off_o, def_d = 35.7, 20.6
    np.testing.assert_allclose(
        analytic.matchup_bias(off_o, def_d, CFG), 0.12 * (off_o - def_d) / 40.0)
    np.testing.assert_allclose(
        analytic.yardage_multiplier(off_o, def_d, CFG),
        1.0 + 0.10 * math.tanh((off_o - def_d) / 30.0))
    # rz finish probs inside the documented clips
    for ytg in (1, 3, 7, 12):
        for down in (1, 2, 3):
            pp = analytic.rz_finish_prob_pass(float(ytg), down, off_o, def_d, CFG)
            pr = analytic.rz_finish_prob_run(float(ytg), down, off_o, def_d, CFG)
            assert 0.22 <= pp <= 0.68
            assert 0.20 <= pr <= 0.62
    ep = analytic.explosive_prob(np.float32(70.0), off_o, def_d, CFG)
    assert 0.01 <= ep <= 0.12
