"""Hand-computed unit tests for the pure game-mechanics rules (clock, downs,
possession flips, spot math) against the reference semantics, exercised on
the oracle's state machine (the engine is held to these distributionally in
test_engine.py)."""
import numpy as np
import pytest

from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.oracle import OracleMatchup, _GameState
from fast_monte_carlo.data.context import RoleTable, TeamContext


def _ctx(name):
    import pandas as pd
    rt = lambda col: RoleTable.from_share_frame(
        pd.DataFrame({col: ["Unknown"], "share": [1.0]}), col, set(), 8)
    return TeamContext(name=name, year=2025, week=1, sp_rating=10.0,
                       sp_offense=30.0, sp_defense=25.0,
                       qb=rt("passer_name"), rush=rt("rusher_name"),
                       target=rt("receiver_name"))


@pytest.fixture(scope="module")
def m():
    from fast_monte_carlo.models.heads import ModelHeads
    # mechanics only — no forests needed; guard any accidental model call
    heads = ModelHeads()
    return OracleMatchup(_ctx("A"), _ctx("B"), heads)


def test_advance_down_first_down(m):
    gs = _GameState(ytg=75.0, down=2, dist=7.0)
    m._advance_down(gs, 8.5)
    assert gs.down == 1 and gs.dist == 10.0
    assert gs.ytg == pytest.approx(66.5)


def test_advance_down_short_of_sticks(m):
    gs = _GameState(ytg=50.0, down=1, dist=10.0)
    m._advance_down(gs, 4.0)
    assert gs.down == 2 and gs.dist == pytest.approx(6.0)
    assert gs.ytg == pytest.approx(46.0)


def test_advance_down_exact_gain_is_first_down(m):
    gs = _GameState(ytg=50.0, down=3, dist=4.0)
    m._advance_down(gs, 4.0)  # 1e-6 epsilon rule (reference :934)
    assert gs.down == 1 and gs.dist == 10.0


def test_turnover_on_downs_flips_field(m):
    gs = _GameState(off=0, ytg=40.0, down=4, dist=5.0)
    m._advance_down(gs, 2.0)
    # spot: ytg 38 -> new offense at 100-38 = 62
    assert gs.off == 1 and gs.down == 1 and gs.dist == 10.0
    assert gs.ytg == pytest.approx(62.0)
    assert not gs.in_rz and not gs.going


def test_change_possession_spot_overwrite(m):
    gs = _GameState(off=1, ytg=33.0, in_rz=True, going=True)
    m._change_possession(gs, spot=75.0)
    assert gs.off == 0 and gs.ytg == 75.0
    assert not gs.in_rz and not gs.going


def test_tick_clock_period_boundaries(m):
    gs = _GameState(sec=910, period=3)
    m._tick(gs, 20)  # 890 -> Q4
    assert gs.sec == 890 and gs.period == 4

    gs = _GameState(sec=905, period=1)
    gs.period = 4 - ((gs.sec - 1) // 900)  # = 1 correct precondition? 904//900=1 -> period 3?
    # direct check of the reference formula at a few seconds values
    for sec, want in [(3600, 1), (2701, 1), (2700, 2), (1801, 2), (1800, 3),
                      (901, 3), (900, 4), (1, 4)]:
        g2 = _GameState(sec=sec + 10, period=1)
        m._tick(g2, 10)
        assert g2.period == want, (sec, g2.period, want)


def test_halftime_flip(m):
    # offense 0 has the ball at the opp 30 as the half expires
    gs = _GameState(off=0, sec=1805, period=2, ytg=30.0, down=3, dist=2.0,
                    in_rz=False)
    m._tick(gs, 20)  # sec 1785 -> period 3 -> halftime kickoff
    assert gs.period == 3
    assert gs.off == 1              # other team receives
    assert gs.ytg == 75.0 and gs.down == 1 and gs.dist == 10.0


def test_tick_to_zero_no_halftime(m):
    gs = _GameState(off=0, sec=15, period=2, ytg=40.0)
    m._tick(gs, 28)
    assert gs.sec == 0 and gs.period == 4 and gs.off == 0  # no flip


def test_go_table_multiplier_cap():
    from fast_monte_carlo.models import analytic
    cfg = SimConfig()
    # table 0.85 * 1.15 = 0.9775 < 1; 0.90 late-trailing * 1.15 capped at 1.0
    p = analytic.go_for_it_prob(np.float32(40.0), np.float32(1.0), 0, 2000, cfg)
    assert min(1.0, float(p) * cfg.fourth.go_multiplier) == pytest.approx(0.9775)


def test_punt_spot_clip_semantics():
    """Punt spot = clip(100-(ytg-net),1,99); net = int(clip(net,15,ytg-1))
    (reference :894, :1419)."""
    cfg = SimConfig()
    ytg, net = 80.0, 43.7
    net_i = int(min(max(net, cfg.st.punt_net_min), ytg - 1.0))
    assert net_i == 43
    spot = min(max(100.0 - (ytg - net_i), 1.0), 99.0)
    assert spot == pytest.approx(63.0)
    # touchback from near midfield: net = ytg - 25 -> opponent at own 25
    ytg = 55.0
    net_tb = ytg - cfg.st.punt_tb_own_spot
    spot = min(max(100.0 - (ytg - net_tb), 1.0), 99.0)
    assert spot == pytest.approx(75.0)


def test_fg_distance_and_gate():
    from fast_monte_carlo.models import analytic
    cfg = SimConfig()
    # ytg 38 -> 55-yard attempt -> 0.50; ytg 39 would not be attempted
    assert float(analytic.field_goal_prob(np.float32(38 + 17), cfg)) == 0.50
    assert 38.0 <= cfg.st.fg_attempt_max_ytg < 39.0
    # miss spot: opponent at 100 - ytg
    assert 100.0 - 38.0 == 62.0


def test_sack_pushback_cap_quirk(m):
    """loss = min(max(0,-y), ytg): deep-territory sacks can push ytg past
    100 (reference :1177-1178)."""
    gs = _GameState(ytg=95.0, down=1, dist=10.0)
    loss = min(max(0.0, 18.0), gs.ytg)
    gs.ytg += loss
    gs.dist += loss
    gs.down += 1
    assert gs.ytg == 113.0 and gs.dist == 28.0 and gs.down == 2


def test_down_five_quirk_reachable(m):
    """Incomplete on a 4th-down go play leaves down=5 with possession
    retained (reference :1165 vs :1384-1386)."""
    gs = _GameState(off=0, down=4, dist=7.0, ytg=45.0)
    gs.down += 1  # the incomplete branch
    assert gs.down == 5 and gs.off == 0


def test_taper_piecewise_engine_equals_oracle():
    """mc-variant long-gain taper: engine (vector) and oracle (scalar)
    implement the same piecewise map (monte_carlo_cfb.py:470,482)."""
    import numpy as np

    from fast_monte_carlo.ops.game import _taper
    from fast_monte_carlo.oracle import _taper_scalar

    ys = np.asarray([-5.0, 0.0, 10.0, 22.0, 23.0, 30.0, 42.0, 43.0, 80.0])
    t1, t2, r1, r2 = 22.0, 42.0, 0.60, 0.40
    got = np.asarray(_taper(ys, t1, t2, r1, r2))
    want = np.asarray([_taper_scalar(float(y), t1, t2, r1, r2) for y in ys])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # spot-check the definition: slope breaks at t1 and t2
    assert float(_taper(np.asarray([32.0]), t1, t2, r1, r2)[0]) == 22.0 + 10 * 0.6
    assert float(_taper(np.asarray([52.0]), t1, t2, r1, r2)[0]) == 22.0 + 20 * 0.6 + 10 * 0.4


def test_classic_config_tapers_long_gains():
    """classic_config enables the mc-variant taper + RZ damping; the
    engine's long-gain tail must shrink vs the fast-variant default."""
    import jax
    import numpy as np

    from fast_monte_carlo.config import SimConfig, classic_config
    from fast_monte_carlo.data.context import _build
    from fast_monte_carlo.models.heads import ModelHeads
    from fast_monte_carlo.ops.game import make_analytic_heads_eval, simulate_games
    from fast_monte_carlo.ops.pack import build_packs
    from fast_monte_carlo.stats import TS

    a = _build("Team A", 2025, 1, 15.6, 35.7, 20.0, {}, ".", 4)
    b = _build("Team B", 2025, 1, 11.0, 31.5, 20.6, {}, ".", 4)

    def mean_pass_yds(cfg):
        pack, _ = build_packs(a, b, ModelHeads(), cfg)
        he = make_analytic_heads_eval(cfg)
        out = jax.jit(lambda k: simulate_games(
            pack, cfg, he, None, k, 512, 0, collect_players=False))(
            jax.random.PRNGKey(3))
        st = np.asarray(out.stats).mean(axis=0)
        return st[:, TS["pass_yds"]].sum()

    fast_y = mean_pass_yds(SimConfig())
    classic = classic_config()
    assert classic.model.taper_enabled and classic.model.rz_pass_damping
    classic_y = mean_pass_yds(classic)
    assert classic_y < fast_y, (classic_y, fast_y)


@pytest.mark.slow
def test_tail_compaction_finishes_and_matches():
    """Two-phase tail compaction: all games finish, results statistically
    match the uncompacted engine (and exactly match when the active set is
    a prefix), including the sub-batch-overflow fallback path."""
    import dataclasses

    import jax
    import numpy as np

    from fast_monte_carlo.config import SimConfig
    from fast_monte_carlo.data.context import _build
    from fast_monte_carlo.models.heads import ModelHeads
    from fast_monte_carlo.ops.game import make_analytic_heads_eval, simulate_games
    from fast_monte_carlo.ops.pack import build_packs

    a = _build("Team A", 2025, 1, 15.6, 35.7, 20.0, {}, ".", 4)
    b = _build("Team B", 2025, 1, 11.0, 31.5, 20.6, {}, ".", 4)

    def run(compact, after=216, frac=8, n=8192):
        cfg = SimConfig().replace(engine=dataclasses.replace(
            SimConfig().engine, compact_tail=compact, compact_min_batch=1024,
            compact_after=after, compact_cap_frac=frac))
        pack, _ = build_packs(a, b, ModelHeads(), cfg)
        he = make_analytic_heads_eval(cfg)
        out = jax.jit(lambda k: simulate_games(
            pack, cfg, he, None, k, n, 0, collect_players=False))(
            jax.random.PRNGKey(9))
        return np.asarray(out.score), np.asarray(out.sec)

    base_sc, base_sec = run(False)
    assert int(base_sec.max()) == 0
    for after, frac in ((216, 8), (120, 4), (120, 64)):  # incl. overflow
        sc, sec = run(True, after, frac)
        assert int(sec.max()) == 0, (after, frac)
        # distributional agreement (compaction only re-keys moved lanes)
        dw = abs((sc[:, 0] > sc[:, 1]).mean()
                 - (base_sc[:, 0] > base_sc[:, 1]).mean())
        assert dw < 0.04, (after, frac, dw)
        assert abs(sc.mean() - base_sc.mean()) < 0.8, (after, frac)
