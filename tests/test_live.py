"""Live (mid-game situation) simulation: state construction, engine/oracle
parity from resumed states, API semantics, and the sharded path.

The reference's simulate_game always starts at the opening kickoff
(fast_monte_carlo_cfb.py:1428-1436); live mode is a beyond-parity surface,
so its referee is the repo's own oracle resumed from the same situation
(OracleMatchup.simulate_game(start=...)) — both sides reconstruct derived
state (period, in_rz, going) with the state machine's own formulas.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import (
    build_team_context_from_sp_flex, load_sp_flex,
)
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.ops.game import (
    Situation, initial_state, make_exact_heads_eval, simulate_games,
    state_from_situation,
)
from fast_monte_carlo.ops.pack import build_packs
from fast_monte_carlo.oracle import OracleMatchup


@pytest.fixture(scope="module")
def setup(reference_dir):
    cfg = SimConfig()
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    heads = load_heads(reference_dir)
    pack, hp = build_packs(a, b, heads, cfg)
    return cfg, a, b, heads, pack, hp


def _kickoff_sit(cfg: SimConfig, offense=0) -> Situation:
    return Situation(offense=offense, sec=cfg.clock.game_seconds, down=1,
                     dist=cfg.opening_distance, ytg=cfg.kickoff_spot,
                     score_a=0, score_b=0)


def test_situation_from_fields_shared_parser():
    """The ONE situation parser behind the CLI live/fourth commands and
    the HTTP body parser — offense letters, quarter/clock arithmetic,
    and the error surfaces."""
    from fast_monte_carlo.api import situation_from_fields

    s = situation_from_fields(ytg=30, offense="B", quarter=4,
                              clock="05:12", down=2, dist=7,
                              score_a=21, score_b=17)
    assert (s.offense, s.sec, s.down, s.score_a) == (1, 312, 2, 21)
    assert situation_from_fields(ytg=30, sec=100).sec == 100
    assert situation_from_fields(ytg=30, quarter=1).sec == 3600
    with pytest.raises(ValueError, match="sec= or quarter="):
        situation_from_fields(ytg=30)
    with pytest.raises(ValueError, match="quarter"):
        situation_from_fields(ytg=30, quarter=5)
    with pytest.raises(ValueError, match="offense"):
        situation_from_fields(ytg=30, sec=10, offense="C")


def test_kickoff_situation_equals_initial_state(setup):
    """The kickoff situation reconstructs initial_state array-for-array,
    so live mode is a strict generalization of the normal start."""
    cfg, a, b, heads, pack, hp = setup
    n = 32
    ref = initial_state(n, 0, cfg, pack.k)
    live = state_from_situation(n, _kickoff_sit(cfg), cfg, pack.k)
    for name, rv, lv in zip(ref._fields, ref, live):
        rv, lv = np.asarray(rv), np.asarray(lv)
        assert rv.dtype == lv.dtype, name
        assert rv.shape == lv.shape, name
        np.testing.assert_array_equal(rv, lv, err_msg=name)


@pytest.mark.slow   # full-sim pair; ~2 min standalone (compile unamortized)
def test_kickoff_situation_simulates_bitwise_equal(setup):
    """simulate_games(situation=kickoff) == simulate_games(first_offense=0)
    under the same key: the live path changes nothing but the start state."""
    cfg, a, b, heads, pack, hp = setup
    he = make_exact_heads_eval(cfg)
    k = jax.random.PRNGKey(7)
    plain = jax.jit(lambda hs, kk: simulate_games(
        pack, cfg, he, hs, kk, 64, 0, collect_players=False))(hp, k)
    live = jax.jit(lambda hs, kk, sit: simulate_games(
        pack, cfg, he, hs, kk, 64, 0, collect_players=False,
        situation=sit))(hp, k, _kickoff_sit(cfg))
    np.testing.assert_array_equal(np.asarray(plain.score),
                                  np.asarray(live.score))


def test_period_reconstruction_matches_oracle():
    """period from the tick formula at quarter boundaries, engine == oracle
    (a wrong period would fire a spurious halftime flip on the first tick)."""
    cfg = SimConfig()
    qsec = cfg.clock.quarter_seconds
    cases = {4 * qsec: 1, 3 * qsec + 1: 1, 3 * qsec: 2, 2 * qsec + 1: 2,
             2 * qsec: 3, qsec + 1: 3, qsec: 4, 1: 4}
    for sec, want in cases.items():
        sit = Situation(offense=0, sec=sec, down=1, dist=10.0, ytg=50.0,
                        score_a=0, score_b=0)
        st = state_from_situation(4, sit, cfg, k=2)
        assert int(np.asarray(st.period)[0]) == want, (sec, want)
        # oracle twin computes the same period at init
        per = 4 - ((sec - 1) // qsec) if sec > 0 else 4
        assert per == want, (sec, want)


def test_in_rz_and_going_init():
    cfg = SimConfig()
    st = state_from_situation(
        4, Situation(0, 600, 2, 4.0, 15.0, 14, 10), cfg, k=2)
    assert bool(np.asarray(st.in_rz).all())      # already inside the 20
    assert not bool(np.asarray(st.going).any())
    st2 = state_from_situation(
        4, Situation(1, 600, 2, 4.0, 45.0, 14, 10), cfg, k=2)
    assert not bool(np.asarray(st2.in_rz).any())
    assert int(np.asarray(st2.off)[0]) == 1
    np.testing.assert_array_equal(np.asarray(st2.score),
                                  np.tile([14, 10], (4, 1)))


@pytest.fixture(scope="module")
def analytic_runner(setup):
    cfg, a, b, heads, pack, hp = setup
    return MatchupRunner(a, b, None, cfg, mode="analytic")


def test_run_live_endgame_blowout(analytic_runner):
    """28-0 with 30 seconds left is a lock for team A regardless of heads."""
    sit = Situation(offense=0, sec=30, down=1, dist=10.0, ytg=50.0,
                    score_a=28, score_b=0)
    s = analytic_runner.run_live(sit, n_games=2048)
    assert int(s.n) == 2048
    assert float(s.win_rate[0]) > 0.999
    assert float(s.mean_pts[0]) >= 28.0  # points never come off the board


def test_run_live_monotone_in_score(analytic_runner):
    """Win probability increases with the resumed lead (mid-Q3 state)."""
    wins = []
    for sa in (10, 17, 24):
        sit = Situation(offense=1, sec=1300, down=2, dist=7.0, ytg=60.0,
                        score_a=sa, score_b=17)
        wins.append(float(analytic_runner.run_live(
            sit, n_games=4096, seed=3).win_rate[0]))
    assert wins[0] < wins[1] < wins[2], wins


def test_run_live_deterministic(analytic_runner):
    sit = Situation(offense=0, sec=900, down=3, dist=2.0, ytg=35.0,
                    score_a=14, score_b=13)
    s1 = analytic_runner.run_live(sit, n_games=512, seed=11)
    s2 = analytic_runner.run_live(sit, n_games=512, seed=11)
    np.testing.assert_array_equal(np.asarray(s1.margin_hist),
                                  np.asarray(s2.margin_hist))
    s3 = analytic_runner.run_live(sit, n_games=512, seed=12)
    assert (np.asarray(s1.margin_hist) != np.asarray(s3.margin_hist)).any()


def test_run_live_no_recompile_across_situations(analytic_runner):
    """The situation is a runtime input: two different live states reuse
    ONE compiled program (serving would otherwise recompile per state)."""
    from fast_monte_carlo.api import _live_moments_jit

    cfg_r, heads_fn_r = analytic_runner._resolved(False)
    jitted = _live_moments_jit(cfg_r, heads_fn_r)
    before = jitted._cache_size()
    # n is a static arg (one entry per batch size); the situations must not
    # add entries beyond the single new-n compile
    sits = [Situation(0, 1000, 1, 10.0, 70.0, 7, 3),
            Situation(1, 250, 4, 1.0, 2.0, 20, 21),
            Situation(1, 3100, 2, 8.0, 33.0, 0, 14)]
    for sit in sits:
        analytic_runner.run_live(sit, n_games=192)
    assert jitted._cache_size() == before + 1


def test_run_live_validation(analytic_runner):
    good = dict(offense=0, sec=600, down=2, dist=5.0, ytg=40.0,
                score_a=7, score_b=3)
    for bad in (dict(offense=2), dict(sec=0), dict(sec=99999), dict(down=5),
                dict(ytg=0.0), dict(ytg=104.0), dict(dist=0.0),
                dict(score_a=-1), dict(score_b=130)):
        sit = Situation(**{**good, **bad})
        with pytest.raises(ValueError):
            analytic_runner.run_live(sit, n_games=64)
    with pytest.raises(ValueError):
        analytic_runner.run_live(Situation(**good), n_games=0)


def test_run_live_sharded_matches_unsharded(setup):
    """shard=True prices the same situation over the 8-device mesh: exact
    n, rates in bounds, and distributional agreement with the single-device
    path (streams differ by construction — per-device fold_in)."""
    cfg, a, b, heads, pack, hp = setup
    sit = Situation(offense=0, sec=800, down=1, dist=10.0, ytg=75.0,
                    score_a=17, score_b=14)
    r1 = MatchupRunner(a, b, None, cfg, mode="analytic")
    rs = MatchupRunner(a, b, None, cfg, mode="analytic", shard=True)
    s1 = r1.run_live(sit, n_games=4096, seed=5)
    ss = rs.run_live(sit, n_games=4096, seed=5)
    assert int(ss.n) == 4096
    w1, ws = float(s1.win_rate[0]), float(ss.win_rate[0])
    assert 0.0 < ws < 1.0
    # SE ~ sqrt(2 * p(1-p) / 4096) ~ 0.011 -> 5 sigma
    assert abs(w1 - ws) < 0.055, (w1, ws)


@pytest.mark.slow
@pytest.mark.parametrize("sit", [
    # late Q4, one-score game, offense trailing — short games, OT-free tail
    Situation(offense=1, sec=420, down=2, dist=6.0, ytg=55.0,
              score_a=24, score_b=20),
    # mid Q2 tie at midfield — crosses the halftime possession flip
    Situation(offense=0, sec=2100, down=1, dist=10.0, ytg=50.0,
              score_a=10, score_b=10),
])
def test_live_engine_matches_oracle(setup, sit):
    """Resumed-state parity: the exact-mode engine and the scalar oracle
    agree on win probability and mean scores from the same mid-game state
    (same bounds discipline as test_engine_matches_oracle_distributionally)."""
    cfg, a, b, heads, pack, hp = setup
    n_engine, n_oracle = 2048, 384

    he = make_exact_heads_eval(cfg)
    out = jax.jit(lambda hs, k, s: simulate_games(
        pack, cfg, he, hs, k, n_engine, 0, collect_players=False,
        situation=s))(hp, jax.random.PRNGKey(42), sit)
    e_sc = np.asarray(out.score, dtype=float)
    assert int(np.asarray(out.sec).max()) == 0  # every resumed game finishes

    m = OracleMatchup(a, b, heads, cfg)
    rng = np.random.default_rng(7)
    o_sc = np.asarray([m.simulate_game(0, rng, start=sit)["score"]
                       for _ in range(n_oracle)], dtype=float)

    p_e = (e_sc[:, 0] > e_sc[:, 1]).mean()
    p_o = (o_sc[:, 0] > o_sc[:, 1]).mean()
    se = np.sqrt(p_o * (1 - p_o) * (1 / n_engine + 1 / n_oracle) + 1e-12)
    assert abs(p_e - p_o) < max(3.5 * se, 0.02), (p_e, p_o, se)

    # resumed scores only grow: every trial's final >= the posted score
    assert e_sc[:, 0].min() >= sit.score_a and e_sc[:, 1].min() >= sit.score_b
    for t, base in ((0, sit.score_a), (1, sit.score_b)):
        sd = max(o_sc[:, t].std(), 1.0)
        d = abs(e_sc[:, t].mean() - o_sc[:, t].mean())
        bound = 3.5 * sd * np.sqrt(1 / n_engine + 1 / n_oracle)
        assert d < max(bound, 0.6), (t, d, bound)


def test_simulate_live_game_end_to_end(reference_dir):
    """Names-in dict-out convenience: the serving path's core."""
    from fast_monte_carlo.api import simulate_live_game

    sit = Situation(offense=0, sec=500, down=1, dist=10.0, ytg=65.0,
                    score_a=21, score_b=17)
    row, summary = simulate_live_game(
        "Kansas State", "Iowa State", sit,
        sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
        n_games=1024, mode="analytic", artifact_dir=str(reference_dir))
    assert row["n_games"] == 1024
    assert row["score_a"] == 21 and row["offense"] == 0
    assert 0.0 <= row["win_a"] <= 1.0
    assert abs(row["win_a"] + row["win_b"] + row["tie"] - 1.0) < 1e-6
    assert row["mean_a"] >= 21.0 and row["mean_b"] >= 17.0
    # the summary's histograms price live markets
    from fast_monte_carlo.edge import market_odds_from_summary
    mk = market_odds_from_summary(summary, "Kansas State", "Iowa State",
                                  spread=-3.5, total=55.5)
    assert {"spread", "total"} <= set(mk)


# -- batched live pricing (win-probability curve) ---------------------------

def test_run_live_batch_orders_and_counts(analytic_runner):
    """S situations in one launch: per-situation rows come back in input
    order with exactly n_games_per trials each."""
    sits = [Situation(0, 30, 1, 10.0, 50.0, 28, 0),    # A blowout, locked
            Situation(1, 30, 1, 10.0, 50.0, 0, 28),    # B blowout, locked
            Situation(0, 1800, 1, 10.0, 75.0, 14, 14)]  # live coin-flip-ish
    s = analytic_runner.run_live_batch(sits, n_games_per=512, seed=4)
    n = np.asarray(s.n)
    np.testing.assert_array_equal(n, [512.0, 512.0, 512.0])
    win = np.asarray(s.win_rate)
    assert win.shape == (3, 2)
    assert win[0, 0] > 0.999 and win[1, 1] > 0.999
    assert 0.2 < win[2, 0] < 0.8
    # points never come off the board: resumed scores floor the means
    mp = np.asarray(s.mean_pts)
    assert mp[0, 0] >= 28.0 and mp[1, 1] >= 28.0


def test_run_live_batch_matches_run_live(analytic_runner):
    """A situation priced inside a batch equals the single-situation path
    within MC error (different draw streams by construction)."""
    sit = Situation(offense=0, sec=900, down=2, dist=6.0, ytg=45.0,
                    score_a=17, score_b=14)
    batch = analytic_runner.run_live_batch(
        [Situation(1, 60, 4, 9.0, 80.0, 0, 3), sit], n_games_per=4096,
        seed=13)
    single = analytic_runner.run_live(sit, n_games=4096, seed=29)
    wb = float(np.asarray(batch.win_rate)[1, 0])
    ws = float(single.win_rate[0])
    se = np.sqrt(ws * (1 - ws) / 4096)
    assert abs(wb - ws) < 5 * np.sqrt(2) * se, (wb, ws)
    # and the batch margin histogram sums to its own n
    assert int(np.asarray(batch.margin_hist)[1].sum()) == 4096


def test_run_live_batch_one_program_across_batches(analytic_runner):
    """The (S,) situation arrays are runtime inputs: a second batch of the
    same (S, n_per) shape reuses the compiled program."""
    from fast_monte_carlo.api import _live_batch_moments_jit

    cfg_r, heads_fn_r = analytic_runner._resolved(False)
    jitted = _live_batch_moments_jit(cfg_r, heads_fn_r)
    sits1 = [Situation(0, 1000, 1, 10.0, 70.0, 7, 3),
             Situation(1, 250, 4, 1.0, 2.0, 20, 21)]
    sits2 = [Situation(1, 3100, 2, 8.0, 33.0, 0, 14),
             Situation(0, 400, 3, 4.0, 55.0, 10, 24)]
    analytic_runner.run_live_batch(sits1, n_games_per=128)
    before = jitted._cache_size()
    analytic_runner.run_live_batch(sits2, n_games_per=128)
    assert jitted._cache_size() == before


def test_run_live_batch_validation(analytic_runner):
    with pytest.raises(ValueError):
        analytic_runner.run_live_batch([], n_games_per=64)
    with pytest.raises(ValueError):
        analytic_runner.run_live_batch(
            [Situation(0, 600, 1, 10.0, 50.0, 0, 0)], n_games_per=0)
    with pytest.raises(ValueError):   # per-situation validation applies
        analytic_runner.run_live_batch(
            [Situation(0, 600, 9, 10.0, 50.0, 0, 0)], n_games_per=64)


def test_simulate_live_curve_end_to_end(reference_dir):
    """Names-in frame-out curve: one row per situation, plus the stacked
    summary for per-point market pricing."""
    from fast_monte_carlo.api import simulate_live_curve

    sits = [Situation(0, 2400, 1, 10.0, 75.0, 7, 7),
            Situation(0, 1200, 2, 4.0, 55.0, 14, 10),
            Situation(1, 300, 1, 10.0, 60.0, 14, 17)]
    df, s = simulate_live_curve(
        "Kansas State", "Iowa State", sits,
        sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
        n_games_per=512, mode="analytic", artifact_dir=str(reference_dir))
    assert len(df) == 3
    assert list(df["sec"]) == [2400, 1200, 300]
    assert (df["n_games"] == 512).all()
    assert ((df["win_a"] + df["win_b"] + df["tie"]) - 1.0).abs().max() < 1e-6
    assert np.asarray(s.margin_hist).shape[0] == 3
