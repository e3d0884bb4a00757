"""Multi-device (8-way virtual CPU mesh) sharding + aggregation tests, on
the seeded artifact set."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import load_sp_flex, build_team_context_from_sp_flex
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.ops.game import make_analytic_heads_eval, simulate_games
from fast_monte_carlo.ops.pack import build_packs
from fast_monte_carlo.parallel import (
    cover_probs, simulate_games_sharded, summarize_scores, total_probs, trial_mesh,
)


SEEDED = "seeded:0"


def _contexts():
    sp = load_sp_flex(SEEDED)
    return (build_team_context_from_sp_flex("Team 030", 2025, 1, sp),
            build_team_context_from_sp_flex("Team 041", 2025, 1, sp))


@pytest.fixture(scope="module")
def env():
    cfg = SimConfig()
    a, b = _contexts()
    heads = load_heads(SEEDED)
    pack, hp = build_packs(a, b, heads, cfg)
    return cfg, pack


@pytest.fixture(scope="module")
def nano(env):
    """Nano table heads for the seeded matchup."""
    from fast_monte_carlo.models.tables import nano_profile
    from fast_monte_carlo.ops.table_lookup import build_table_heads

    cfg, pack = env
    a, b = _contexts()
    heads = load_heads(SEEDED)
    return a, b, heads, build_table_heads(a, b, heads, cfg,
                                          nano=nano_profile())


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_simulation_runs_and_aggregates(env):
    cfg, pack = env
    he = make_analytic_heads_eval(cfg)
    n = 1024
    out = simulate_games_sharded(pack, cfg, he, None, jax.random.PRNGKey(0), n, 0)
    assert out.score.shape == (n, 2)
    # result is actually sharded over 8 devices
    assert len(out.score.sharding.device_set) == 8
    assert int(np.asarray(out.sec).max()) == 0

    s = jax.jit(summarize_scores)(out.score)
    assert float(s.n) == n
    assert 5 < float(s.mean_pts[0]) < 80
    np.testing.assert_allclose(
        float(s.win_rate[0] + s.win_rate[1] + s.tie_rate), 1.0, atol=1e-6)
    assert int(s.pts_hist.sum()) == 2 * n
    assert int(s.margin_hist.sum()) == n

    cp = jax.jit(lambda sc: cover_probs(sc, -3.0))(out.score)
    tp = jax.jit(lambda sc: total_probs(sc, 55.5))(out.score)
    np.testing.assert_allclose(
        float(cp["p_cover"] + cp["p_notcover"] + cp["push"]), 1.0, atol=1e-6)
    np.testing.assert_allclose(
        float(tp["p_over"] + tp["p_under"] + tp["push"]), 1.0, atol=1e-6)


def test_sharded_matches_single_device_distribution(env):
    """Sharding must not change the statistics (keys are per-shard folds, so
    results differ bitwise but must agree distributionally)."""
    cfg, pack = env
    he = make_analytic_heads_eval(cfg)
    n = 2048
    sharded = simulate_games_sharded(pack, cfg, he, None, jax.random.PRNGKey(7), n, 0)
    single = jax.jit(lambda k: simulate_games(pack, cfg, he, None, k, n, 0,
                                              collect_players=False))(jax.random.PRNGKey(3))
    a = np.asarray(sharded.score, dtype=float)
    b = np.asarray(single.score, dtype=float)
    se = np.sqrt(a[:, 0].var() / n + b[:, 0].var() / n)
    assert abs(a[:, 0].mean() - b[:, 0].mean()) < 5 * se + 0.5
    assert abs((a[:, 0] > a[:, 1]).mean() - (b[:, 0] > b[:, 1]).mean()) < 0.08


def test_sharded_requires_divisible_n(env):
    cfg, pack = env
    he = make_analytic_heads_eval(cfg)
    with pytest.raises(ValueError):
        simulate_games_sharded(pack, cfg, he, None, jax.random.PRNGKey(0), 1001, 0)


def test_moments_sharded_exact_vs_sharded_scores(env):
    """simulate_moments_sharded (per-device reduction + one psum) must be
    bit-equal to reducing the trial-sharded score batch after the fact:
    same per-device fold_in keys, and every moment field is integer-exact
    in float32 at this n."""
    from fast_monte_carlo.parallel import (
        score_moments, simulate_moments_sharded,
    )

    cfg, pack = env
    he = make_analytic_heads_eval(cfg)
    n = 1024
    fo = np.arange(n) % 2
    key = jax.random.PRNGKey(21)
    m = simulate_moments_sharded(pack, cfg, he, None, key, n, fo)
    out = simulate_games_sharded(pack, cfg, he, None, key, n, fo)
    want = jax.jit(score_moments)(out.score)
    for name, got_f, want_f in zip(m._fields, m, want):
        np.testing.assert_array_equal(
            np.asarray(got_f), np.asarray(want_f), err_msg=name)


def test_run_pairs_summary_sharded():
    """MatchupRunner(shard=True).run_pairs_summary: the multi-chip summary
    path runs chunked shard_map launches and agrees with the single-device
    summary within MC error."""
    from fast_monte_carlo.api import MatchupRunner

    a, b = _contexts()
    rs = MatchupRunner(a, b, None, SimConfig(), mode="analytic", shard=True)
    got = rs.run_pairs_summary(512, seed=4, chunk_pairs=128)
    assert int(got.n) == 1024
    r1 = MatchupRunner(a, b, None, SimConfig(), mode="analytic")
    ref = r1.run_pairs_summary(512, seed=5, chunk_pairs=128)
    np.testing.assert_allclose(np.asarray(got.win_rate)[0],
                               np.asarray(ref.win_rate)[0], atol=0.08)
    np.testing.assert_allclose(np.asarray(got.mean_pts),
                               np.asarray(ref.mean_pts), atol=2.5)
    assert int(np.asarray(got.pts_hist).sum()) == 2048


def test_run_pairs_summary_sharded_rounds_up_odd_n():
    """Arbitrary -n values must not crash the shard path on the device-count
    divisibility check: chunk_pairs rounds UP to a device multiple (the
    documented whole-launch round-up), and raw run_pairs — which cannot
    silently round — raises a clear error at the API surface instead."""
    from fast_monte_carlo.api import MatchupRunner

    a, b = _contexts()
    rs = MatchupRunner(a, b, None, SimConfig(), mode="analytic", shard=True)
    got = rs.run_pairs_summary(101, seed=4, chunk_pairs=101)
    # 101 pairs round up to 104 (13 per device x 8): whole-launch semantics
    assert int(got.n) == 2 * 104
    with pytest.raises(ValueError, match="divisible by the device count"):
        rs.run_pairs(101, seed=4)


def test_accumulated_summary_matches_single_batch():
    """run_pairs_summary's device-accumulated moments equal summarize_scores
    over the concatenated per-chunk batches (the sweep pattern is exact,
    not approximate)."""
    from fast_monte_carlo.api import MatchupRunner
    from fast_monte_carlo.parallel.aggregate import summarize_scores

    a, b = _contexts()
    r = MatchupRunner(a, b, None, SimConfig(), mode="analytic")
    root = jax.random.PRNGKey(9)
    want_scores = []
    for ci in range(3):
        out = r.run_pairs(32, key=jax.random.fold_in(root, ci),
                          collect_players=False, collect_stats=False)
        want_scores.append(np.asarray(out.score))
    want = summarize_scores(jnp.asarray(np.concatenate(want_scores)))
    got = r.run_pairs_summary(96, seed=9, chunk_pairs=32)
    assert int(got.n) == 192 == int(want.n)
    np.testing.assert_array_equal(np.asarray(got.margin_hist),
                                  np.asarray(want.margin_hist))
    np.testing.assert_array_equal(np.asarray(got.pts_hist),
                                  np.asarray(want.pts_hist))
    np.testing.assert_allclose(np.asarray(got.win_rate),
                               np.asarray(want.win_rate), atol=1e-7)
    np.testing.assert_allclose(np.asarray(got.mean_pts),
                               np.asarray(want.mean_pts), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got.sd_pts),
                               np.asarray(want.sd_pts), rtol=1e-5)


def test_sharded_moments_deterministic_per_layout(env):
    """Per-device fold_in keys make the sharded stream a pure function of
    (seed, device count): an identical call gives identical moments."""
    from fast_monte_carlo.parallel import simulate_moments_sharded

    cfg, pack = env
    he = make_analytic_heads_eval(cfg)
    n = 256
    fo = np.arange(n) % 2
    m1, m2 = (simulate_moments_sharded(pack, cfg, he, None,
                                       jax.random.PRNGKey(2), n, fo)
              for _ in range(2))
    for name, x, y in zip(m1._fields, m1, m2):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


def test_sharded_moments_uneven_trials_rejected(env):
    """An uneven trial split fails loudly at the mesh layer (the chunked
    drivers round requests up instead), never by silent truncation."""
    from fast_monte_carlo.parallel import simulate_moments_sharded

    cfg, pack = env
    he = make_analytic_heads_eval(cfg)
    with pytest.raises(ValueError, match="not divisible"):
        simulate_moments_sharded(pack, cfg, he, None, jax.random.PRNGKey(3),
                                 257, np.arange(257) % 2)


def test_nano_tables_sharded_over_mesh(env, nano):
    """The main path — nano single-gather tables — runs trial-sharded over
    the whole mesh."""
    from fast_monte_carlo.ops.table_lookup import make_table_heads_eval

    cfg, pack = env
    _, _, _, th = nano
    n = 8 * 16
    out = simulate_games_sharded(pack, cfg, make_table_heads_eval(cfg), th,
                                 jax.random.PRNGKey(1), n, np.arange(n) % 2,
                                 game_id=np.zeros(n, np.int32))
    assert out.score.shape == (n, 2)
    assert len(out.score.sharding.device_set) == 8
    assert int(np.asarray(out.sec).max()) == 0


def test_sharded_nano_summary_uneven_request(nano):
    """run_pairs_summary(shard=True) in table mode rounds an uneven request
    up to whole sharded launches; summary.n records what ran."""
    from fast_monte_carlo.api import MatchupRunner

    a, b, heads, _ = nano
    r = MatchupRunner(a, b, heads, SimConfig(), mode="table",
                      table_quality="nano", shard=True)
    want = 3 * 8 + 1
    s = r.run_pairs_summary(want, seed=5, chunk_pairs=2 * 8)
    n = int(np.asarray(s.n))
    assert n >= 2 * want and n % (2 * 8) == 0
    np.testing.assert_allclose(
        float(s.win_rate[0] + s.win_rate[1] + s.tie_rate), 1.0, atol=1e-6)


def test_game_sharded_slate_padded_and_deterministic(nano):
    """3 matchups on 8 devices exercises pad_games; the game-sharded stream
    is deterministic per layout."""
    from fast_monte_carlo.api import SlateRunner
    from fast_monte_carlo.parallel import game_mesh

    a, b, heads, _ = nano
    gs = SlateRunner([(a, b), (a, b), (b, a)], heads, SimConfig(),
                     quality="nano", game_shard=True)
    df = gs.run_summaries(8, seed=0, chunk_pairs=8, mesh=game_mesh())
    assert len(df) == 3 and (df.n_games == 16).all()
    df2 = gs.run_summaries(8, seed=0, chunk_pairs=8, mesh=game_mesh())
    assert (df.win_a == df2.win_a).all() and (df.mean_a == df2.mean_a).all()
    assert list(df.team_a) == ["Team 030", "Team 030", "Team 041"]
