"""Device engine vs CPU oracle: distributional equivalence + determinism.

The engine cannot (and need not) match the oracle bitwise — RNG streams
differ by construction (SURVEY §3.5).  Acceptance is distributional: game
outcome moments agree within Monte-Carlo error bounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import load_sp_flex, build_team_context_from_sp_flex
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.ops.game import make_exact_heads_eval, simulate_games
from fast_monte_carlo.ops.pack import build_packs
from fast_monte_carlo.oracle import OracleMatchup
from fast_monte_carlo.stats import TS


@pytest.fixture(scope="module")
def setup(reference_dir):
    cfg = SimConfig()
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    heads = load_heads(reference_dir)
    pack, hp = build_packs(a, b, heads, cfg)
    return cfg, a, b, heads, pack, hp


def test_engine_deterministic(setup):
    cfg, a, b, heads, pack, hp = setup
    he = make_exact_heads_eval(cfg)
    run = jax.jit(lambda hs, k: simulate_games(pack, cfg, he, hs, k, 64, 0, collect_players=False))
    r1 = run(hp, jax.random.PRNGKey(5))
    r2 = run(hp, jax.random.PRNGKey(5))
    np.testing.assert_array_equal(np.asarray(r1.score), np.asarray(r2.score))
    r3 = run(hp, jax.random.PRNGKey(6))
    assert (np.asarray(r1.score) != np.asarray(r3.score)).any()


def test_engine_all_games_finish(setup):
    cfg, a, b, heads, pack, hp = setup
    he = make_exact_heads_eval(cfg)
    out = jax.jit(lambda hs, k: simulate_games(pack, cfg, he, hs, k, 128, 1, collect_players=False))(
        hp, jax.random.PRNGKey(0))
    assert int(np.asarray(out.sec).max()) == 0
    sc = np.asarray(out.score)
    assert (sc >= 0).all() and sc.max() < 150


@pytest.mark.slow
def test_engine_matches_oracle_distributionally(setup):
    cfg, a, b, heads, pack, hp = setup
    n_engine, n_oracle = 1024, 256

    he = make_exact_heads_eval(cfg)
    fo = jnp.asarray(np.arange(n_engine) % 2, jnp.int32)
    out = jax.jit(lambda hs, k: simulate_games(
        pack, cfg, he, hs, k, n_engine, fo, collect_players=False))(hp, jax.random.PRNGKey(42))
    e_sc = np.asarray(out.score, dtype=float)
    e_st = np.asarray(out.stats)

    m = OracleMatchup(a, b, heads, cfg)
    rng = np.random.default_rng(0)
    res = [m.simulate_game(i % 2, rng) for i in range(n_oracle)]
    o_sc = np.asarray([r["score"] for r in res], dtype=float)
    o_st = np.mean([r["stats"] for r in res], axis=0)

    # win prob: SE ~ sqrt(p(1-p)(1/n1+1/n2)) ~ 3.3% -> 3.5 sigma bound
    dw = abs((e_sc[:, 0] > e_sc[:, 1]).mean() - (o_sc[:, 0] > o_sc[:, 1]).mean())
    assert dw < 0.115, dw

    # mean team scores within combined MC error (sd ~ 12.5)
    se = 12.5 * np.sqrt(1 / n_engine + 1 / n_oracle)
    for t in (0, 1):
        d = abs(e_sc[:, t].mean() - o_sc[:, t].mean())
        assert d < 4.0 * se + 0.5, (t, d, se)

    # box-score means agree loosely
    e_mean = e_st.mean(axis=0)
    for key, tol in [("plays", 3.0), ("pass_att", 3.0), ("comp", 2.5),
                     ("rush_att", 2.5), ("punts", 1.0), ("INT", 0.6),
                     ("sacks", 0.6), ("FGA", 0.7), ("rz_trips", 1.0),
                     ("fourth_go", 0.6)]:
        for t in (0, 1):
            d = abs(e_mean[t, TS[key]] - o_st[t, TS[key]])
            assert d < tol, (key, t, float(e_mean[t, TS[key]]), float(o_st[t, TS[key]]))


@pytest.mark.slow
def test_engine_fumbles_extension(setup):
    cfg, a, b, heads, pack, hp = setup
    cfg2 = cfg.replace(model=dataclasses.replace(cfg.model, enable_fumbles=True))
    he = make_exact_heads_eval(cfg2)
    out = jax.jit(lambda hs, k: simulate_games(pack, cfg2, he, hs, k, 256, 0, collect_players=False))(
        hp, jax.random.PRNGKey(1))
    st = np.asarray(out.stats).mean(axis=0)
    fl = st[:, TS["fumbles_lost"]].sum()
    # The head is trained with fully balanced class weights
    # (train_run_fumble.py) so its raw probabilities overestimate the base
    # rate; presence is what we assert here.
    assert 0.0 < fl < 8.0


def test_merged_forest_matches_per_forest(setup):
    """Exact mode's one-walk MergedForest reproduces the per-forest head
    outputs to fp tolerance on random play states."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from fast_monte_carlo.ops.game import (
        StepObs, _state_features, make_exact_heads_eval,
    )

    cfg, a, b, heads, pack, hp = setup
    assert hp.merged is not None
    cfg_merged = cfg.replace(
        engine=dataclasses.replace(cfg.engine, exact_merged=True))
    hp_plain = dataclasses.replace(hp, merged=None)
    rng = np.random.default_rng(4)
    n = 256
    down = jnp.asarray(rng.integers(1, 6, n), jnp.int32)
    dist = jnp.asarray(np.round(rng.uniform(0.5, 25, n) * 2) / 2, jnp.float32)
    ytg = jnp.asarray(rng.integers(1, 100, n), jnp.float32)
    sec = jnp.asarray(rng.integers(0, 3601, n), jnp.int32)
    sd = jnp.asarray(rng.integers(-21, 22, n), jnp.float32)
    dirx = jnp.asarray(rng.integers(0, 2, n), jnp.int32)
    x = _state_features(pack, cfg, dirx, down, dist, ytg, sec, sd)
    obs = StepObs(x=x, sd=sd, dirx=dirx, off=dirx, down=down, dist=dist,
                  ytg=ytg, sec=sec,
                  qb=jnp.asarray(rng.integers(0, pack.k, n), jnp.int32),
                  wr=jnp.asarray(rng.integers(0, pack.k, n), jnp.int32),
                  rb=jnp.asarray(rng.integers(0, pack.k, n), jnp.int32))
    o1 = make_exact_heads_eval(cfg_merged)(hp, obs, pack)
    o2 = make_exact_heads_eval(cfg)(hp_plain, obs, pack)
    for f in ("p_complete", "s2_cum", "pass_ms", "rush_ms", "sack_ms",
              "p_fumble"):
        np.testing.assert_allclose(np.asarray(getattr(o1, f)),
                                   np.asarray(getattr(o2, f)),
                                   rtol=2e-4, atol=2e-4, err_msg=f)
