"""Antithetic-variates engine flag (EngineConfig.antithetic).

Measured disposition (benchmarks/antithetic_check.py): within-pair margin
rho ~ -0.004, so the flag is variance-NEUTRAL for this workload; its value
is halving per-step RNG generation.  These tests pin the contract: draws
are mirrored only when B % 4 == 0, results stay unbiased, and the
non-eligible path is bitwise-identical to the plain engine.
"""
import dataclasses

import jax
import numpy as np
import pytest

from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.ops.game import make_analytic_heads_eval, simulate_games
from fast_monte_carlo.ops.pack import build_packs


@pytest.fixture(scope="module")
def setup(reference_dir):
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    return a, b, load_heads(reference_dir)


def _cfg(anti: bool) -> SimConfig:
    cfg = SimConfig()
    return cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=anti))


def _run(a, b, heads, cfg, n, seed=0):
    pack, _ = build_packs(a, b, heads, cfg)
    he = make_analytic_heads_eval(cfg)
    fo = np.arange(n) % 2
    out = jax.jit(lambda k: simulate_games(
        pack, cfg, he, None, k, n, fo, collect_players=False))(
        jax.random.PRNGKey(seed))
    return np.asarray(out.score), np.asarray(out.sec)


@pytest.mark.slow
def test_non_multiple_of_4_is_bitwise_plain(setup):
    """B % 4 != 0 disables mirroring: identical program, identical draws."""
    a, b, heads = setup
    s_plain, _ = _run(a, b, heads, _cfg(False), 6)
    s_anti, _ = _run(a, b, heads, _cfg(True), 6)
    np.testing.assert_array_equal(s_plain, s_anti)


@pytest.mark.slow
def test_antithetic_games_finish_and_are_unbiased(setup):
    a, b, heads = setup
    n = 4096
    s_anti, sec = _run(a, b, heads, _cfg(True), n, seed=11)
    assert int(sec.max()) == 0
    s_plain, _ = _run(a, b, heads, _cfg(False), n, seed=11)
    w_a = (s_anti[:, 0] > s_anti[:, 1]).mean()
    w_p = (s_plain[:, 0] > s_plain[:, 1]).mean()
    # two independent n=4096 estimates: SE of the difference ~ 1.1%
    assert abs(w_a - w_p) < 0.045
    assert abs(s_anti.mean() - s_plain.mean()) < 1.5


def test_antithetic_mirrors_pairs(setup):
    """Rows 4k/4k+1 vs 4k+2/4k+3 see mirrored draws: with identical
    initial state and SAME first_offense everywhere, a pair's games are
    deterministic functions of mirrored streams — they must differ from
    their partner exactly when the mirrored draws change an outcome, and
    the pair-vs-fresh structure must hold: partner games equal the result
    of re-running with u -> 1-u.  We pin the cheap observable: at n=4 with
    equal fo, games 0,1 and 2,3 are two draw-coupled pairs, and across
    many seeds the partner game must sometimes differ from the primary
    (mirroring is real) while plain mode's rows 0 and 2 (same fo, same
    matchup, different fold) also differ — i.e. mirroring neither clones
    nor freezes partners."""
    a, b, heads = setup
    cfg = _cfg(True)
    pack, _ = build_packs(a, b, heads, cfg)
    he = make_analytic_heads_eval(cfg)
    run = jax.jit(lambda k: simulate_games(
        pack, cfg, he, None, k, 4, 0, collect_players=False))
    diffs = 0
    for seed in range(6):
        sc = np.asarray(run(jax.random.PRNGKey(seed)).score)
        diffs += int((sc[0] != sc[2]).any()) + int((sc[1] != sc[3]).any())
    assert diffs > 0
