"""Config-combination smoke matrix.

The rbg + score-only fusion pathology (CLAUDE.md) proved that ENGINE KNOB
COMBINATIONS, not individual knobs, are where landmines live — each knob
was fine alone and a config one flag away ran 7x slow.  Correctness-level
insurance for that class: every cell of the knob matrix must compile,
run, and produce sane scores (not bitwise anything — the dedicated tests
pin bitwise contracts where they hold).

Kept cheap: tiny batches on the CPU backend, analytic mode for the
orthogonal engine knobs (no artifacts, fast compile) and one nano-table
pass for the table-specific knobs."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest

from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig

# ~35 compiled programs: matrix-wide smoke belongs to the full suite,
# not the -m "not slow" dev loop
pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def contexts(reference_dir):
    from fast_monte_carlo.data import (
        build_team_context_from_sp_flex, load_sp_flex,
    )
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    return (build_team_context_from_sp_flex("Kansas State", 2025, 1, sp),
            build_team_context_from_sp_flex("Iowa State", 2025, 1, sp))


def _cfg(**engine_kw) -> SimConfig:
    cfg = SimConfig()
    return cfg.replace(engine=dataclasses.replace(cfg.engine, **engine_kw))


def _sane(runner, n_pairs=32, **run_kw):
    out = runner.run_pairs(n_pairs, seed=5, collect_players=False, **run_kw)
    sc = np.asarray(out.score)
    assert sc.shape == (2 * n_pairs, 2)
    assert (sc >= 0).all() and (sc <= 150).all()
    assert 5 < sc.mean() < 70
    return sc


# rng x stats x select: the axes of the round-3 fusion pathology
RNG = ("threefry", "rbg")
SELECT = ("auto", "chain", "dot")


@pytest.mark.parametrize("rng_impl,collect_stats,nano_select",
                         list(itertools.product(RNG, (False, True), SELECT)))
def test_rng_stats_select_matrix(contexts, reference_dir, rng_impl,
                                 collect_stats, nano_select):
    from fast_monte_carlo.models.heads import load_heads

    a, b = contexts
    heads = load_heads(reference_dir)
    r = MatchupRunner(a, b, heads,
                      _cfg(rng_impl=rng_impl, nano_select=nano_select),
                      mode="table", table_quality="nano")
    _sane(r, collect_stats=collect_stats)


# engine-loop knobs are head-agnostic: analytic mode keeps each cell fast
LOOP_CELLS = [
    dict(early_exit=False),
    dict(play_chunk=12),
    dict(play_chunk_tail=8),
    dict(scan_unroll=1),
    dict(scan_unroll=2),
    dict(antithetic=True),
    dict(sd_mode="frozen"),
    dict(sd_mode="marginal"),
]


@pytest.mark.parametrize("engine_kw", LOOP_CELLS,
                         ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_engine_loop_knob_cells(contexts, engine_kw):
    a, b = contexts
    r = MatchupRunner(a, b, None, _cfg(**engine_kw), mode="analytic")
    _sane(r)


def test_fumbles_head_cell(contexts, reference_dir):
    """enable_fumbles is a MODEL knob (cfg.model): the optional trained
    head the reference never wired (run_fumble.json)."""
    from fast_monte_carlo.models.heads import load_heads

    a, b = contexts
    heads = load_heads(reference_dir)
    cfg = SimConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                enable_fumbles=True))
    r = MatchupRunner(a, b, heads, cfg, mode="table", table_quality="nano")
    _sane(r)


def test_sd_mode_cachewarm_cell(contexts, reference_dir):
    """cachewarm needs real heads (it replays an oracle warm-up)."""
    from fast_monte_carlo.models.heads import load_heads

    a, b = contexts
    heads = load_heads(reference_dir)
    r = MatchupRunner(a, b, heads,
                      _cfg(sd_mode="cachewarm", cachewarm_games=16),
                      mode="table", table_quality="nano")
    _sane(r)


def test_summary_equals_raw_on_every_rng(contexts, reference_dir):
    """run_pairs_summary's device accumulation must agree with the raw
    score batch under every RNG implementation (not just the default)."""
    from fast_monte_carlo.models.heads import load_heads
    from fast_monte_carlo.parallel import summarize_scores

    a, b = contexts
    heads = load_heads(reference_dir)
    for rng_impl in RNG:
        r = MatchupRunner(a, b, heads, _cfg(rng_impl=rng_impl),
                          mode="table", table_quality="nano")
        s = r.run_pairs_summary(64, seed=3, chunk_pairs=16)
        out = []
        root = jax.random.PRNGKey(3)
        for ci in range(4):
            o = r.run_pairs(16, key=jax.random.fold_in(root, ci),
                            collect_players=False, collect_stats=False)
            out.append(np.asarray(o.score))
        ref = jax.tree_util.tree_map(
            np.asarray, jax.jit(summarize_scores)(np.concatenate(out)))
        np.testing.assert_allclose(np.asarray(s.win_rate), ref.win_rate,
                                   atol=1e-6)
        np.testing.assert_array_equal(np.asarray(s.margin_hist),
                                      ref.margin_hist)
