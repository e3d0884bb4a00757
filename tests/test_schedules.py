"""Chunk-schedule engine paths.

A descending chunk schedule must be BITWISE identical to the default
single-chunk threefry engine: draw streams key on the absolute step index,
so they are schedule-invariant."""
import dataclasses

import jax
import numpy as np
import pytest

from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import (
    build_team_context_from_sp_flex, load_sp_flex,
)
from fast_monte_carlo.models.heads import ModelHeads
from fast_monte_carlo.ops.game import (
    make_analytic_heads_eval, simulate_games,
)
from fast_monte_carlo.ops.pack import build_packs


@pytest.fixture(scope="module")
def env(reference_dir):
    cfg = SimConfig()
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    pack, _ = build_packs(a, b, ModelHeads(), cfg)
    he = make_analytic_heads_eval(cfg)
    n = 192
    base = simulate_games(pack, cfg, he, None, jax.random.PRNGKey(0), n, 0,
                          collect_players=False)
    return cfg, pack, he, n, np.asarray(base.score)


def _run(cfg, pack, he, n):
    out = simulate_games(pack, cfg, he, None, jax.random.PRNGKey(0), n, 0,
                         collect_players=False)
    return np.asarray(out.score)


def test_tail_schedule_bitwise_identical(env):
    cfg, pack, he, n, want = env
    for tail in (8, 12):
        cfg_t = cfg.replace(engine=dataclasses.replace(
            cfg.engine, play_chunk_tail=tail))
        np.testing.assert_array_equal(_run(cfg_t, pack, he, n), want)
