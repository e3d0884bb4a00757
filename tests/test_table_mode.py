"""Table-compiled fast path: exactness at grid points and distributional
agreement with exact mode (coarse test profiles keep build time down)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import load_sp_flex, build_team_context_from_sp_flex
from fast_monte_carlo.matchup import build_direction
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.models.tables import (
    build_tables, coarse_profile, slate_profile,
)
from fast_monte_carlo.ops.game import make_exact_heads_eval, simulate_games
from fast_monte_carlo.ops.pack import build_packs
from fast_monte_carlo.ops.table_lookup import (
    build_table_heads, make_table_heads_eval,
)
from fast_monte_carlo.stats import TS


@pytest.fixture(scope="module")
def env(reference_dir):
    cfg = SimConfig()
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    heads = load_heads(reference_dir)
    return cfg, a, b, heads


def test_table_exact_at_grid_points(env):
    cfg, a, b, heads = env
    d = build_direction(a, b, heads, cfg)
    prof = slate_profile()
    ts = build_tables(d, heads, cfg, fine=prof, coarse=prof)
    rng = np.random.default_rng(0)
    nd, ny, ns = len(prof.dist), len(prof.ytg), len(prof.sec)
    nsd = len(prof.sd) if prof.sd is not None else 1
    errs = []
    for _ in range(100):
        di, yi, si = rng.integers(0, nd), rng.integers(0, ny), rng.integers(0, ns)
        sdi = rng.integers(0, nsd)
        dn = rng.integers(0, 5)
        dist, ytg, sec = prof.dist[di], prof.ytg[yi], prof.sec[si]
        sd = prof.sd[sdi] if prof.sd is not None else 0.0
        x = np.array([[min(dn + 1, 5), dist, ytg, float(ytg <= 20), sd, sec, 3, 3,
                       d.sp_rating_off, d.sp_offense_rating_off,
                       d.sp_defense_rating_def, d.sp_rating_def,
                       float(dist >= ytg - 0.5),
                       float(dn + 1 == 4 and dist <= 2), float(ytg <= 33),
                       1.0 if sec > 1800 else 2.0,
                       float((sec % 1800) <= 120)]], dtype=np.float32)
        want = np.clip(heads.stage1_prob(x, d.qb_stage1[:1]) + d.bias, 0.02, 0.98)[0]
        flat = ((((ts.stage1.row_map[0] * 5 + dn) * nd + di) * ny + yi) * ns + si)
        if ts.stage1.has_sd:
            flat = flat * nsd + sdi
        errs.append(abs(ts.stage1.values[flat, 0] - want))
    assert float(np.max(errs)) < 1e-5


@pytest.mark.slow
def test_table_mode_matches_exact_mode(env):
    cfg, a, b, heads = env
    pack, hp = build_packs(a, b, heads, cfg)
    prof = coarse_profile()
    th = build_table_heads(a, b, heads, cfg, fine=prof, coarse=prof)
    te = make_table_heads_eval(cfg)
    he = make_exact_heads_eval(cfg)

    n = 768
    fo = jnp.asarray(np.arange(n) % 2, jnp.int32)
    t_out = jax.jit(lambda hs, k: simulate_games(
        pack, cfg, te, hs, k, n, fo, collect_players=False))(th, jax.random.PRNGKey(0))
    e_out = jax.jit(lambda hs, k: simulate_games(
        pack, cfg, he, hs, k, n, fo, collect_players=False))(hp, jax.random.PRNGKey(1))

    t_sc = np.asarray(t_out.score, float)
    e_sc = np.asarray(e_out.score, float)
    assert not np.isnan(np.asarray(t_out.stats)).any()
    # means within MC error + modest binning tolerance
    for c in (0, 1):
        assert abs(t_sc[:, c].mean() - e_sc[:, c].mean()) < 2.5
    dw = abs((t_sc[:, 0] > t_sc[:, 1]).mean() - (e_sc[:, 0] > e_sc[:, 1]).mean())
    assert dw < 0.09
    t_st = np.asarray(t_out.stats).mean(axis=0)
    e_st = np.asarray(e_out.stats).mean(axis=0)
    for key, tol in [("plays", 3.0), ("punts", 1.0), ("INT", 0.6), ("sacks", 0.7)]:
        for c in (0, 1):
            assert abs(t_st[c, TS[key]] - e_st[c, TS[key]]) < tol, (key, c)


def test_table_mode_with_ml_play_policy(env):
    """The recovered play model wired through a table with a score_diff axis."""
    cfg, a, b, heads = env
    cfg2 = cfg.replace(model=dataclasses.replace(cfg.model, use_play_model=True))
    pack, _ = build_packs(a, b, heads, cfg2)
    prof = slate_profile()
    th = build_table_heads(a, b, heads, cfg2, fine=prof, coarse=prof)
    assert th.play is not None
    te = make_table_heads_eval(cfg2)
    out = jax.jit(lambda hs, k: simulate_games(
        pack, cfg2, te, hs, k, 256, 0, collect_players=False))(th, jax.random.PRNGKey(2))
    st = np.asarray(out.stats).mean(axis=0)
    assert not np.isnan(st).any()
    # ML policy is run-heavier than the heuristic
    pass_plays = st[:, TS["pass_att"]].sum() + st[:, TS["sacks"]].sum()
    rush_plays = st[:, TS["rush_att"]].sum()
    assert rush_plays > 0.7 * pass_plays
