"""The seeded artifact set (seeded.py): heads at the published shapes, the
137-team SP+ sheet, the explicit ``seeded:<int>`` spelling, and the table
and exact modes driven by them on CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import ST1_FEATURES, load_heads
from fast_monte_carlo.seeded import seed_of, seeded_heads, seeded_sp_sheet

SEEDED = "seeded:0"

# (attribute, index in a quantile trio or None, trees, most node levels,
#  feature width): xgboost depth 7 is 8 node levels, GBR depth 3 is 4
HEAD_SHAPES = [
    ("stage1", None, 188, 8, 563 + 17),
    ("fumble", None, 104, 7, 1879),
] + [(attr, q, 400, 4, width)
     for attr, width in (("pass_quants", 563 + 1400 + 17),
                         ("rush_quants", 1862 + 17),
                         ("sack_quants", 563 + 17))
     for q in range(3)]


@pytest.fixture(scope="module")
def heads():
    return load_heads(SEEDED)


@pytest.fixture(scope="module")
def env(heads):
    sp = load_sp_flex(SEEDED)
    a = build_team_context_from_sp_flex("Team 030", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Team 041", 2025, 1, sp)
    return SimConfig(), a, b, heads


def _forest(heads, attr, q):
    f = getattr(heads, attr)
    return f if q is None else f[q]


@pytest.mark.parametrize("attr,q,n_trees,levels,width", HEAD_SHAPES,
                         ids=[f"{a}{'' if q is None else q}"
                              for a, q, *_ in HEAD_SHAPES])
def test_seeded_head_shapes(heads, attr, q, n_trees, levels, width):
    f = _forest(heads, attr, q)
    f.validate()
    assert f.n_trees == n_trees
    assert f.max_depth <= levels
    assert f.layout.n_features == width
    assert f.layout.numeric_names == ST1_FEATURES
    if attr in ("stage1", "fumble"):
        assert f.cmp == "lt" and f.zero_as_missing and f.link == "sigmoid"
    else:
        assert f.cmp == "le" and not f.zero_as_missing
        # sklearn grows full depth-3 trees: 15 nodes each
        assert f.n_nodes == 15 * n_trees


def test_seeded_absent_heads(heads):
    """Stage-2 and the play policy stay absent, as in the reference
    snapshot: the analytic stage-2 and the heuristic play call run."""
    assert heads.stage2 is None and heads.play is None


def test_seeded_heads_deterministic_in_seed():
    a, b, c = seeded_heads(3), seeded_heads(3), seeded_heads(4)
    for name in ("stage1", "fumble"):
        fa, fb, fc = (getattr(h, name) for h in (a, b, c))
        np.testing.assert_array_equal(fa.feat, fb.feat)
        np.testing.assert_array_equal(fa.leaf, fb.leaf)
        assert fa.n_nodes != fc.n_nodes or not np.array_equal(fa.leaf, fc.leaf)


def test_seeded_heads_look_like_football(heads, rng):
    from conftest import make_state_batch

    cols = make_state_batch(rng, 4000)
    x = np.stack([cols[f] for f in ST1_FEATURES], axis=1).astype(np.float32)
    unseen = np.full(len(x), -1)
    p = heads.stage1_prob(x, unseen)
    assert 0.5 < p.mean() < 0.7 and 0.3 < p.min() and p.max() < 0.9
    q10, q50, q90 = heads.pass_yard_quants(x, unseen, unseen)
    assert abs(q50.mean() - 8.0) < 1.5
    assert (q10.mean() < q50.mean() < q90.mean())
    r10, r50, r90 = heads.rush_yard_quants(x, unseen)
    assert r10.mean() < r50.mean() < r90.mean()
    fum = heads.fumble_prob(x, unseen)
    assert 0.003 < fum.mean() < 0.05


def test_seeded_sp_sheet_schema_b():
    raw = seeded_sp_sheet(0)
    assert list(raw.columns) == ["Current SP+", "Past SP+", "Rating",
                                 "Offense Rating", "Defense Rating"]
    assert len(raw) == 137
    np.testing.assert_allclose(
        raw["Offense Rating"] - raw["Defense Rating"], raw["Rating"],
        atol=1e-6)
    sp = load_sp_flex(SEEDED)
    assert len(sp) == 137
    assert sp.iloc[0]["team"] == "Team 001"
    assert sp["RATING"].is_monotonic_decreasing


def test_seeded_spelling():
    assert seed_of("seeded:7") == 7
    assert seed_of("/data/artifacts") is None
    with pytest.raises(ValueError, match="seeded:<int>"):
        seed_of("seeded:abc")


def test_missing_real_paths_stay_errors(tmp_path):
    """A missing artifact dir or SP+ file never falls back to seeded data."""
    with pytest.raises(FileNotFoundError, match="seeded:<int>"):
        load_heads(tmp_path / "absent", memoize=False)
    with pytest.raises(FileNotFoundError):
        load_sp_flex(str(tmp_path / "absent.csv"))


def test_nano_table_and_table_mode_run(env):
    """The nano table built from the seeded heads (the main path's one
    gather per play) and a 2,048-game table-mode summary on CPU."""
    from fast_monte_carlo.api import MatchupRunner

    cfg, a, b, heads = env
    r = MatchupRunner(a, b, heads, cfg, mode="table", table_quality="nano")
    th = r.heads_state
    assert th.nano is not None and th.fused is None
    assert th.nano.values.shape[0] == 16384        # 8,192 rows per direction
    s = r.run_pairs_summary(1024, seed=0, chunk_pairs=512)
    assert int(s.n) == 2048
    w, tie, mean = (np.asarray(s.win_rate), float(s.tie_rate),
                    np.asarray(s.mean_pts))
    assert abs(w.sum() + tie - 1.0) < 1e-6
    assert all(10 < m < 45 for m in mean) and 35 < mean.sum() < 75


def test_dot_and_chain_select_bitwise_equal(env):
    """nano_select 'dot' (HIGHEST-precision einsum) and 'chain' (masked
    adds) produce identical scores under the same key."""
    from fast_monte_carlo.api import MatchupRunner

    cfg, a, b, heads = env
    scores = {}
    for sel in ("dot", "chain"):
        c = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                   nano_select=sel))
        r = MatchupRunner(a, b, heads, c, mode="table", table_quality="nano")
        out = r.run_pairs(1024, seed=4, collect_players=False,
                          collect_stats=False)
        scores[sel] = np.asarray(out.score)
    np.testing.assert_array_equal(scores["dot"], scores["chain"])


def test_table_mode_matches_exact_mode_seeded(env):
    """Exact mode (per-play forest walks over the seeded forests) and nano
    table mode agree within the bounds tests/test_table_mode.py uses."""
    from fast_monte_carlo.ops.game import make_exact_heads_eval, simulate_games
    from fast_monte_carlo.ops.pack import build_packs
    from fast_monte_carlo.ops.table_lookup import (
        build_table_heads, make_table_heads_eval,
    )
    from fast_monte_carlo.models.tables import nano_profile
    from fast_monte_carlo.stats import TS

    cfg, a, b, heads = env
    # unroll 1: the same trajectories as the default unroll, a quarter of
    # the compile time for the 15-forest exact step
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, scan_unroll=1))
    pack, hp = build_packs(a, b, heads, cfg)
    th = build_table_heads(a, b, heads, cfg, nano=nano_profile())

    def run(he, hs, n, seed):
        fo = jnp.asarray(np.arange(n) % 2, jnp.int32)
        out = jax.jit(lambda h, k: simulate_games(
            pack, cfg, he, h, k, n, fo, collect_players=False))(
            hs, jax.random.PRNGKey(seed))
        return np.asarray(out.score, float), np.asarray(out.stats)

    e_sc, e_st = run(make_exact_heads_eval(cfg), hp, 384, 1)
    t_sc, t_st = run(make_table_heads_eval(cfg), th, 2048, 0)
    assert not np.isnan(e_st).any()
    for c in (0, 1):
        assert abs(t_sc[:, c].mean() - e_sc[:, c].mean()) < 2.5
    dw = abs((t_sc[:, 0] > t_sc[:, 1]).mean() - (e_sc[:, 0] > e_sc[:, 1]).mean())
    assert dw < 0.09
    em, tm = e_st.mean(axis=0), t_st.mean(axis=0)
    for key, tol in [("plays", 3.0), ("punts", 1.0), ("INT", 0.6), ("sacks", 0.7)]:
        for c in (0, 1):
            assert abs(tm[c, TS[key]] - em[c, TS[key]]) < tol, (key, c)
