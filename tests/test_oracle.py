"""CPU oracle: determinism + box-score sanity with real artifacts."""
import numpy as np
import pytest

from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import load_sp_flex, build_team_context_from_sp_flex
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.oracle import OracleMatchup
from fast_monte_carlo.stats import TS


@pytest.fixture(scope="module")
def matchup(reference_dir):
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    heads = load_heads(reference_dir)
    return OracleMatchup(a, b, heads)


def test_oracle_deterministic(matchup):
    r1 = matchup.simulate_game(0, np.random.default_rng(42))
    r2 = matchup.simulate_game(0, np.random.default_rng(42))
    assert r1["score"] == r2["score"]
    np.testing.assert_array_equal(r1["stats"], r2["stats"])


def test_oracle_boxscore_sane(matchup):
    rng = np.random.default_rng(3)
    res = [matchup.simulate_game(i % 2, rng) for i in range(30)]
    scores = np.array([r["score"] for r in res], dtype=float)
    stats = np.mean([r["stats"] for r in res], axis=0)

    assert 10 < scores.mean() < 60          # plausible CFB team scoring
    assert (scores % 1 == 0).all()
    mean_team = stats.mean(axis=0)
    assert 50 < mean_team[TS["plays"]] < 110
    assert mean_team[TS["comp"]] <= mean_team[TS["pass_att"]]
    assert 0 < mean_team[TS["punts"]] < 12
    assert mean_team[TS["rz_TD"]] <= mean_team[TS["rz_trips"]] + 1e-9
    assert mean_team[TS["FG"]] <= mean_team[TS["FGA"]]
    assert mean_team[TS["fourth_conv"]] <= mean_team[TS["fourth_go"]] + 1e-9
    # points stat mirrors the final score
    for r in res:
        assert r["stats"][0, TS["points"]] == r["score"][0]
        assert r["stats"][1, TS["points"]] == r["score"][1]


def test_reset_caches_restores_fresh_worker_behavior(matchup):
    """reset_caches() == a fresh reference worker process: after warming the
    memo caches on other games, a reset instance reproduces a fresh
    instance's trajectory bit for bit at the same rng state (the cold-cache
    referee protocol, benchmarks/oracle_extend.py --cold)."""
    fresh = OracleMatchup(matchup.teams[0], matchup.teams[1], matchup.heads,
                          matchup.cfg)
    baseline = [fresh.simulate_game(i % 2, np.random.default_rng(77))
                for i in range(2)]

    warm_rng = np.random.default_rng(5)
    for i in range(6):                       # warm the shared fixture's caches
        matchup.simulate_game(i % 2, warm_rng)
    assert any(matchup._caches[0][c] for c in matchup._caches[0])
    matchup.reset_caches()
    assert all(not matchup._caches[s][c]
               for s in range(2) for c in matchup._caches[s])
    redo = [matchup.simulate_game(i % 2, np.random.default_rng(77))
            for i in range(2)]
    for r0, r1 in zip(baseline, redo):
        assert r0["score"] == r1["score"]
        np.testing.assert_array_equal(r0["stats"], r1["stats"])


def test_oracle_ml_play_policy_runs(matchup, reference_dir):
    """ML play-call path (recovered pickle) produces sane play balance."""
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    heads = load_heads(reference_dir)
    import dataclasses
    cfg = SimConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_play_model=True))
    m = OracleMatchup(a, b, heads, cfg)
    rng = np.random.default_rng(11)
    res = [m.simulate_game(i % 2, rng) for i in range(10)]
    st = np.mean([r["stats"] for r in res], axis=0).mean(axis=0)
    pass_rate = st[TS["pass_att"]] + st[TS["sacks"]] + 0.0
    total = pass_rate + st[TS["rush_att"]]
    assert 0.25 < pass_rate / total < 0.75  # ML policy is more balanced than heuristic
