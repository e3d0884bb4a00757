"""Full-fidelity RECONSTRUCTED mode (VERDICT r4 #6): one flag turns on
the recovered ML play policy + repo-trained stage-2 + non-unit
temperature, and a default-on test bounds the engine against the mode's
own committed oracle referee stream
(benchmarks/oracle_reconstructed_8000.npz, seed 321 —
benchmarks/reconstructed_parity.py regenerates)."""
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
STREAM = REPO / "benchmarks" / "oracle_reconstructed_8000.npz"


def test_reconstructed_config_and_overlay(reference_dir):
    """The preset flips the play-model flag and the overlay fills exactly
    the snapshot's two missing artifacts: stage-2 head and temperature."""
    from fast_monte_carlo.config import SimConfig, reconstructed_config
    from fast_monte_carlo.models.heads import (
        RECONSTRUCTED_DIR, load_heads, load_reconstructed_heads)

    cfg = reconstructed_config()
    assert cfg.model.use_play_model is True
    assert cfg.replace(model=SimConfig().model) == SimConfig()  # one knob

    assert RECONSTRUCTED_DIR.is_dir(), "committed overlay missing"
    base = load_heads(str(reference_dir))
    rec = load_reconstructed_heads(str(reference_dir))
    assert base.stage2 is None and rec.stage2 is not None
    assert rec.stage2_class_order == ("incomplete", "intercepted", "sack")
    assert base.play_temperature == 1.0 and rec.play_temperature != 1.0
    # everything else is shared with the base load (same objects)
    assert rec.stage1 is base.stage1 and rec.play is base.play
    assert rec.pass_quants is base.pass_quants
    # memoized: repeat call returns the same merged instance (pack memos
    # key on instance identity)
    assert load_reconstructed_heads(str(reference_dir)) is rec


def test_reconstructed_stage2_probs_are_sane(reference_dir):
    """The reconstructed stage-2 head produces calibrated conditionals
    (the plausible-football guarantee reconstruct_stage2 exists for),
    near the analytic fallback it was labeled from."""
    from fast_monte_carlo.config import SimConfig
    from fast_monte_carlo.models.heads import (
        ST1_FEATURES, load_reconstructed_heads)

    heads = load_reconstructed_heads(str(reference_dir))
    cfg = SimConfig()
    n = 256
    rng = np.random.default_rng(3)
    x = np.zeros((n, len(ST1_FEATURES)), np.float32)
    x[:, ST1_FEATURES.index("down")] = rng.integers(1, 5, n)
    x[:, ST1_FEATURES.index("distance")] = rng.uniform(1, 15, n)
    x[:, ST1_FEATURES.index("yardsToGoal")] = rng.uniform(5, 95, n)
    x[:, ST1_FEATURES.index("seconds_remaining")] = rng.uniform(60, 3600, n)
    ids = np.zeros(n, np.int64)
    inc, itc, sck = heads.stage2_probs(x, ids, ids, cfg)
    s = inc + itc + sck
    assert np.allclose(s, 1.0, atol=1e-5)
    assert 0.60 < inc.mean() < 0.90      # ~0.78 analytic base
    assert 0.02 < itc.mean() < 0.15      # ~0.08 — NOT the 1/3 prior-shift
    assert 0.05 < sck.mean() < 0.30


@pytest.mark.slow   # one nano table build for the reconstructed cfg (~1 min)
def test_reconstructed_engine_matches_committed_stream(reference_dir):
    """DEFAULT-ON parity bound: engine (nano tables, reconstructed mode)
    vs the mode's committed 8,000-game MEMOIZED oracle stream.
    Deterministic (fixed seeds, stream on disk) — a regression pin with
    the bound set to a 1.5pp freeze-lift allowance + 3.5 sampling SEs:
    the memoized referee sits ~+1.9pp above the engine and the round-5
    diagnosis pinned that on the referee's caches, not the engine —
    table-quality-INVARIANT (nano/turbo/default within 0.07pp), and the
    memoize=False oracle probe
    (benchmarks/oracle_reconstructed_nomemo_4096.npz: 0.56616 ± 0.77pp)
    agrees with the engine (0.5599, z = -0.8) while sitting +1.3pp below
    the memoized stream — the same cache-freeze mechanism the main error
    budget measures (benchmarks/RECONSTRUCTED_PARITY.md;
    VALIDATION.md round 5)."""
    from fast_monte_carlo.api import MatchupRunner
    from fast_monte_carlo.config import reconstructed_config
    from fast_monte_carlo.data import (build_team_context_from_sp_flex,
                                           load_sp_flex)
    from fast_monte_carlo.models.heads import load_reconstructed_heads

    assert STREAM.exists(), (
        "committed referee stream missing — regenerate via "
        "benchmarks/reconstructed_parity.py")
    o = np.load(STREAM)["score"].astype(float)
    assert len(o) >= 8000

    cfg = reconstructed_config()
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    heads = load_reconstructed_heads(str(reference_dir))
    r = MatchupRunner(A, B, heads, cfg, mode="table", table_quality="nano")
    out = r.run_pairs(8192, seed=21, collect_players=False,
                      collect_stats=False)
    e = np.asarray(out.score, float)

    w_o = float((o[:, 0] > o[:, 1]).mean())
    w_e = float((e[:, 0] > e[:, 1]).mean())
    se = float(np.sqrt(w_o * (1 - w_o) / len(o) + w_e * (1 - w_e) / len(e)))
    assert abs(w_e - w_o) < 0.015 + 3.5 * se, (
        f"reconstructed win drift: engine {w_e:.4f} vs stream {w_o:.4f} "
        f"(SE {se:.4f})")
    m_o, m_e = o[:, 0] - o[:, 1], e[:, 0] - e[:, 1]
    assert abs(m_e.mean() - m_o.mean()) < 1.5
    assert abs(m_e.std(ddof=1) - m_o.std(ddof=1)) < 2.0
    t_o, t_e = o.sum(1).mean(), e.sum(1).mean()
    assert abs(t_e - t_o) < 2.5
