"""Alt model wrappers (SURVEY R17) + profiling utils + batched resume."""
import numpy as np
import pytest

from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.models.wrappers import PlayPolicy, QuantileYards
from fast_monte_carlo.utils import SimMeter, device_memory_stats


@pytest.fixture(scope="module")
def heads(reference_dir):
    return load_heads(reference_dir)


def test_play_policy_wrapper(heads):
    pp = PlayPolicy(heads.play, heads.play_temperature, heads.play_classes)
    x = np.array([[3, 8, 50, 0, -3, 1500, 3, 3, 15.6, 35.7, 20.6, 11.0]],
                 dtype=np.float32)
    p = pp.predict_proba(x, {"head_coach": np.array([24])})
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-6)
    a = pp.sample_action(x, {"head_coach": np.array([24])},
                         rng=np.random.default_rng(0))
    assert 0 <= a < len(heads.play_classes)


def test_quantile_yards_inverse_cdf(reference_dir):
    qy = QuantileYards.load(str(reference_dir / "run_yards"))
    x = np.array([[1, 10, 75, 0, 0, 3600, 3, 3, 15.6, 35.7, 20.6, 11.0,
                   0, 0, 0, 1, 0]], dtype=np.float32)
    cat = {"rusher_name": np.array([-1])}
    q10, q50, q90 = qy.quantiles(x, cat)
    assert q10[0] <= q50[0] <= q90[0]
    rng = np.random.default_rng(0)
    ys = np.concatenate([qy.sample(x, -10, 40, cat_ids=cat, rng=rng)
                         for _ in range(400)])
    assert (-10 <= ys).all() and (ys <= 40).all()
    # median of samples near q50 (inverse CDF median = q50)
    assert abs(np.median(ys) - q50[0]) < 2.0


def test_pass_outcome_two_stage_composition(reference_dir, heads):
    """Stage-2 booster is missing from the snapshot, so compose with a
    synthetic stage2 via direct construction."""
    from fast_monte_carlo.models.wrappers import PassOutcomeTwoStage
    if heads.stage2 is None:
        pytest.skip("no stage2 artifact in snapshot (expected)")
    w = PassOutcomeTwoStage(heads.stage1, heads.stage2, heads.stage2_class_order)
    x = np.zeros((1, 17), np.float32)
    p = w.predict_proba(x, np.array([-1]))
    np.testing.assert_allclose(p.sum(), 1.0, atol=1e-6)


def test_sim_meter():
    m = SimMeter()
    with m.phase("build"):
        pass
    m.record_run(1000, 0.5)
    s = m.summary()
    assert s["games"] == 1000
    assert s["games_per_sec"] == pytest.approx(2000.0)
    assert "build" in m.dump()


def test_device_memory_stats_shape():
    out = device_memory_stats()
    assert isinstance(out, dict)


def test_batched_resume(tmp_path, reference_dir):
    from fast_monte_carlo.api import simulate_matchup_batched
    from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex

    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    df1 = simulate_matchup_batched(a, b, None, 48, 16, tmp_path,
                                   mode="analytic", seed=9)
    assert len(df1) == 96
    chunks = sorted(tmp_path.glob("scores_chunk_*.parquet"))
    assert len(chunks) == 3
    chunks[-1].unlink()  # simulate a killed run missing the last chunk
    df2 = simulate_matchup_batched(a, b, None, 48, 16, tmp_path,
                                   mode="analytic", seed=9)
    assert len(df2) == 96
    # resumed chunks identical to the originals (deterministic per chunk)
    import pandas as pd
    pd.testing.assert_frame_equal(
        df1.iloc[:64].reset_index(drop=True), df2.iloc[:64].reset_index(drop=True))
    # the dir carries the chunk-key scheme marker
    assert (tmp_path / "KEY_SCHEME").read_text().strip() == "fold_in-v2"


def test_batched_refuses_foreign_key_scheme(tmp_path, reference_dir):
    """A run_dir holding chunks from another (or unmarked, pre-fold_in)
    chunk-key convention must be refused, not silently spliced."""
    from fast_monte_carlo.api import simulate_matchup_batched
    from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex

    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)

    legacy = tmp_path / "legacy"
    legacy.mkdir()
    (legacy / "scores_chunk_00000.parquet").write_bytes(b"")
    with pytest.raises(ValueError, match="no KEY_SCHEME marker"):
        simulate_matchup_batched(a, b, None, 32, 16, legacy, mode="analytic")

    other = tmp_path / "other"
    other.mkdir()
    (other / "KEY_SCHEME").write_text("seed_plus_chunk-v1\n")
    with pytest.raises(ValueError, match="chunk-key scheme"):
        simulate_matchup_batched(a, b, None, 32, 16, other, mode="analytic")


def test_heads_memo_fingerprint_covers_every_probed_artifact():
    """_ARTIFACT_NAMES (the memo's staleness fingerprint) must name every
    file load_heads probes — a probe missing from the list means edits to
    that artifact would serve stale memoized heads (the scaler.pkl bug)."""
    import inspect
    import re

    from fast_monte_carlo.models import heads as H

    src = inspect.getsource(H)
    # every literal `d / "name"` probe in the module (loader + helpers);
    # f-string probes (the quantile heads) are enumerated in the list
    # explicitly and aren't catchable by this scan
    probed = set(re.findall(r'd\s*/\s*"([^"]+)"', src))
    assert "scaler.pkl" in probed, "regex drifted from the loader source"
    missing = probed - set(H._ARTIFACT_NAMES)
    assert not missing, f"artifact probes missing from _ARTIFACT_NAMES: {missing}"


def test_heads_memo_is_bounded(monkeypatch, tmp_path):
    from fast_monte_carlo.models import heads as H

    monkeypatch.setattr(H, "_HEADS_MEMO", {})
    monkeypatch.setattr(H, "_HEADS_MEMO_MAX", 3)
    # each distinct resolved dir is a distinct memo key (empty dirs: the
    # artifact fingerprint is all-None, so vary the path)
    for i in range(6):
        d = tmp_path / f"art{i}"
        d.mkdir()
        H.load_heads(d)
    assert len(H._HEADS_MEMO) <= 3
