"""Game-axis batched slates: one program, many matchups, sharded trials."""
import jax
import numpy as np
import pytest

from fast_monte_carlo.api import MatchupRunner, SlateRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads


@pytest.fixture(scope="module")
def slate(reference_dir):
    cfg = SimConfig()
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    teams = [("Kansas State", "Iowa State"), ("Alabama", "Georgia"),
             ("Oregon", "Washington")]
    ms = [(build_team_context_from_sp_flex(a, 2025, 1, sp),
           build_team_context_from_sp_flex(b, 2025, 1, sp)) for a, b in teams]
    heads = load_heads(reference_dir)
    return cfg, ms, heads


def test_slate_runner_matches_per_matchup(slate):
    cfg, ms, heads = slate
    sr = SlateRunner(ms, heads, cfg)
    out = sr.run(384, seed=0)
    df = sr.summaries(out)
    assert len(df) == 3 and (df.n_games == 768).all()

    # game 0 must match the single-matchup fused runner distributionally
    single = MatchupRunner(ms[0][0], ms[0][1], heads, cfg, mode="table",
                           table_quality="fused")
    s_out = single.run_pairs(384, seed=1, collect_players=False)
    s_sc = np.asarray(s_out.score, dtype=float)
    row = df.iloc[0]
    assert abs(row.mean_a - s_sc[:, 0].mean()) < 2.0
    assert abs(row.win_a - (s_sc[:, 0] > s_sc[:, 1]).mean()) < 0.08
    # games differ from each other (different packs actually selected)
    assert abs(df.iloc[2].win_a - df.iloc[0].win_a) > 0.02  # Oregon ~0.80


def test_slate_runner_sharded(slate):
    cfg, ms, heads = slate
    sr = SlateRunner(ms, heads, cfg, shard=True)
    out = sr.run(128, seed=3)
    assert len(out.score.sharding.device_set) == 8
    df = sr.summaries(out)
    assert (df.n_games == 256).all()
    assert 0 <= df.win_a.min() and df.win_a.max() <= 1


def test_slate_runner_nano_quality(slate):
    """Nano-layout slates: same summaries as the default (coarse-fused)
    SlateRunner within MC noise, on the sharded path too."""
    cfg, ms, heads = slate
    sr = SlateRunner(ms, heads, cfg, quality="nano")
    out = sr.run(384, seed=5)
    assert sr.heads_state.nano is not None and sr.heads_state.fused is None
    df = sr.summaries(out)
    assert len(df) == 3 and (df.n_games == 768).all()
    base = SlateRunner(ms, heads, cfg).summaries(
        SlateRunner(ms, heads, cfg).run(384, seed=6))
    for i in range(3):
        assert abs(df.iloc[i].win_a - base.iloc[i].win_a) < 0.09, i
        assert abs(df.iloc[i].mean_total - base.iloc[i].mean_total) < 2.5, i

    sharded = SlateRunner(ms, heads, cfg, quality="nano", shard=True)
    out2 = sharded.run(64, seed=7)
    assert len(out2.score.sharding.device_set) == 8


def test_slate_game_sharded_summaries(slate):
    """The game-sharded production path (device d owns matchups g ≡ d mod N,
    per-matchup ~16k-row tables only, in-scan moment reduction): per-matchup
    summaries must match the shared-table SlateRunner within MC noise.
    3 matchups on 8 devices also exercises the pad-to-mesh path."""
    cfg, ms, heads = slate
    gs = SlateRunner(ms, heads, cfg, quality="nano", game_shard=True)
    # stacked per-game tables: leading game axis, per-game ~16k rows
    assert gs.stacked_tables.nano.values.ndim == 3
    assert gs.stacked_tables.nano.values.shape[0] == 3
    df = gs.run_summaries(256, seed=11, chunk_pairs=128)
    assert len(df) == 3 and (df.n_games == 512).all()
    assert 0 <= df.win_a.min() and df.win_a.max() <= 1

    base_sr = SlateRunner(ms, heads, cfg, quality="nano")
    base = base_sr.summaries(base_sr.run(256, seed=12))
    for i in range(3):
        assert abs(df.iloc[i].win_a - base.iloc[i].win_a) < 0.10, i
        assert abs(df.iloc[i].mean_total - base.iloc[i].mean_total) < 3.0, i
    # distinct matchups actually simulated per game stripe
    assert abs(df.iloc[2].win_a - df.iloc[0].win_a) > 0.02


def test_slate_game_sharded_chunks_accumulate(slate):
    """Two 64-pair launches must equal one 128-pair launch's n, and the
    run() raw path must refuse game_shard mode."""
    cfg, ms, heads = slate
    gs = SlateRunner(ms[:2], heads, cfg, quality="nano", game_shard=True)
    df = gs.run_summaries(128, seed=3, chunk_pairs=64)
    assert (df.n_games == 256).all()
    with pytest.raises(ValueError):
        gs.run(16)


def test_slate_game_sharded_return_summaries(slate):
    """return_summaries exposes each matchup's device-accumulated
    ScoreSummary (histograms included) so edge.slate_market_table prices
    the whole slate with no further simulation."""
    import pandas as pd

    from fast_monte_carlo.edge import slate_market_table

    cfg, ms, heads = slate
    gs = SlateRunner(ms, heads, cfg, quality="nano", game_shard=True)
    df, summs = gs.run_summaries(64, seed=2, chunk_pairs=64,
                                 return_summaries=True)
    assert len(summs) == 3
    for i in range(3):
        assert int(np.asarray(summs[i].n)) == int(df.iloc[i].n_games)
    lines = pd.DataFrame({"spread": [-3.0, 1.5, -6.5],
                          "total": [52.5, 48.5, 58.5]})  # positional match
    tab = slate_market_table(ms, summs, lines)  # (TeamContext, TeamContext)
    assert len(tab) == 3
    assert (tab.team_a == df.team_a).all()
    assert (tab.n == df.n_games).all()
    for i in range(3):
        # hist-derived moneyline == the summary win rate (margin>0 <=> win)
        assert tab.iloc[i].p_win_a == pytest.approx(df.iloc[i].win_a,
                                                    abs=1e-6)
        assert 0.0 <= tab.iloc[i].p_cover_a <= 1.0
        assert 0.0 <= tab.iloc[i].p_over <= 1.0


def test_simulate_slate_summaries_sharded(reference_dir):
    """simulate_slate_summaries: the RECOMMENDED multi-chip slate path
    (per-matchup launches, trial axis sharded over the mesh, one end
    transfer).  The sharded sweep is deterministic in (seed, device count)
    — per-device fold_in keys make the stream a function of the layout —
    and must agree with the single-device sweep within MC error."""
    import jax

    from fast_monte_carlo.api import simulate_slate_summaries

    sp_path = str(reference_dir / "PregameSPPlus2025_1.csv")
    games = [("Kansas State", "Iowa State"), ("Alabama", "Georgia")]
    ndev = jax.device_count()
    kw = dict(sp_path=sp_path, n_pairs=64 * ndev, mode="analytic", seed=7)
    got = simulate_slate_summaries(games, shard=True, chunk_pairs=64, **kw)
    assert len(got) == 2 and (got.n_games == 128 * ndev).all()
    # deterministic: identical call -> identical rows
    again = simulate_slate_summaries(games, shard=True, chunk_pairs=64, **kw)
    for col in ("mean_a", "mean_b", "win_a", "win_b", "n_games"):
        assert (got[col] == again[col]).all(), col
    # distributional agreement with the single-device sweep
    want = simulate_slate_summaries(games, shard=False,
                                    chunk_pairs=64 * ndev, **kw)
    for i in range(2):
        assert abs(got.iloc[i].win_a - want.iloc[i].win_a) < 0.08, i
        assert abs(got.iloc[i].mean_total - want.iloc[i].mean_total) < 3.0, i
    # two different matchups actually ran under per-game fold_in roots
    assert got.iloc[0].win_a != got.iloc[1].win_a


def test_slate_layout_auto_by_mesh(reference_dir, monkeypatch):
    """layout='auto' picks the execution by mesh size with no user flag:
    game-sharded scan on a multi-device mesh (this suite's 8-device
    virtual mesh), per-matchup loop on one device — the single-chip
    record holder vs the multi-chip game-axis layout (VERDICT r3 #6)."""
    import fast_monte_carlo.api as api

    sp_path = str(reference_dir / "PregameSPPlus2025_1.csv")
    games = [("Kansas State", "Iowa State"), ("Alabama", "Georgia")]
    picked = []

    real_gs = api.SlateRunner.run_summaries
    real_loop = api.MatchupRunner.run_pairs_summary
    monkeypatch.setattr(
        api.SlateRunner, "run_summaries",
        lambda self, *a, **k: (picked.append("game_shard"),
                               real_gs(self, *a, **k))[1])
    monkeypatch.setattr(
        api.MatchupRunner, "run_pairs_summary",
        lambda self, *a, **k: (picked.append("loop"),
                               real_loop(self, *a, **k))[1])

    kw = dict(sp_path=sp_path, n_pairs=64, chunk_pairs=64, seed=1,
              table_quality="nano")
    df = api.simulate_slate_summaries(games, **kw)       # 8 devices
    assert picked == ["game_shard"]
    assert len(df) == 2 and (df.n_games == 128).all()

    picked.clear()
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    df1 = api.simulate_slate_summaries(games, **kw)      # "one device"
    assert picked and all(p == "loop" for p in picked)
    assert len(df1) == 2 and (df1.n_games == 128).all()

    # shard=True is an explicit trial-sharding choice: auto respects it
    picked.clear()
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 8)
    api.simulate_slate_summaries(games, shard=True, **kw)
    assert picked and all(p == "loop" for p in picked)
    # an explicit layout request overrides auto in the other direction
    picked.clear()
    api.simulate_slate_summaries(games, layout="game_shard", **kw)
    assert picked == ["game_shard"]
    with pytest.raises(ValueError, match="layout must be"):
        api.simulate_slate_summaries(games, layout="nope", **kw)
    # explicit game_shard REJECTS knobs it cannot honor instead of
    # silently dropping them (focus rosters don't fuse; scan is
    # table-mode only)
    with pytest.raises(ValueError, match="cannot honor focus_csv"):
        api.simulate_slate_summaries(games, layout="game_shard",
                                     focus_csv="roster.csv", **kw)
    with pytest.raises(ValueError, match="table-mode only"):
        api.simulate_slate_summaries(games, layout="game_shard",
                                     mode="analytic", **kw)
    with pytest.raises(ValueError, match="different layouts"):
        api.simulate_slate_summaries(games, layout="game_shard",
                                     shard=True, **kw)
    kw_coarse = {**kw, "table_quality": "coarse"}
    with pytest.raises(ValueError, match="supports table_quality"):
        api.simulate_slate_summaries(games, layout="game_shard",
                                     **kw_coarse)
    # auto with an unsupported quality keeps the loop (no silent
    # quantization-ladder change), even on the 8-device mesh
    picked.clear()
    api.simulate_slate_summaries(games, **kw_coarse)
    assert picked and all(p == "loop" for p in picked)
    # warm repeat reuses the memoized game-sharded runner (no rebuild)
    import fast_monte_carlo.api as api_mod
    n_memo = len(api_mod._GAME_SHARD_MEMO)
    picked.clear()
    api.simulate_slate_summaries(games, layout="game_shard", **kw)
    assert picked == ["game_shard"]
    assert len(api_mod._GAME_SHARD_MEMO) == n_memo


def test_slate_game_shard_build_failure_fallback(reference_dir, monkeypatch):
    """A SlateRunner build failure of ANY exception type falls back to the
    per-matchup loop under layout='auto', records the original reason, and
    an explicit layout='game_shard' re-request surfaces that reason
    (ADVICE r4: non-ValueError escapes; reason-less 'previously failed')."""
    import fast_monte_carlo.api as api

    sp_path = str(reference_dir / "PregameSPPlus2025_1.csv")
    games = [("Kansas State", "Iowa State"), ("Alabama", "Georgia")]
    # 'turbo' keeps the memo/failure key distinct from the other tests'
    # 'nano' runners built in this process
    kw = dict(sp_path=sp_path, n_pairs=8, chunk_pairs=8, seed=1,
              table_quality="turbo")
    calls = []

    def boom(self, *a, **k):
        calls.append(1)
        raise TypeError("synthetic build failure")

    monkeypatch.setattr(api.SlateRunner, "__init__", boom)
    df = api.simulate_slate_summaries(games, **kw)   # auto on 8 devices
    assert len(df) == 2 and calls
    with pytest.raises(ValueError, match="synthetic build failure"):
        api.simulate_slate_summaries(games, layout="game_shard", **kw)
    assert len(api._GAME_SHARD_FAILED) <= api._GAME_SHARD_FAILED_MAX
