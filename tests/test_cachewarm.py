"""'cachewarm' sd mode: trajectory-coherent first-visit freeze.

The reference's memo caches key without score_diff, so every state bin
freezes at the model output of its first visit (fast_monte_carlo_cfb.py:
68-94); first visits come from real trajectories, making the frozen sds
coherent across cells.  These tests pin the mechanism: recordings are
deterministic, the collapse picks real sd channels (first visit wins,
'frozen' fallback elsewhere), and the engine runs end to end in the mode.
"""
import dataclasses

import numpy as np
import pytest

from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.models.tables import (
    build_fused_table, cachewarm_collapse, fused_head_groups, nano_profile,
)
from fast_monte_carlo.matchup import build_direction
from fast_monte_carlo.oracle import OracleMatchup


@pytest.fixture(scope="module")
def setup(reference_dir):
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    a = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
    return a, b, load_heads(reference_dir)


def _warm(a, b, heads, cfg, n=8, seed=123):
    m = OracleMatchup(a, b, heads, cfg, record_first_sd=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        m.simulate_game(i % 2, rng)
    return m


def test_recording_is_deterministic_and_plausible(setup):
    a, b, heads = setup
    cfg = SimConfig()
    m1, m2 = _warm(a, b, heads, cfg), _warm(a, b, heads, cfg)
    assert m1.first_sd[0]["s1"] == m2.first_sd[0]["s1"]
    assert m1.first_sd[1]["pq"] == m2.first_sd[1]["pq"]
    ev = m1.first_sd[0]["s1"]
    assert len(ev) > 300                       # 8 games visit many bins
    orders = [o for o, _ in ev.values()]
    assert len(set(orders)) == len(orders)     # visit order is unique
    sds = np.asarray([sd for _, sd in ev.values()])
    assert abs(sds.mean()) < 6 and 5 < sds.std() < 25


def test_collapse_picks_real_channels_first_visit_wins(setup):
    a, b, heads = setup
    cfg = SimConfig()
    prof = nano_profile()
    d = build_direction(a, b, heads, cfg)
    fused = build_fused_table(d, heads, cfg, prof)
    assert fused is not None and fused.has_sd
    warm = _warm(a, b, heads, cfg).first_sd[0]
    out = cachewarm_collapse(fused, prof, warm, fused_head_groups(fused))
    assert not out.has_sd
    nsd = len(prof.sd)
    v3 = fused.values.reshape(-1, nsd, fused.channels)
    flat = out.values
    assert flat.shape[0] == v3.shape[0]
    # every collapsed cell equals ONE of its sd channels, per channel group
    ok = np.zeros(flat.shape, bool)
    for s in range(nsd):
        ok |= flat == v3[:, s, :]
    assert ok.all()
    # determinism
    out2 = cachewarm_collapse(fused, prof, warm, fused_head_groups(fused))
    np.testing.assert_array_equal(out.values, out2.values)
    # a different warm trajectory changes some picks
    warm7 = _warm(a, b, heads, cfg, seed=7).first_sd[0]
    out7 = cachewarm_collapse(fused, prof, warm7, fused_head_groups(fused))
    assert (out7.values != out.values).any()


def test_engine_runs_in_cachewarm_mode(setup):
    a, b, heads = setup
    from fast_monte_carlo.api import MatchupRunner
    e = dataclasses.replace(SimConfig().engine, sd_mode="cachewarm",
                            cachewarm_games=8)
    cfg = SimConfig().replace(engine=e)
    r = MatchupRunner(a, b, heads, cfg, mode="table", table_quality="nano")
    out = r.run_pairs(256, seed=5, collect_players=False, collect_stats=False)
    sc = np.asarray(out.score, float)
    assert sc.shape == (512, 2)
    w = float((sc[:, 0] > sc[:, 1]).mean())
    assert 0.4 < w < 0.8                       # sane for this matchup


def test_perhead_stage1_pq_collapse_slot_mapping():
    """The per-head cachewarm branch (_apply_sd_mode): stage1 events map
    slot -> dedup row via row_map, pq events decode the flattened K*K pair
    map; recorded cells pick the first-visit sd channel, others fall back
    to the iid-frozen pick."""
    from fast_monte_carlo.config import SimConfig
    from fast_monte_carlo.models.tables import HostTable, TableProfile, TableSet
    from fast_monte_carlo.ops.table_lookup import _apply_sd_mode

    prof = TableProfile(dist=np.asarray([1.0, 5.0]),
                        ytg=np.asarray([10.0, 50.0]),
                        sec=np.asarray([60.0, 1800.0]),
                        sd=np.asarray([-8.0, 0.0, 8.0]))
    S, nsd = 2, 3
    cells = S * 5 * 2 * 2 * 2

    def table(channels, row_map):
        # value encodes the sd index so the pick is directly readable
        v = np.tile(np.arange(nsd, dtype=np.float32)[None, :, None],
                    (cells, 1, channels))
        return HostTable(values=v.reshape(-1, channels),
                         shape=(S, 5, 2, 2, 2, nsd), row_map=row_map,
                         profile="fine", has_sd=True, channels=channels)

    # stage1: 3 slots dedupe to 2 rows (slot 2 -> row 0)
    s1_map = np.asarray([0, 1, 0])
    # pq: K=3 pair map, pair (2, 1) -> row 1
    pq_map = np.zeros(9, np.int64)
    pq_map[2 * 3 + 1] = 1
    ts = TableSet(stage1=table(1, s1_map), stage2=None, pq=table(2, pq_map),
                  rq=None, sq=None, fumble=None, play=None,
                  fine=prof, coarse=prof)
    warm = {
        # slot 2 -> row 0; down 1, dist 1.0, ytg 10, sec bucket 2 (=75s),
        # first-visit sd +9 -> rep index 2
        "s1": {(1, 1.0, 10, 2, 3, 3, 2, None): (0, 9.0)},
        # pair (2,1) -> row 1; sd -9 -> rep index 0
        "pq": {(1, 1.0, 10, 2, 3, 3, 2, 1): (1, -9.0)},
    }
    e = dataclasses.replace(SimConfig().engine, sd_mode="cachewarm")
    cfg = SimConfig().replace(engine=e)
    _apply_sd_mode(ts, cfg, None, warm)
    assert not ts.stage1.has_sd and not ts.pq.has_sd
    s1 = ts.stage1.values.reshape(S, 5, 2, 2, 2, 1)
    pq = ts.pq.values.reshape(S, 5, 2, 2, 2, 2)
    # recorded cells: (row, down-1, dist bin 0, ytg bin 0, sec bin 0)
    assert s1[0, 0, 0, 0, 0, 0] == 2.0
    assert pq[1, 0, 0, 0, 0, 0] == 0.0 and pq[1, 0, 0, 0, 0, 1] == 0.0
    # unrecorded cells still hold a valid sd pick
    assert set(np.unique(s1)) <= {0.0, 1.0, 2.0}
    assert set(np.unique(pq)) <= {0.0, 1.0, 2.0}


def test_slate_runner_cachewarm(setup, reference_dir):
    """The game-axis SlateRunner path collapses its fused tables with the
    same warm recordings (api.py sd_mode block)."""
    a, b, heads = setup
    sp = load_sp_flex(str(reference_dir / "PregameSPPlus2025_1.csv"))
    c = build_team_context_from_sp_flex("Texas Tech", 2025, 1, sp)
    from fast_monte_carlo.api import SlateRunner
    e = dataclasses.replace(SimConfig().engine, sd_mode="cachewarm",
                            cachewarm_games=8)
    cfg = SimConfig().replace(engine=e)
    r = SlateRunner([(a, b), (a, c)], heads, cfg, quality="nano")
    out = r.run(n_pairs_per_game=64, seed=2)
    sc = np.asarray(out.score, float)
    assert sc.shape[0] == 2 * 2 * 64 and np.isfinite(sc).all()
    assert (sc >= 0).all() and sc.max() < 150
