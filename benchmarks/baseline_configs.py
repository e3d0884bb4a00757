"""BASELINE.json configs #3/#4/#5 at spec scale, on the real device.

#3  weekly slate: ~60 matchups x 100k trials each.  One compiled program
    REUSED across matchups (identical table shapes; pack/tables are jit
    arguments) — on one chip of the earlier hardware this beat the
    ('game','trial') single-launch layout, whose shared 60-game nano table
    (983k rows) sat past a gather row-count cliff.  The game-axis layout
    remains the multi-device scale-out path (games x trials mesh).
#4  edge scan at 1M trials/game over the full slate: 10 chunks per
    matchup, per-chunk margin/total histograms reduced on device, edge
    table from the final histograms (edge_finder.py:283-336 math).
#5  season-style calibration sweep from the same 1M-trial accumulation:
    win-prob / ATS distribution per matchup (adjacent-SP+-rank 2025
    pairings; the snapshot has no schedule file).

Usage: python benchmarks/baseline_configs.py [n_matchups] [out_md]
Env: B3_PAIRS (default 50_000), B4_PAIRS (50_000), B4_CHUNKS (10)
"""
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax

from fast_monte_carlo.utils.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import jax.numpy as jnp
import numpy as np
import pandas as pd

from fast_monte_carlo.api import MatchupRunner
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.edge import ev_per_100_at_minus110, prob_to_american
from fast_monte_carlo.models.heads import load_heads

N_MATCHUPS = int(sys.argv[1]) if len(sys.argv) > 1 else 60
# default to a scratch name: BASELINE_RUNS.md is the curated longitudinal
# record (hand-edited narrative per round) — a default run must not
# clobber it (it did once in round 4; restored from git)
OUT_MD = sys.argv[2] if len(sys.argv) > 2 else "benchmarks/BASELINE_RUNS_latest.md"
MARGIN_OFF, NBINS = 100, 200   # margin support [-100, 100)
TOTAL_BINS = 160
B3_PAIRS = int(os.environ.get("B3_PAIRS", 50_000))
B4_PAIRS = int(os.environ.get("B4_PAIRS", 50_000))
B4_CHUNKS = int(os.environ.get("B4_CHUNKS", 10))
# rbg + score-only is the default (chosen on the earlier chip; not yet
# re-measured on the GPU).  B_RNG=threefry switches the generator;
# B_STATS=1 re-enables box-score accrual.
RNG_IMPL = os.environ.get("B_RNG", "rbg")
STATS = os.environ.get("B_STATS") == "1"

import dataclasses

cfg = SimConfig()
if RNG_IMPL != "threefry":
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                 rng_impl=RNG_IMPL))
sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
ranked = sp.sort_values("RATING", ascending=False)["team"].tolist()
games = [(ranked[i], ranked[i + 1]) for i in range(0, 2 * N_MATCHUPS, 2)]
heads = load_heads("/root/reference")
ms = [(build_team_context_from_sp_flex(a, 2025, 1, sp),
       build_team_context_from_sp_flex(b, 2025, 1, sp)) for a, b in games]

# ---- config #3: slate, cold + warm build, 100k trials/game ----------------
results = {}
cache = Path(".table_cache")
cold_note = "cold (no table cache)" if not any(
    cache.glob("tables_*.pkl")) else "warm-ish (cache present)"
t0 = time.perf_counter()
runners = [MatchupRunner(a, b, heads, cfg, mode="table", table_quality="nano")
           for a, b in ms]
build_s = time.perf_counter() - t0
print(f"[#3] table build for {len(games)} matchups: {build_s:.0f}s "
      f"({cold_note})", flush=True)
t0 = time.perf_counter()
_ = MatchupRunner(*ms[0], heads, cfg, mode="table", table_quality="nano")
build_warm_s = (time.perf_counter() - t0) * len(games)
print(f"[#3] warm rebuild (disk cache): {build_warm_s:.0f}s "
      f"projected for the slate", flush=True)

# compile once (shapes shared across matchups), then the timed slate.
# Config #3's product is per-matchup summaries: each launch's scores are
# reduced to ScoreMoments on device (frees the score buffer, keeps the
# dispatch pipeline full), with the tiny
# per-matchup transfers after timing (the last matchup's transfer gates
# the whole in-order device queue).
from fast_monte_carlo.parallel.aggregate import score_moments, summary_from_moments

moments_jit = jax.jit(score_moments)
out = runners[0].run_pairs(B3_PAIRS, seed=0, collect_players=False,
                           collect_stats=STATS)
_ = np.asarray(moments_jit(out.score).n)
t0 = time.perf_counter()
moms3 = []
for gi, r in enumerate(runners):
    o = r.run_pairs(B3_PAIRS, seed=1 + gi, collect_players=False,
                    collect_stats=STATS, block=False)
    moms3.append(moments_jit(o.score))
_ = np.asarray(moms3[-1].n)   # forced transfer: in-order queue => all done
run3_s = time.perf_counter() - t0
summaries3 = [summary_from_moments(m) for m in moms3]
_ = [np.asarray(s.win_rate) for s in summaries3]
n3 = len(games) * 2 * B3_PAIRS
print(f"[#3] {len(games)} matchups x {2*B3_PAIRS:,} games = {n3:,} games "
      f"in {run3_s:.2f}s -> {n3/run3_s:,.0f} games/s", flush=True)
results["config3"] = {
    "matchups": len(games), "games_per_matchup": 2 * B3_PAIRS,
    "build_s": round(build_s, 1), "build_note": cold_note,
    "build_warm_s": round(build_warm_s, 1),
    "sim_s": round(run3_s, 2), "games_per_s": round(n3 / run3_s),
}

# ---- configs #4/#5: 1M trials/game, device-accumulated histograms ---------
@jax.jit
def hists(score):
    margin = jnp.clip(score[:, 0] - score[:, 1] + MARGIN_OFF, 0, NBINS - 1)
    total = jnp.clip(score[:, 0] + score[:, 1], 0, TOTAL_BINS - 1)
    s = score.astype(jnp.float32)
    return (jnp.bincount(margin, length=NBINS),
            jnp.bincount(total, length=TOTAL_BINS),
            s.sum(axis=0), (s * s).sum(axis=0))


G = len(games)
mh = np.zeros((G, NBINS), np.int64)
th = np.zeros((G, TOTAL_BINS), np.int64)
sums = np.zeros((G, 2)); sqs = np.zeros((G, 2))
t0 = time.perf_counter()
per_game_accs = []
for gi, r in enumerate(runners):
    # accumulate ON DEVICE across the 10 chunks; hold each matchup's
    # accumulated moments on device and transfer them ALL after the loop —
    # a per-matchup np.asarray gates the in-order queue every 10 launches
    # (pipeline drain)
    accs = None
    for ci in range(B4_CHUNKS):
        o = r.run_pairs(B4_PAIRS, seed=1000 + gi * B4_CHUNKS + ci,
                        collect_players=False, collect_stats=STATS,
                        block=False)
        h = hists(o.score)
        accs = h if accs is None else tuple(a + b for a, b in zip(accs, h))
    per_game_accs.append(accs)
    if (gi + 1) % 10 == 0:
        print(f"[#4] matchup {gi+1}/{G} dispatched @ "
              f"{time.perf_counter()-t0:.1f}s", flush=True)
# stack per-matchup accumulators on device, read back as FOUR arrays —
# per-matchup np.asarray readbacks would each synchronize with the device
stacked = tuple(jnp.stack([a[i] for a in per_game_accs]) for i in range(4))
mh += np.asarray(stacked[0]); th += np.asarray(stacked[1])
sums += np.asarray(stacked[2]); sqs += np.asarray(stacked[3])
run4_s = time.perf_counter() - t0
n4 = G * B4_CHUNKS * 2 * B4_PAIRS
print(f"[#4] {n4:,} games in {run4_s:.1f}s -> {n4/run4_s:,.0f} games/s",
      flush=True)
results["config4_5"] = {
    "matchups": G, "trials_per_matchup": B4_CHUNKS * 2 * B4_PAIRS,
    "sim_s": round(run4_s, 1), "games_per_s": round(n4 / run4_s),
}

# edge + calibration tables from the accumulated histograms
n_per = B4_CHUNKS * 2 * B4_PAIRS
margin_vals = np.arange(NBINS) - MARGIN_OFF
total_vals = np.arange(TOTAL_BINS)
rows = []
for gi, (ta, tb) in enumerate(games):
    m, t = mh[gi], th[gi]
    mean = sums[gi] / n_per
    sd = np.sqrt(np.maximum(0.0, sqs[gi] / n_per - mean ** 2))
    win_a = float(m[margin_vals > 0].sum()) / n_per
    tie = float(m[margin_vals == 0].sum()) / n_per
    mean_margin = float((m * margin_vals).sum()) / n_per
    mean_total = float((t * total_vals).sum()) / n_per
    spread = -round(mean_margin * 2) / 2
    line_t = round(mean_total * 2) / 2
    p_cover = float(m[margin_vals > -spread].sum()) / n_per
    p_push = float(m[margin_vals == -spread].sum()) / n_per if \
        float(spread).is_integer() else 0.0
    p_over = float(t[total_vals > line_t].sum()) / n_per
    rows.append({
        "team_a": ta, "team_b": tb, "n": n_per,
        "win_a": round(win_a, 4), "tie": round(tie, 4),
        "ml_a": prob_to_american(win_a / max(1e-9, 1 - tie)),
        "mean_a": round(float(mean[0]), 2), "mean_b": round(float(mean[1]), 2),
        "sd_a": round(float(sd[0]), 2), "sd_b": round(float(sd[1]), 2),
        "spread_a": spread, "p_cover": round(p_cover, 4),
        "p_push": round(p_push, 4),
        "ats_edge_pct": round((p_cover / max(1e-9, 1 - p_push) - 11 / 21) * 100, 2),
        "ev_cover_$100": round(ev_per_100_at_minus110(p_cover, p_push), 2),
        "total_line": line_t, "p_over": round(p_over, 4),
        "mean_total": round(mean_total, 2),
        "sd_margin": round(float(np.sqrt(max(0.0,
            (m * margin_vals ** 2).sum() / n_per - mean_margin ** 2))), 2),
    })
df = pd.DataFrame(rows)
df.to_csv("benchmarks/season_sweep_1M.csv", index=False)
print(df.head(10).to_string(index=False), flush=True)

md = [
    "# BASELINE configs #3-#5 at spec (one device, nano tables)",
    "",
    f"- device: {jax.devices()[0].device_kind}; per-matchup launches, one "
    "shared compile",
    f"- config #3: {results['config3']['matchups']} matchups x "
    f"{results['config3']['games_per_matchup']:,} games = "
    f"{results['config3']['matchups']*results['config3']['games_per_matchup']:,} "
    f"games in {results['config3']['sim_s']}s -> "
    f"**{results['config3']['games_per_s']:,} games/s** "
    f"(table build {results['config3']['build_s']}s "
    f"{results['config3']['build_note']}; warm rebuild "
    f"~{results['config3']['build_warm_s']}s for the whole slate)",
    f"- configs #4+#5: {results['config4_5']['matchups']} matchups x "
    f"{results['config4_5']['trials_per_matchup']:,} trials = {n4:,} games "
    f"in {results['config4_5']['sim_s']}s -> "
    f"**{results['config4_5']['games_per_s']:,} games/s**, margin/total "
    "histograms accumulated on device; edge + calibration table: "
    "benchmarks/season_sweep_1M.csv",
    "- layout note: the ('game','trial') single-launch SlateRunner shares "
    "one 60-game table (983k rows); per-matchup 16k-row tables keep each "
    "gather small.  The game axis remains the multi-device sharding "
    "dimension.",
    "",
    "Top 10 matchups (1M trials each):",
    "",
    "```",
    df.head(10).to_string(index=False),
    "```",
    "",
    "JSON: " + json.dumps(results),
]
Path(OUT_MD).write_text("\n".join(md))
print(f"wrote {OUT_MD}", flush=True)
