"""Typed simulation configuration: the single source of truth for every constant.

The reference (`fast_monte_carlo_cfb.py`) scatters its tuning constants across
module globals and inline literals; this module collects all of them in one
frozen dataclass so that calibration deltas (e.g. the fast-variant vs the
original `monte_carlo_cfb.py` drift, reference SURVEY §2.3) are explicit and
versioned.

Canonical values follow the *fast* variant (`fast_monte_carlo_cfb.py`), which
supersedes `monte_carlo_cfb.py`.  The alternate ("classic") values from the
original are available via :func:`classic_config`.

Reference provenance (file:line in the reference repository):
  - clock charges            fast_monte_carlo_cfb.py:34-39, 1132, 1198, 1404, 1418
  - stage-2 nudge            fast_monte_carlo_cfb.py:767-768
  - sigma floors / clips     fast_monte_carlo_cfb.py:826-852
  - FG curve & distances     fast_monte_carlo_cfb.py:858-874, 1401
  - punt model               fast_monte_carlo_cfb.py:876-896
  - go-for-it table          fast_monte_carlo_cfb.py:1336-1378, 1394
  - SP+ matchup adjustments  fast_monte_carlo_cfb.py:431-484
  - heuristic play call      fast_monte_carlo_cfb.py:719-735
  - RZ finish gates          fast_monte_carlo_cfb.py:1102, 1226
  - explosive-play gates     fast_monte_carlo_cfb.py:1096-1099, 1222-1224
  - INT return               fast_monte_carlo_cfb.py:1194-1195
  - speed knobs              fast_monte_carlo_cfb.py:27-28
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ClockConfig:
    """Seconds charged per play outcome (fast_monte_carlo_cfb.py:34-39)."""

    pass_complete: int = 26   # T_PASS_C
    pass_incomplete: int = 10  # T_PASS_INC
    sack: int = 24            # T_SACK
    run: int = 28             # T_RUN
    field_goal: int = 12      # T_FG (handle_fourth ticks this, :1404)
    punt: int = 16            # T_PUNT (:1418)
    td_pass: int = 20         # TD pass ticks 20 (:1132)
    interception: int = 12    # INT ticks 12 (:1198)
    game_seconds: int = 3600
    half_seconds: int = 1800
    quarter_seconds: int = 900


@dataclass(frozen=True)
class SpecialTeamsConfig:
    """FG make curve, FG gate, and punt model (fast_monte_carlo_cfb.py:858-896)."""

    fg_snap_plus_endzone: float = 17.0   # attempt distance = ytg + 17 (:869)
    # piecewise make-probability curve keyed on attempt distance (:858-865)
    fg_curve: Tuple[Tuple[float, float], ...] = (
        (30.0, 0.96),
        (40.0, 0.92),
        (50.0, 0.78),
        (55.001, 0.50),  # "<= 55" in the reference; use half-open bins
    )
    fg_long_prob: float = 0.25
    fg_attempt_max_ytg: float = 38.0     # FG considered iff ytg <= 38 (:1401)

    punt_gross_mean: float = 43.0        # gross ~ N(43, 6), floored (:881)
    punt_gross_sd: float = 6.0
    punt_gross_min: float = 30.0
    punt_return_mean: float = 6.0        # return ~ N(6, 3), floored (:882)
    punt_return_sd: float = 3.0
    punt_touchback_gate_ytg: float = 60.0  # TB possible iff ytg <= 60 (:887)
    punt_tb_lo: float = 0.10             # tb prob = clip((60-ytg)/60, .10, .55) (:888)
    punt_tb_hi: float = 0.55
    punt_tb_own_spot: float = 25.0       # TB: new offense at own 25 (:891)
    punt_net_min: float = 15.0           # net clip [15, ytg-1] (:894)


@dataclass(frozen=True)
class FourthDownConfig:
    """Go-for-it policy table (fast_monte_carlo_cfb.py:1336-1378, 1394)."""

    go_multiplier: float = 1.15          # p_go = min(1, table * 1.15) (:1394)
    # Decision override for EVERY 4th down in the program: None (policy,
    # the default — the compiled program is textually identical to the
    # pre-knob engine), 'go', 'fg', or 'punt'.  Exists for the 4th-down
    # decision evaluator (api.evaluate_fourth_down), which applies a
    # forced-cfg play_step to ONLY the first play of a resumed situation
    # and continues under the normal cfg — never set this on a full-game
    # config unless you mean every 4th down.  No reference counterpart
    # (handle_fourth always samples its policy, fast_monte_carlo_cfb.py
    # :1394-1421).
    force: Optional[str] = None
    late_seconds: int = 300
    late_trailing_long_fg_ytg: float = 38.0
    late_trailing_go_long: float = 0.90  # trailing, <5min, ytg > 38 (:1344)
    late_trailing_go_short: float = 0.75
    late_leading_scale: float = 0.85     # leading late: p *= 0.85 (:1375-1376)
    # (ytg_lower_bound_exclusive, [(dist_max, p), ...]) buckets (:1347-1372)
    table: Tuple[Tuple[float, Tuple[Tuple[float, float], ...]], ...] = (
        (80.0, ((1.0, 0.15), (2.0, 0.05))),
        (65.0, ((1.0, 0.30), (2.0, 0.15))),
        (50.0, ((1.0, 0.60), (2.0, 0.40), (3.0, 0.20))),
        (35.0, ((1.0, 0.85), (2.0, 0.65), (3.0, 0.40), (4.0, 0.25))),
        (20.0, ((1.0, 0.75), (2.0, 0.50), (3.0, 0.30))),
        (10.0, ((1.0, 0.70), (2.0, 0.45))),
        (-1.0, ((2.0, 0.85), (4.0, 0.40))),
    )


@dataclass(frozen=True)
class MatchupConfig:
    """SP+-derived analytic tilts (fast_monte_carlo_cfb.py:431-484)."""

    bias_k: float = 0.12            # completion bias = k*(offO-defD)/40 (:431-433)
    bias_denom: float = 40.0
    ymult_k: float = 0.10           # yardage mult = 1 + k*tanh(gap/30) (:435-437)
    ymult_denom: float = 30.0
    mismatch_denom: float = 40.0    # z = gap/40 (:440-442)

    rz_pass_base: float = 0.32      # (:444-449)
    rz_pass_slope: float = 0.30
    rz_pass_down_bonus: float = 0.03
    rz_pass_tilt: float = 0.08
    rz_pass_tilt_denom: float = 35.0
    rz_pass_lo: float = 0.22
    rz_pass_hi: float = 0.68
    rz_pass_gate_ytg: float = 12.0  # gate: ytg<=12 and down<=3 (:1102)

    rz_run_base: float = 0.30       # (:452-457)
    rz_run_slope: float = 0.30
    rz_run_down_bonus: float = 0.04
    rz_run_tilt: float = 0.07
    rz_run_tilt_denom: float = 35.0
    rz_run_lo: float = 0.20
    rz_run_hi: float = 0.62
    rz_run_gate_ytg: float = 9.0    # gate: ytg<=9 and down<=3 (:1226)

    explosive_base: float = 0.03    # (:467-472)
    explosive_z_k: float = 0.05
    explosive_bonus_60: float = 0.02
    explosive_bonus_40: float = 0.01
    explosive_lo: float = 0.01
    explosive_hi: float = 0.12
    explosive_gate_ytg: float = 25.0   # both pass & run explosive gates (:1096, 1222)
    explosive_pass_scale: float = 0.60  # P = 0.60 * explosive_prob (:1096)
    explosive_pass_boost_lo: float = 0.35  # boost ~ U(.35,.95)*(1+.7z) (:1098)
    explosive_pass_boost_hi: float = 0.95
    explosive_pass_z_k: float = 0.7
    explosive_run_scale: float = 0.5    # P = 0.5 * explosive_prob (:1222)
    explosive_run_boost_lo: float = 0.2  # boost ~ U(.2,.5)*(1+.6z) (:1223)
    explosive_run_boost_hi: float = 0.5
    explosive_run_z_k: float = 0.6


@dataclass(frozen=True)
class ModelConfig:
    """Model-wrapping constants (clips, nudges, sigma floors)."""

    stage1_clip_lo: float = 0.02    # p_complete clip after bias (:1087)
    stage1_clip_hi: float = 0.98
    stage2_sack_scale: float = 0.65   # (:767)
    stage2_int_scale: float = 1.20    # (:768)
    stage2_int_add: float = 0.004

    sigma_denom: float = 2.56       # sigma = (q90-q10)/2.56 (:826, 838, 850)
    pass_sigma_floor: float = 0.40
    rush_sigma_floor: float = 0.35
    sack_sigma_floor: float = 0.25
    pass_clip_lo: float = 0.0       # pass yards clip [0, ytg] (:831)
    rush_clip_lo: float = -4.0      # rush yards clip [-4, ytg] (:843)
    sack_clip_lo: float = -20.0     # sack yards clip [-20, 0] (:852)
    sack_clip_hi: float = 0.0

    int_return_mean: float = 6.0    # INT return ~ N(6,5) clip [0, ytg] (:1194)
    int_return_sd: float = 5.0

    play_clip_lo: float = 0.02      # ML play-call clip (:425)
    play_clip_hi: float = 0.98
    heuristic_clip_lo: float = 0.10  # pass_prob_v1 clip (:735)
    heuristic_clip_hi: float = 0.95

    use_play_model: bool = False    # play_model.json absent in snapshot => heuristic
    enable_fumbles: bool = False    # fumble head is trained-but-unwired in the
                                    # reference (SURVEY §0.1); opt-in extension
    count_sack_as_att: bool = False  # kept for parity: defined-unused in the
                                     # reference too (:148), like sack_scale
    td_points: int = 7
    fg_points: int = 3

    # mc-variant alternates (monte_carlo_cfb.py): piecewise-linear long-gain
    # taper on sampled yards (mc:470,482; defined-but-disabled in fast,
    # fast:133-145,830,842) and pass-quantile damping near the goal line
    # (mc:462-464).  Off in the fast-variant defaults; classic_config()
    # enables both.
    taper_enabled: bool = False
    pass_taper: tuple = (22.0, 42.0, 0.60, 0.40)   # (t1, t2, r1, r2)
    rush_taper: tuple = (15.0, 30.0, 0.60, 0.35)
    rz_pass_damping: bool = False   # q *= 0.8 + 0.2*ytg/15 for ytg < 15


RNG_IMPLS = ("threefry", "rbg")


@dataclass(frozen=True)
class EngineConfig:
    """Engine shape/limits (new; no reference equivalent)."""

    max_plays: int = 360          # hard bound: min charge is 10s over 3600s
    # early exit: run the scan in chunks inside a while_loop that stops once
    # every game in the batch is finished (typical games end at ~140-180
    # plays; the 360 bound is a worst-case guarantee)
    early_exit: bool = True
    play_chunk: int = 24
    # descending tail schedule (round-3 lever b, ops/game.py): after
    # `tail_after` plays switch the early-exit loop to `play_chunk_tail`-
    # step chunks, so the stop point quantizes nearer the batch's max step
    # count (~183) instead of the next multiple of 24 (192).  0 = off.
    # Draw streams key on absolute step index -> bitwise-identical
    # trajectories under any schedule.
    play_chunk_tail: int = 0
    tail_after: int = 144
    # nano-table channel select: 'auto' (default), 'chain' (masked
    # slice+add passes), or 'dot' (one-hot einsum at HIGHEST precision — a
    # single reduce XLA cannot fission; bitwise-equal to 'chain').  'auto'
    # resolves per workload via resolve_nano_select: rbg + score-only
    # configs get 'dot', everything else keeps 'chain'.  That split was
    # chosen on the earlier chip and is not yet measured on the GPU.
    # Unresolved 'auto' behaves as 'chain'.
    nano_select: str = "auto"
    # lax.scan unroll factor for the play loop: >1 emits k step bodies per
    # loop iteration, amortizing XLA's per-iteration loop overhead.
    # Should divide play_chunk.  4 was chosen on the earlier chip and is
    # not yet measured on the GPU.
    scan_unroll: int = 4
    # two-phase tail compaction (ops/game.py simulate_games): fixed scan to
    # compact_after plays, gather still-active games into an
    # n/compact_cap_frac sub-batch, finish those, scatter back; a guarded
    # full-batch loop covers sub-batch overflow.  Off below
    # compact_min_batch (compaction overhead beats the win at small n).
    # Tail compaction: OFF by default — it measured negative on the
    # earlier chip.  The step-count distribution is tight (median 164,
    # P(>170)=6.3%, max 183 at 8k games), so the chunked early-exit loop
    # already stops near ~192 and compaction's ~24-step saving lost to its
    # own gather/scatter overhead.  The machinery stays (tested incl.
    # overflow) for workloads with heavier tails, e.g. overtime rules or
    # low-scoring configs.  Not yet measured on the GPU.
    compact_tail: bool = False
    compact_after: int = 168
    compact_cap_frac: int = 4
    compact_min_batch: int = 32768
    player_slots: int = 8         # padded per-role player slots (top-5 + Other + pad)
    ytg_max: float = 120.0        # sack push-back can exceed 100 (see engine notes)
    dist_max: float = 64.0
    # table-mode bin granularity == the reference memo-cache key bins (:68-88)
    dist_bin: float = 0.5
    sec_bin: int = 30
    table_dtype: str = "float32"
    # score_diff handling for the pass/yardage table heads (the reference's
    # memo caches key WITHOUT score_diff, freezing each state bin at its
    # first-seen sd, fast_monte_carlo_cfb.py:68-88):
    #   'axis'     live score_diff lookup (default): what the models compute
    #              when called fresh each play — i.e. the reference WITHOUT
    #              its cache speed-hack; margin sd ~20.1
    #   'frozen'   per-cell sampled sd draw, approximating first-write-wins;
    #              per-cell noise averages out over a game (margin sd ~17.3)
    #   'marginal' weighted mean over sd (margin sd ~17.2)
    #   'cachewarm' trajectory-coherent freeze: run cachewarm_games oracle
    #              warm-up games recording each memo-cell's FIRST-visit sd,
    #              collapse the table at those sds (earliest visit wins,
    #              'frozen' fallback for unvisited cells) — the faithful
    #              infinite-run limit of the reference's first-write-wins
    #              caches (models/tables.py cachewarm_collapse).  MEASURED:
    #              sd 17.25 ~= iid 'frozen' 17.1 — freeze coherence does
    #              NOT widen dispersion.
    # The as-executed reference is NON-STATIONARY in trial index: its cache
    # keeps filling, and a play whose bin is a first visit is computed LIVE
    # at that game's sd.  Measured on the n=8000 referee run (VALIDATION.md
    # "run-length-dependent"): margin sd 19.4 in early 1000-game blocks
    # (cold cache ~ 'axis') decaying to ~18.3 late (overall "18.8" is the
    # transient average; variance arithmetic puts it at ~55% live even
    # after 8000 games).  'axis' is therefore the principled default — the
    # fresh-model / cold-cache limit the reference itself starts in; the
    # collapsed modes are its infinite-run limit.
    sd_mode: str = "axis"
    # 'cachewarm' knobs: warm-up game count (host-side oracle, disk-cached
    # with the tables) and the warm-up RNG seed.  Seed 123
    # matches the validation referee's stream (benchmarks/deep_validation);
    # the reference's own distribution depends on the equally arbitrary
    # first games each worker process happened to run.
    cachewarm_games: int = 64
    cachewarm_seed: int = 123
    # antithetic variates (no reference equivalent): games 4k+2, 4k+3
    # reuse games 4k, 4k+1's draws mirrored (u -> 1-u, n -> -n); partner
    # offset 2 keeps pairs on the same matchup AND direction under the
    # standard layouts (fo = arange % 2, per-game gid blocks); needs
    # B % 4 == 0 (off otherwise).  Unbiased regardless of layout (mirrored
    # draws keep their marginals).  MEASURED RESULT
    # (benchmarks/antithetic_check.py, 100x4096 games): within-pair margin
    # rho = -0.004 — the ~160-play threshold cascade decorrelates mirrored
    # streams, so there is NO variance reduction (ESS 0.97-1.26x, noise)
    # and equally no penalty; pairs behave as independent games.  The
    # flag's only value is halving per-step RNG generation.  OFF by
    # default.
    antithetic: bool = False
    # exact mode: walk all heads' trees as ONE merged (B, T_total) front
    # instead of 15 per-forest walks.  Total gathered rows are identical
    # either way (B x sum T_h x depth_h x 3 ops); merging moves every row
    # onto one 75k-row node table.  It measured negative on the earlier
    # chip, whose gathers slowed past a row-count cliff; not yet measured
    # on the GPU.  Golden-tested, bitwise-equal outputs.
    exact_merged: bool = False
    # 'threefry' (jax default, strongest guarantees) or 'rbg' (XLA
    # RngBitGenerator: counter-based and fine for Monte-Carlo; streams
    # differ from threefry).  Anything else raises.
    rng_impl: str = "threefry"

    def __post_init__(self):
        if self.rng_impl not in RNG_IMPLS:
            raise ValueError(f"rng_impl must be one of {RNG_IMPLS}, "
                             f"got {self.rng_impl!r}")


@dataclass(frozen=True)
class SimConfig:
    clock: ClockConfig = field(default_factory=ClockConfig)
    st: SpecialTeamsConfig = field(default_factory=SpecialTeamsConfig)
    fourth: FourthDownConfig = field(default_factory=FourthDownConfig)
    matchup: MatchupConfig = field(default_factory=MatchupConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)

    track_players_per_team: Optional[int] = 5   # (:27)
    aggregate_others: bool = True               # (:28)
    kickoff_spot: float = 75.0                  # own 25 (:1445, 968, 1133)
    opening_distance: float = 10.0
    timeouts: int = 3

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SimConfig()


def reconstructed_config() -> SimConfig:
    """Full-fidelity RECONSTRUCTED mode (round 5, VERDICT r4 #6): the
    reference as its artifacts were MEANT to run, rather than as the
    snapshot can run it — recovered 5-class ML play policy
    (`play_model.xgb`, use_play_model=True) + the repo-trained stage-2
    head + a non-unit softmax temperature, the last two loaded from the
    committed overlay via `models.heads.load_reconstructed_heads()`
    (which fills what the snapshot is missing:
    `fast_monte_carlo_cfb.py:326-341` calibration.json, `:642-655`
    pass_stage2_notcomplete.json — both absent, SURVEY §0.1).

    One flag turns it on end-to-end: pass this config + those heads to
    any runner/API call (`cli sim --reconstructed`).  Its own committed
    referee stream is `benchmarks/oracle_reconstructed_8000.npz`, bound
    by the default-on test in tests/test_reconstructed.py.
    """
    c = SimConfig()
    return c.replace(
        model=dataclasses.replace(c.model, use_play_model=True))


def classic_config() -> SimConfig:
    """Constants of the original serial variant (`monte_carlo_cfb.py`), for
    A/B calibration work.  Deltas per SURVEY §2.3 (mc file:line cited there).
    """
    c = SimConfig()
    return c.replace(
        clock=dataclasses.replace(
            c.clock, pass_complete=29, pass_incomplete=12, sack=28, field_goal=12
        ),
        matchup=dataclasses.replace(
            c.matchup,
            rz_pass_base=0.30, rz_pass_down_bonus=0.03, rz_pass_tilt=0.07,
            rz_run_base=0.28, rz_run_down_bonus=0.04, rz_run_tilt=0.06,
            rz_pass_gate_ytg=10.0, rz_run_gate_ytg=7.0,
        ),
        model=dataclasses.replace(
            c.model,
            # active in mc, disabled in fast (monte_carlo_cfb.py:462-482)
            taper_enabled=True, rz_pass_damping=True,
        ),
    )


def resolve_nano_select(cfg: SimConfig, collect_stats: bool) -> SimConfig:
    """Resolve EngineConfig.nano_select == 'auto' for one workload.

    On the earlier chip, rbg score-only programs hit an XLA fusion
    pathology in the nano chain select: the slice+add chain fissioned
    into fusions that each re-read the gathered row strided.  The one-pass
    einsum ('dot') is immune but cost more where the chain fused well, so
    'auto' picks per (rng_impl, collect_stats).  Not yet measured on the
    GPU.  Callers that know collect_stats (api.MatchupRunner/SlateRunner)
    resolve before building the jit."""
    if cfg.engine.nano_select != "auto":
        return cfg
    mode = ("dot" if (not collect_stats and cfg.engine.rng_impl != "threefry")
            else "chain")
    return cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                  nano_select=mode))
