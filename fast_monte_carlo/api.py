"""End-to-end simulation API: the `simulate_upcoming_matchup` /
`simulate_matchup` surface of the reference (fast_monte_carlo_cfb.py:
1467-1521, 1661-1722), on the accelerator underneath.

A "pair" follows the reference convention: one game with team A receiving
the opening kickoff and one with team B (:1321-1323); `n` counts pairs, so
2n games run as a single batch with an alternating first_offense vector.

Compute modes:
  'table'    - table-compiled heads (fast path; default)
  'exact'    - per-play compiled-forest evaluation (golden semantics)
  'analytic' - artifact-free closed-form heads (smoke/testing)
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from functools import lru_cache

from . import edge
from .config import SimConfig
from .data import build_team_context_from_sp_flex, load_sp_flex, norm_team
from .data.context import TeamContext
from .models.heads import ModelHeads, load_heads
from .ops.game import (
    GameState, Situation, make_analytic_heads_eval, make_exact_heads_eval,
    simulate_games,
)
from .ops.pack import build_packs
from .ops.table_lookup import build_table_heads, make_table_heads_eval
from .parallel import simulate_games_sharded
from .utils.transfer import fetch_tree
from .stats import (
    PC_ATT, PC_COMP, PC_INT, PC_SACKS, PC_TD, PC_YDS, PLAYER_COLS, ROLE_LABEL,
    ROLE_PASS, ROLE_REC, ROLE_RUSH,
)


@dataclass
class MatchupRunner:
    """Reusable compiled simulator for one matchup (both orderings)."""

    team_a: TeamContext
    team_b: TeamContext
    heads: Optional[ModelHeads]
    cfg: SimConfig = field(default_factory=SimConfig)
    mode: str = "table"
    coach_map: Optional[Dict[str, str]] = None
    shard: bool = False
    # 'nano' (default): single-gather fast path, validated vs the oracle
    # (VALIDATION.md); falls back to per-head fine tables automatically for
    # focus rosters (player-dependent outputs can't fuse).  Other presets:
    # 'default' (per-head fine/coarse), 'coarse', 'slate', 'fused', 'turbo'.
    table_quality: str = "nano"

    def __post_init__(self):
        self.pack, hp = build_packs(
            self.team_a, self.team_b,
            self.heads if self.heads is not None else _empty_heads(),
            self.cfg, self.coach_map)
        if self.mode == "table":
            from .models.tables import (
                coarse_profile, nano_profile, slate_profile, turbo_profile,
            )
            profs = {}
            if self.table_quality == "coarse":
                profs = dict(fine=coarse_profile(), coarse=coarse_profile())
            elif self.table_quality == "slate":
                profs = dict(fine=slate_profile(), coarse=slate_profile(),
                             fused=slate_profile())
            elif self.table_quality == "turbo":
                # small fused table (turbo_profile; earlier-chip sizing)
                profs = dict(fused=turbo_profile())
            elif self.table_quality == "nano":
                # one gather from a small table; down/sd in channels
                profs = dict(nano=nano_profile())
            elif self.table_quality == "fused":
                # single-gather fast path on the coarse grid (falls back to
                # per-head tables automatically when a focus roster makes
                # model outputs player-dependent)
                profs = dict(fused=coarse_profile())
            self.heads_state = build_table_heads(
                self.team_a, self.team_b, self.heads, self.cfg, self.coach_map,
                **profs)
        elif self.mode == "exact":
            self.heads_state = hp
        elif self.mode == "analytic":
            self.heads_state = None
        else:
            raise ValueError(f"unknown mode {self.mode!r}")
        # cached per (mode, cfg) so the function identity — and therefore the
        # shared jit cache entry — is reused across matchups
        self.heads_fn = _heads_fn_cached(self.mode, self.cfg)

    def _resolved(self, collect_stats: bool):
        """(cfg, heads_fn) with nano_select='auto' resolved per workload
        (config.resolve_nano_select: cheap-RNG + score-only gets the
        fission-immune dot select; everything else keeps the chain)."""
        from .config import resolve_nano_select
        cfg = resolve_nano_select(self.cfg, collect_stats)
        return cfg, _heads_fn_cached(self.mode, cfg)

    def run_pairs(self, n_pairs: int, seed: int = 0,
                  collect_players: bool = True,
                  collect_stats: bool = True,
                  block: bool = True,
                  key: Optional[jnp.ndarray] = None) -> GameState:
        """2*n_pairs games; even trials have team A on offense first.
        collect_stats=False skips box-score accrual (score-only sweeps).
        block=False skips the device sync so back-to-back calls pipeline
        (launches overlap).
        `key` overrides the PRNGKey(seed) derivation — chunked drivers pass
        fold_in'd keys so adjacent seeds never share chunk streams."""
        n_games = 2 * n_pairs
        if self.shard and n_games % jax.device_count():
            # fail at the API surface, not deep inside shard_map after
            # the table builds; raw-output semantics forbid silent
            # round-up here (run_pairs_summary / the slate drivers round
            # up instead, where only reductions are returned)
            raise ValueError(
                f"shard=True needs 2*n_pairs divisible by the device "
                f"count ({jax.device_count()}); got n_pairs={n_pairs}")
        k = key if key is not None else jax.random.PRNGKey(seed)
        fo = _fo_alternating(n_games)
        cfg, heads_fn = self._resolved(collect_stats)
        if self.shard:
            def fn(pack, hs, kk, f):
                return simulate_games_sharded(
                    pack, cfg, heads_fn, hs, kk, n_games, f,
                    collect_players=collect_players,
                    collect_stats=collect_stats)
            out = fn(self.pack, self.heads_state, k, fo)
        else:
            fn = _shared_sim_jit(cfg, heads_fn)
            out = fn(self.pack, self.heads_state, k, fo,
                     n_games, collect_players, collect_stats)
        if block:
            jax.block_until_ready(out.score)
        return out

    def run_pairs_summary(self, n_pairs: int, seed: int = 0,
                          chunk_pairs: int = 32768,
                          collect_stats: bool = False,
                          key: Optional[jnp.ndarray] = None,
                          block: bool = True):
        """Market summary (ScoreSummary) for large n: pipelined score-only
        launches of `chunk_pairs` (default 32768 pairs = 65,536-game
        launches, chosen on the earlier chip and not yet re-tuned on the
        GPU), per-launch moments/histograms ACCUMULATED ON DEVICE and
        transferred once at the end — the BASELINE-config-#4 pattern
        (per-launch host transfers would serialize dispatch).  Exact: the
        accumulated summary equals summarize_scores over the concatenated
        batch (tested).

        `n_pairs` is rounded UP to a whole number of chunks so every
        launch shares ONE compiled shape (a ragged remainder would pay a
        second compile for a different batch size); the returned
        summary's `n` records the games actually simulated.

        Chunk keys are fold_in(PRNGKey(seed), chunk) off one root key, so
        different seeds produce fully independent streams (seed+ci offsets
        would make adjacent seeds share all-but-one chunk).  `key` replaces
        the root key (slate drivers pass per-game fold_in'd roots); with
        block=False the returned summary stays device-resident and no host
        transfer happens — callers driving many matchups force ONE transfer
        at the end so the in-order dispatch queue never drains
        (simulate_slate_summaries).

        With shard=True each chunk is a shard_map launch over the full
        device mesh: every device reduces its trial shard to ScoreMoments
        locally and one psum merges them (parallel.simulate_moments_sharded)
        — the production multi-chip path; scores never leave the devices."""
        if n_pairs <= 0:
            raise ValueError(f"n_pairs must be positive, got {n_pairs}")
        # module-cached jits: a fresh jax.jit wrapper per CALL would
        # re-trace every call — at one run_pairs_summary per matchup that
        # host cost would serialize the slate loop (the same bug class as
        # the eager shard_map)
        moments_jit = _score_moments_jit()
        chunk_pairs = min(chunk_pairs, n_pairs)
        if self.shard:
            # shard_map splits the 2*chunk_pairs games across the mesh;
            # round the chunk up to a device multiple so arbitrary -n
            # values don't crash simulate_moments_sharded's divisibility
            # check (n rounds up to whole launches anyway, documented).
            ndev = jax.device_count()
            chunk_pairs = -(-chunk_pairs // ndev) * ndev
        n_chunks = -(-n_pairs // chunk_pairs)
        root = key if key is not None else jax.random.PRNGKey(seed)
        acc = None
        cfg_r, heads_fn_r = self._resolved(collect_stats)
        for ci in range(n_chunks):
            ck = jax.random.fold_in(root, ci)
            if self.shard:
                from .parallel import simulate_moments_sharded
                m = simulate_moments_sharded(
                    self.pack, cfg_r, heads_fn_r, self.heads_state,
                    ck, 2 * chunk_pairs, _fo_alternating(2 * chunk_pairs),
                    collect_stats=collect_stats)
            else:
                out = self.run_pairs(chunk_pairs, key=ck,
                                     collect_players=False,
                                     collect_stats=collect_stats, block=False)
                m = moments_jit(out.score)
            acc = m if acc is None else acc + m
        summary = _summary_from_moments_jit()(acc)
        if block:
            jax.block_until_ready(summary)
        return summary

    def run_live(self, situation: Situation, n_games: int = 65536,
                 seed: int = 0, chunk_games: int = 65536,
                 block: bool = True,
                 key: Optional[jnp.ndarray] = None):
        """Live win probability: resume every trial from one mid-game
        `situation` (ops.game.Situation: offense/sec/down/dist/ytg/score)
        and return the ScoreSummary of the finished games — win rates,
        mean/sd points, and the margin/total histograms that
        edge.market_odds_from_summary prices live spread/total/moneyline
        markets from.  No reference counterpart (its simulate_game always
        starts at kickoff, fast_monte_carlo_cfb.py:1428); the oracle twin
        is OracleMatchup.simulate_game(start=situation).

        The situation ships as DEVICE scalars into one cached jit, so a
        resident server prices any live state without recompiling; games
        are score-only and chunked/accumulated on device exactly like
        run_pairs_summary (n_games rounds UP to whole chunks; summary.n
        records the true count).  Late-game states finish in a handful of
        plays and the early-exit chunk loop stops right after they do, so
        live queries are *cheaper* than full games.  With shard=True each
        chunk runs over the full trial mesh (the situation replicates;
        chunk size rounds up to a device multiple)."""
        if n_games <= 0:
            raise ValueError(f"n_games must be positive, got {n_games}")
        sit = _validated_situation(situation, self.cfg)
        dsit = _device_situation(sit)
        cfg_r, heads_fn_r = self._resolved(False)
        chunk = min(chunk_games, n_games)
        if self.shard:
            ndev = jax.device_count()
            chunk = -(-chunk // ndev) * ndev
        n_chunks = -(-n_games // chunk)
        root = key if key is not None else jax.random.PRNGKey(seed)
        acc = None
        for ci in range(n_chunks):
            ck = jax.random.fold_in(root, ci)
            if self.shard:
                from .parallel import simulate_moments_sharded
                m = simulate_moments_sharded(
                    self.pack, cfg_r, heads_fn_r, self.heads_state,
                    ck, chunk, 0, collect_stats=False, situation=dsit)
            else:
                m = _live_moments_jit(cfg_r, heads_fn_r)(
                    self.pack, self.heads_state, ck, dsit, chunk)
            acc = m if acc is None else acc + m
        summary = _summary_from_moments_jit()(acc)
        if block:
            jax.block_until_ready(summary)
        return summary

    def run_live_batch(self, situations, n_games_per: int = 8192,
                       seed: int = 0, block: bool = True,
                       key: Optional[jnp.ndarray] = None):
        """Price MANY mid-game situations in ONE launch (the win-probability
        curve): each of the S `situations` gets `n_games_per` resumed
        trials, packed as one S*n_games_per-trial batch whose per-trial
        Situation arrays select each trial's resume state — the batched
        replacement for S sequential run_live calls (one dispatch, one
        compiled program per (S, n_games_per) shape, one readback).
        Returns a ScoreSummary whose leaves carry a leading S axis in
        `situations` order.

        Use for WP charts (one situation per game event) and score ladders
        (one state priced across hypothetical scores).  Single-device by
        design: per-trial situation arrays don't ride the trial mesh here
        (shard each call with run_live instead if you need the mesh)."""
        if not situations:
            raise ValueError("run_live_batch needs at least one situation")
        if n_games_per <= 0:
            raise ValueError(
                f"n_games_per must be positive, got {n_games_per}")
        sits = [_validated_situation(s, self.cfg) for s in situations]
        dsit = _device_situation(Situation(
            *([getattr(s, f) for s in sits] for f in Situation._fields)))
        cfg_r, heads_fn_r = self._resolved(False)
        root = key if key is not None else jax.random.PRNGKey(seed)
        m = _live_batch_moments_jit(cfg_r, heads_fn_r)(
            self.pack, self.heads_state, root, dsit, len(sits), n_games_per)
        summary = _summary_from_batch_moments_jit()(m)
        if block:
            jax.block_until_ready(summary)
        return summary

    def run_fourth_decision(self, situation: Situation,
                            n_games: int = 65536, seed: int = 0,
                            chunk_games: int = 65536,
                            choices=("policy", "go", "fg", "punt"),
                            key: Optional[jnp.ndarray] = None) -> dict:
        """Win probability of each 4th-down choice from one situation.

        For every choice the FIRST play is forced ('go' = snap for it,
        'fg' = kick regardless of range, 'punt') by running one play_step
        under a fourth.force cfg variant, after which the game continues
        under the runner's normal config; 'policy' is the unforced live
        run.  All choices share the same continuation draw streams (common
        random numbers), so their win-prob DIFFERENCES have far less MC
        noise than independent runs.  Returns {choice: ScoreSummary}
        (device-resident; fetch together in one transfer).  The reference
        cannot ask this question at all — handle_fourth always samples its
        policy (fast_monte_carlo_cfb.py:1394-1421).  Single-device (the
        evaluator is a ~handful of launches, not a sweep)."""
        import dataclasses as _dc

        if n_games <= 0:
            raise ValueError(f"n_games must be positive, got {n_games}")
        if not choices:
            raise ValueError(
                "choices must name at least one of policy | go | fg | punt")
        sit = _validated_situation(situation, self.cfg)
        if not isinstance(sit.down, (int, np.integer)) or int(sit.down) != 4:
            raise ValueError(
                "run_fourth_decision needs a concrete down=4 situation "
                f"(got down={sit.down!r})")
        dsit = _device_situation(sit)
        cfg_r, heads_fn_r = self._resolved(False)
        chunk = min(chunk_games, n_games)
        n_chunks = -(-n_games // chunk)
        root = key if key is not None else jax.random.PRNGKey(seed)
        res = {}
        for choice in choices:
            if choice == "policy":
                fn = _live_moments_jit(cfg_r, heads_fn_r)
            elif choice in ("go", "fg", "punt"):
                cfg_f = _dc.replace(
                    cfg_r, fourth=_dc.replace(cfg_r.fourth, force=choice))
                fn = _forced_live_moments_jit(cfg_r, cfg_f, heads_fn_r)
            else:
                raise ValueError(
                    f"unknown 4th-down choice {choice!r} "
                    "(want policy | go | fg | punt)")
            acc = None
            for ci in range(n_chunks):
                # same chunk keys for every choice — CRN across choices
                m = fn(self.pack, self.heads_state,
                       jax.random.fold_in(root, ci), dsit, chunk)
                acc = m if acc is None else acc + m
            res[choice] = _summary_from_moments_jit()(acc)
        return res


def situation_from_fields(*, ytg, offense=0, sec=None, quarter=None,
                          clock=None, down=1, dist=10.0, score_a=0,
                          score_b=0, cfg: Optional[SimConfig] = None
                          ) -> Situation:
    """THE parser for every human-facing situation input (CLI flags and
    HTTP bodies route here, so they can never drift apart): `offense` is
    'A'/'B' or 0/1; time is either `sec` (seconds left in the GAME) or
    `quarter` (1-4) + `clock` 'MM:SS' (left in that quarter, default
    15:00)."""
    cfg = cfg or SimConfig()
    if sec is None:
        if quarter is None:
            raise ValueError("a situation needs sec= or quarter= "
                             "(+ optional clock='MM:SS')")
        q = int(quarter)
        if not 1 <= q <= 4:
            raise ValueError(f"quarter must be 1..4, got {q}")
        mm, ss = str(clock if clock is not None else "15:00").split(":")
        sec = (4 - q) * cfg.clock.quarter_seconds + int(mm) * 60 + int(ss)
    if isinstance(offense, str):
        o = {"a": 0, "b": 1}.get(offense.strip().lower())
        if o is None:
            raise ValueError("offense must be 'A', 'B', 0, or 1")
        offense = o
    return Situation(offense=int(offense), sec=int(sec), down=int(down),
                     dist=float(dist), ytg=float(ytg),
                     score_a=int(score_a), score_b=int(score_b))


def _validated_situation(sit: Situation, cfg: SimConfig) -> Situation:
    """Host-side sanity bounds, applied only to concrete (non-traced)
    fields — traced scalars flow through untouched (the serving path
    validates at the JSON boundary instead)."""
    def _num(v):
        return isinstance(v, (int, float, np.integer, np.floating))

    if _num(sit.offense) and int(sit.offense) not in (0, 1):
        raise ValueError(f"offense must be 0 (team A) or 1, got {sit.offense}")
    if _num(sit.sec) and not 1 <= int(sit.sec) <= cfg.clock.game_seconds:
        raise ValueError(
            f"sec must be in [1, {cfg.clock.game_seconds}], got {sit.sec}")
    if _num(sit.down) and not 1 <= int(sit.down) <= 4:
        raise ValueError(f"down must be 1..4, got {sit.down}")
    if _num(sit.ytg) and not 1.0 <= float(sit.ytg) <= 99.0:
        raise ValueError(f"ytg must be in [1, 99], got {sit.ytg}")
    if _num(sit.dist) and not 0.0 < float(sit.dist) <= 99.0:
        raise ValueError(f"dist must be in (0, 99], got {sit.dist}")
    for nm in ("score_a", "score_b"):
        v = getattr(sit, nm)
        if _num(v) and not 0 <= int(v) < 128:
            # ScoreSummary histograms support [0, 128) — aggregate.MAX_PTS
            raise ValueError(f"{nm} must be in [0, 128), got {v}")
    return sit


def _device_situation(sit: Situation) -> Situation:
    """Situation as device scalars with fixed dtypes, so every live state
    hits ONE compiled program (i32 discrete fields, f32 yardages)."""
    return Situation(
        offense=jnp.asarray(sit.offense, jnp.int32),
        sec=jnp.asarray(sit.sec, jnp.int32),
        down=jnp.asarray(sit.down, jnp.int32),
        dist=jnp.asarray(sit.dist, jnp.float32),
        ytg=jnp.asarray(sit.ytg, jnp.float32),
        score_a=jnp.asarray(sit.score_a, jnp.int32),
        score_b=jnp.asarray(sit.score_b, jnp.int32),
    )


@lru_cache(maxsize=32)
def _live_moments_jit(cfg: SimConfig, heads_fn):
    """Score-only live launch reduced to ScoreMoments on device; the
    Situation argument is a pytree of scalars (runtime input, not a
    recompile key).  AotJit: a warm ServeConfig.aot_dir boots /live with
    zero compiles too (same switch as _shared_sim_jit)."""
    from .parallel.aggregate import score_moments
    from .utils.aot import AotJit, cfg_fingerprint

    return AotJit(
        lambda pack, hs, key, sit, n: score_moments(simulate_games(
            pack, cfg, heads_fn, hs, key, n, 0, collect_players=False,
            collect_stats=False, situation=sit).score),
        key=f"live_v1_{cfg_fingerprint(cfg)}_"
            f"{getattr(heads_fn, '__qualname__', 'h')}",
        static_argnums=(4,))


@lru_cache(maxsize=32)
def _live_batch_moments_jit(cfg: SimConfig, heads_fn):
    """S situations x n_per trials in one score-only launch, reduced to
    per-situation ScoreMoments (leading S axis) on device.  The (S,)
    situation arrays are runtime inputs; only (S, n_per) is a compile
    key."""
    from .parallel.aggregate import score_moments

    def run(pack, hs, key, sit, S, n_per):
        B = S * n_per
        per = Situation(*(jnp.repeat(a, n_per, total_repeat_length=B)
                          for a in sit))
        out = simulate_games(pack, cfg, heads_fn, hs, key, B, 0,
                             collect_players=False, collect_stats=False,
                             situation=per)
        return jax.vmap(score_moments)(out.score.reshape(S, n_per, 2))

    return jax.jit(run, static_argnums=(4, 5))


@lru_cache(maxsize=1)
def _summary_from_batch_moments_jit():
    from .parallel.aggregate import summary_from_moments

    return jax.jit(jax.vmap(summary_from_moments))


# forced-first-play draw stream id: disjoint from the chunk loop's
# absolute-step fold_in indices (max_plays << 2**20)
_FORCED_PLAY_STREAM = 1 << 20


@lru_cache(maxsize=32)
def _forced_live_moments_jit(cfg: SimConfig, cfg_forced: SimConfig,
                             heads_fn):
    """One play under `cfg_forced` (fourth.force set) from the resumed
    situation, then the rest of the game under the normal `cfg` — the
    4th-down evaluator's engine.  The forced play draws from
    fold_in(key, _FORCED_PLAY_STREAM); the continuation reuses the SAME
    per-step streams as the unforced live program, so choices share common
    random numbers and their win-prob deltas are low-variance."""
    from .ops.game import play_step, state_from_situation
    from .parallel.aggregate import score_moments

    def run(pack, hs, key, sit, n):
        init = state_from_situation(n, sit, cfg, pack.k, 0,
                                    collect_players=False,
                                    collect_stats=False)
        kf = jax.random.fold_in(key, _FORCED_PLAY_STREAM)
        s1 = play_step(init, kf, pack, cfg_forced, heads_fn, hs,
                       collect_players=False, collect_stats=False)
        out = simulate_games(pack, cfg, heads_fn, hs, key, n, 0,
                             collect_players=False, collect_stats=False,
                             init_state=s1)
        return score_moments(out.score)

    return jax.jit(run, static_argnums=(4,))


@lru_cache(maxsize=8)
def _fo_alternating(n_games: int):
    """Device-resident alternating first-offense vector, cached per size:
    rebuilding + re-uploading it every launch is per-launch host work and
    an H2D round trip for a constant input."""
    return jnp.asarray(np.arange(n_games) % 2, jnp.int32)


@lru_cache(maxsize=1)
def _score_moments_jit():
    from .parallel.aggregate import score_moments
    from .utils.aot import AotJit
    # AotJit == jax.jit until utils.aot.set_aot_dir activates snapshot
    # serving (ServeConfig.aot_dir / cli serve --aot).  Key versioning:
    # bump the _v suffix when the wrapped function's semantics change —
    # closure/callee bodies are invisible to the snapshot fingerprint.
    return AotJit(score_moments, key="moments_v1")


@lru_cache(maxsize=1)
def _summary_from_moments_jit():
    from .parallel.aggregate import summary_from_moments
    from .utils.aot import AotJit
    return AotJit(summary_from_moments, key="summmom_v1")


@lru_cache(maxsize=1)
def _summary_from_moments_vmap_jit():
    from .parallel.aggregate import summary_from_moments
    return jax.jit(jax.vmap(summary_from_moments))


@lru_cache(maxsize=32)
def _heads_fn_cached(mode: str, cfg: SimConfig):
    if mode == "table":
        return make_table_heads_eval(cfg)
    if mode == "exact":
        return make_exact_heads_eval(cfg)
    return make_analytic_heads_eval(cfg)


@lru_cache(maxsize=32)
def _shared_sim_jit(cfg: SimConfig, heads_fn):
    from .utils.aot import AotJit, cfg_fingerprint
    # the snapshot key carries cfg + the heads-eval identity: the lambda's
    # own bytecode (which the AOT fingerprint hashes) is the same for every
    # (cfg, mode), and a stage-1-table program must never serve an
    # analytic-mode request's snapshot.  _v1: bump on simulate_games /
    # play_step semantic changes (callee bodies are fingerprint-invisible;
    # an aot_dir is a per-deployment artifact — wipe it on upgrade).
    return AotJit(
        lambda pack, hs, key, fo, n, collect, stats: simulate_games(
            pack, cfg, heads_fn, hs, key, n, fo, collect_players=collect,
            collect_stats=stats),
        key=f"sim_v1_{cfg_fingerprint(cfg)}_"
            f"{getattr(heads_fn, '__qualname__', 'h')}",
        static_argnums=(4, 5, 6))


def _empty_heads() -> ModelHeads:
    return ModelHeads()


def scores_frame(out: GameState, team_a: str, team_b: str) -> pd.DataFrame:
    """Per-trial rows in the reference's scores schema: the 'team'
    perspective follows each trial's actual first-offense side, carried in
    the GameState (reference :1489-1503)."""
    score = np.asarray(out.score)
    fo = np.asarray(out.fo)
    team = np.where(fo == 0, team_a, team_b)
    opp = np.where(fo == 0, team_b, team_a)
    pts = np.where(fo == 0, score[:, 0], score[:, 1])
    opp_pts = np.where(fo == 0, score[:, 1], score[:, 0])
    return pd.DataFrame({"team": team, "opp": opp, "pts": pts, "opp_pts": opp_pts})


def players_frame(out: GameState, team_a: TeamContext, team_b: TeamContext) -> pd.DataFrame:
    """Long-format per-sim player rows (reference PLAYER_COLS, :1259-1299).
    Only tracked slots produce rows; the __Other__ sentinel is skipped."""
    ps = np.asarray(out.pstats)  # (B,2,3,K,6)
    B = ps.shape[0]
    teams = (team_a, team_b)
    role_tables = {
        ROLE_PASS: lambda tc: tc.qb,
        ROLE_RUSH: lambda tc: tc.rush,
        ROLE_REC: lambda tc: tc.target,
    }
    start_flags = np.where(np.asarray(out.fo) == 0, "A", "B")
    sims = np.arange(B)
    frames: List[pd.DataFrame] = []
    for side in (0, 1):
        tc = teams[side]
        opp = teams[1 - side].name
        for role, get in role_tables.items():
            table = get(tc)
            for k in range(table.k):
                if not table.tracked[k]:
                    continue
                v = ps[:, side, role, k, :]  # (B,6)
                used = v.any(axis=1)
                if not used.any():
                    continue
                vv = v[used]
                df = pd.DataFrame({c: 0 for c in PLAYER_COLS}, index=range(used.sum()))
                df["sim"] = sims[used]
                df["start"] = start_flags[used]
                df["team"] = tc.name
                df["opp"] = opp
                df["player"] = table.names[k]
                df["role"] = ROLE_LABEL[role]
                if role == ROLE_PASS:
                    df["pass_att"] = vv[:, PC_ATT].astype(int)
                    df["pass_comp"] = vv[:, PC_COMP].astype(int)
                    df["pass_yds"] = vv[:, PC_YDS].round(1)
                    df["pass_td"] = vv[:, PC_TD].astype(int)
                    df["INT"] = vv[:, PC_INT].astype(int)
                    df["sacks"] = vv[:, PC_SACKS].astype(int)
                elif role == ROLE_RUSH:
                    df["rush_att"] = vv[:, PC_ATT].astype(int)
                    df["rush_yds"] = vv[:, PC_YDS].round(1)
                    df["rush_td"] = vv[:, PC_TD].astype(int)
                else:
                    df["tgt"] = vv[:, PC_ATT].astype(int)
                    df["rec"] = vv[:, PC_COMP].astype(int)
                    df["rec_yds"] = vv[:, PC_YDS].round(1)
                    df["rec_td"] = vv[:, PC_TD].astype(int)
                frames.append(df)
    if not frames:
        return pd.DataFrame(columns=list(PLAYER_COLS))
    return pd.concat(frames, ignore_index=True)[list(PLAYER_COLS)]


def summary_frame(sims_df: pd.DataFrame) -> pd.DataFrame:
    """Reference summary parity (fast_monte_carlo_cfb.py:1681-1687)."""
    return sims_df.groupby("team").agg(
        mean_pts=("pts", "mean"),
        sd_pts=("pts", "std"),
        mean_opp=("opp_pts", "mean"),
        sd_opp=("opp_pts", "std"),
        win_rate=("pts", lambda s: (
            s.values > sims_df.loc[s.index, "opp_pts"].values).mean()),
    )


def csv_base_from(team_a: str, team_b: str, week: int, ext: str = ".csv") -> str:
    return f"{norm_team(team_a)}_{norm_team(team_b)}_wk{int(week)}_sims{ext}"


def simulate_matchup(
    team_a: TeamContext,
    team_b: TeamContext,
    heads: ModelHeads,
    n: int = 100,
    *,
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    collect_players: bool = False,
    mode: str = "table",
    shard: bool = False,
    runner: Optional[MatchupRunner] = None,
    key: Optional[jnp.ndarray] = None,
) -> Tuple[pd.DataFrame, Optional[pd.DataFrame], MatchupRunner]:
    cfg = cfg or SimConfig()
    runner = runner or MatchupRunner(team_a, team_b, heads, cfg, mode, shard=shard)
    out = runner.run_pairs(n, seed=seed, collect_players=collect_players, key=key)
    sims_df = scores_frame(out, team_a.name, team_b.name)
    players_df = players_frame(out, team_a, team_b) if collect_players else None
    return sims_df, players_df, runner


def simulate_upcoming_matchup(
    team_a: str,
    team_b: str,
    *,
    year: int = 2025,
    week: int = 1,
    sp_path: str,
    artifact_dir: str = "seeded:0",
    focus_csv: Optional[str] = None,
    n: int = 1000,
    seed: int = 0,
    collect_players: bool = True,
    save_csv: Optional[str] = None,
    mode: str = "table",
    shard: bool = False,
    cfg: Optional[SimConfig] = None,
    heads: Optional[ModelHeads] = None,
):
    """Full-parity entry point (reference :1661-1715).  Returns
    (sims_df, players_df, summary, ctx_a, ctx_b, meta)."""
    cfg = cfg or SimConfig()
    sp_df = load_sp_flex(sp_path)
    a = build_team_context_from_sp_flex(team_a, year, week, sp_df,
                                        focus_csv=focus_csv,
                                        player_slots=cfg.engine.player_slots)
    b = build_team_context_from_sp_flex(team_b, year, week, sp_df,
                                        focus_csv=focus_csv,
                                        player_slots=cfg.engine.player_slots)
    heads = heads if heads is not None else load_heads(artifact_dir)

    t0 = time.perf_counter()
    sims_df, players_df, _ = simulate_matchup(
        a, b, heads, n, cfg=cfg, seed=seed,
        collect_players=collect_players, mode=mode, shard=shard)
    sim_time = time.perf_counter() - t0

    summary = summary_frame(sims_df)

    write_time = 0.0
    if save_csv:
        t_w = time.perf_counter()
        _save_frames(save_csv, sims_df, players_df)
        write_time = time.perf_counter() - t_w

    meta = {
        "sim_time_sec": sim_time,
        "io_time_sec": write_time,
        "total_time_sec": sim_time + write_time,
        "sims": n,
        "mode": mode,
    }
    return sims_df, players_df, summary, a, b, meta


def _save_frames(save_csv: str, sims_df: pd.DataFrame,
                 players_df: Optional[pd.DataFrame]) -> None:
    try:
        if save_csv.lower().endswith(".parquet"):
            sims_df.to_parquet(f"scores_{save_csv}", index=False)
            if players_df is not None:
                players_df.to_parquet(f"players_{save_csv}", index=False)
        else:
            sims_df.to_csv(f"scores_{save_csv}", index=False)
            if players_df is not None:
                players_df.to_csv(f"players_{save_csv}", index=False)
    except Exception:
        sims_df.to_csv(f"scores_{save_csv}.csv", index=False)
        if players_df is not None:
            players_df.to_csv(f"players_{save_csv}.csv", index=False)


@dataclass
class SlateRunner:
    """Many matchups in ONE compiled program: the ('game','trial') layout.

    Games select direction rows in a shared pack/table (dirx = gid*2+off);
    trials are the (optionally device-sharded) batch axis.  One compile, one
    launch for the whole slate — vs the per-matchup loop in simulate_slate.
    Requires table mode with a single shared profile (fused preset).

    game_shard=True switches to the game-sharded layout instead
    (parallel.slate): per-matchup packs/tables stacked on a leading game
    axis and sharded over a ('game',) mesh, so each device holds only its
    own matchups' ~16k-row nano tables (the shared-table layout above
    concatenates all of them — ~983k rows at weekly-slate scale).  Use
    run_summaries() in this mode."""

    matchups: List[Tuple[TeamContext, TeamContext]]
    heads: ModelHeads
    cfg: SimConfig = field(default_factory=SimConfig)
    coach_map: Optional[Dict[str, str]] = None
    quality: str = "nano"
    shard: bool = False
    game_shard: bool = False

    def __post_init__(self):
        from .matchup import build_direction
        from .models.tables import (
            TableSet, build_fused_table, coarse_profile, fine_profile,
            nano_profile, turbo_profile,
        )
        from .ops.pack import pack_matchups
        from .ops.table_lookup import pack_tables_multi

        from .ops.table_lookup import TABLE_CACHE_DIR, _table_cache_key

        prof = {"turbo": turbo_profile, "nano": nano_profile}.get(
            self.quality, coarse_profile)()
        dirs = []
        ts_pairs = []
        for a, b in self.matchups:
            da = build_direction(a, b, self.heads, self.cfg, self.coach_map)
            db = build_direction(b, a, self.heads, self.cfg, self.coach_map)
            fa = fb = None
            cache_path = None
            if TABLE_CACHE_DIR:
                import pickle
                from pathlib import Path as _P
                key = _table_cache_key(a, b, self.heads, self.cfg,
                                       None, None, prof)
                cache_path = _P(TABLE_CACHE_DIR) / f"fusedpair_{key}.pkl"
                if cache_path.exists():
                    try:
                        with open(cache_path, "rb") as fh:
                            fa, fb = pickle.load(fh)
                    except Exception:
                        fa = fb = None
            if fa is None or fb is None:
                fa = build_fused_table(da, self.heads, self.cfg, prof)
                fb = build_fused_table(db, self.heads, self.cfg, prof)
                if fa is not None and fb is not None and cache_path is not None:
                    try:
                        cache_path.parent.mkdir(parents=True, exist_ok=True)
                        tmp = cache_path.with_suffix(".tmp")
                        with open(tmp, "wb") as fh:
                            pickle.dump((fa, fb), fh)
                        tmp.rename(cache_path)
                    except Exception:
                        pass
            if fa is None or fb is None:
                raise ValueError(
                    "SlateRunner needs fusible matchups (player-independent "
                    "model outputs); use simulate_slate for focus rosters")
            if self.cfg.engine.sd_mode != "axis":
                from .models.tables import (cachewarm_collapse,
                                            fused_head_groups, marginalize_sd)
                warm = None
                if self.cfg.engine.sd_mode == "cachewarm":
                    from .ops.table_lookup import cachewarm_events
                    warm = cachewarm_events(a, b, self.heads, self.cfg,
                                            self.coach_map)
                for nm, f, w in (("a", fa, warm and warm[0]),
                                 ("b", fb, warm and warm[1])):
                    if warm is not None:
                        m = cachewarm_collapse(f, prof, w,
                                               fused_head_groups(f))
                    else:
                        m = marginalize_sd(f, prof, self.cfg.engine.sd_mode)
                    m.fused_has_s2 = getattr(f, "fused_has_s2", False)
                    m.fused_has_fumble = getattr(f, "fused_has_fumble", False)
                    if nm == "a":
                        fa = m
                    else:
                        fb = m
            if self.quality == "nano":
                from .models.tables import nano_from_fused
                fa, fb = nano_from_fused(fa, prof), nano_from_fused(fb, prof)

                def mk(f):
                    ts = TableSet(stage1=None, stage2=None, pq=None, rq=None,
                                  sq=None, fumble=None, play=None,
                                  fine=fine_profile(), coarse=prof)
                    ts.nano = f
                    return ts
            else:
                mk = lambda f: TableSet(
                    stage1=None, stage2=None, pq=None, rq=None,
                    sq=None, fumble=None, play=None,
                    fine=fine_profile(), coarse=prof, fused=f)
            ts_pairs.append((mk(fa), mk(fb)))
            dirs.extend([da, db])
        k = self.matchups[0][0].qb.k
        fused_prof = None if self.quality == "nano" else prof
        nano_prof = prof if self.quality == "nano" else None
        if self.game_shard:
            from .parallel.slate import stack_games
            self.stacked_pack = stack_games(
                [pack_matchups(dirs[2 * i:2 * i + 2])
                 for i in range(len(self.matchups))])
            self.stacked_tables = stack_games(
                [pack_tables_multi([tp], k=k, fused_prof=fused_prof,
                                   nano_prof=nano_prof) for tp in ts_pairs])
            self.pack = self.heads_state = None
        else:
            self.pack = pack_matchups(dirs)
            self.heads_state = pack_tables_multi(
                ts_pairs, k=k, fused_prof=fused_prof, nano_prof=nano_prof)
        self.heads_fn = _heads_fn_cached("table", self.cfg)

    def run_summaries(self, n_pairs_per_game: int, seed: int = 0,
                      chunk_pairs: int = 32768,
                      mesh=None, return_summaries: bool = False):
        """Game-sharded slate sweep (requires game_shard=True): pipelined
        launches of `chunk_pairs` pairs per matchup, each launch a shard_map
        over the ('game',) mesh whose devices scan their local matchup
        stripe and reduce every game to ScoreMoments in-scan.  Moments
        accumulate ON DEVICE across launches (the BASELINE-config-#4
        pattern); one end transfer yields the per-matchup summary rows.

        return_summaries=True additionally returns the per-matchup
        ScoreSummary objects (margin/total/points histograms included) the
        rows were derived from — edge.slate_market_table prices every
        matchup's spread/total/moneyline off them with no further
        simulation or transfer."""
        from .parallel import game_mesh, pad_games, simulate_slate_moments

        if not self.game_shard:
            raise ValueError("run_summaries needs SlateRunner(game_shard=True)")
        from .config import resolve_nano_select
        cfg = resolve_nano_select(self.cfg, False)  # in-scan moments: score-only
        heads_fn = _heads_fn_cached("table", cfg)
        mesh = mesh or game_mesh()
        ndev = int(mesh.devices.size)
        g = len(self.matchups)
        gp = -(-g // ndev) * ndev
        sp = pad_games(self.stacked_pack, g, gp)
        st = pad_games(self.stacked_tables, g, gp)
        chunk_pairs = min(chunk_pairs, n_pairs_per_game)
        n_chunks = -(-n_pairs_per_game // chunk_pairs)
        root = jax.random.PRNGKey(seed)
        acc = None
        for ci in range(n_chunks):
            m = simulate_slate_moments(
                sp, cfg, heads_fn, st,
                jax.random.fold_in(root, ci), gp, 2 * chunk_pairs, mesh=mesh)
            acc = m if acc is None else jax.tree_util.tree_map(
                lambda a, b: a + b, m, acc)
        summ = _summary_from_moments_vmap_jit()(acc)
        host = fetch_tree(summ)  # one end transfer
        mean, win, n_arr = host.mean_pts, host.win_rate, host.n
        rows = []
        for gi, (a, b) in enumerate(self.matchups):
            rows.append({
                "team_a": a.name, "team_b": b.name,
                "mean_a": float(mean[gi, 0]), "mean_b": float(mean[gi, 1]),
                "win_a": float(win[gi, 0]), "win_b": float(win[gi, 1]),
                "mean_margin_a": float(mean[gi, 0] - mean[gi, 1]),
                "mean_total": float(mean[gi, 0] + mean[gi, 1]),
                "n_games": int(n_arr[gi]),
            })
        df = pd.DataFrame(rows)
        if return_summaries:
            per_game = [jax.tree_util.tree_map(lambda x: x[gi], host)
                        for gi in range(len(self.matchups))]
            return df, per_game
        return df

    def run(self, n_pairs_per_game: int, seed: int = 0) -> GameState:
        """Returns the final GameState for G * 2*n_pairs games; trial t is
        game t // (2*n_pairs), alternating first offense within a game."""
        if self.game_shard:
            raise ValueError("run() is the shared-table path; game_shard "
                             "slates use run_summaries()")
        g = len(self.matchups)
        per = 2 * n_pairs_per_game
        n = g * per
        idx = np.arange(n)
        gid = jnp.asarray(idx // per, jnp.int32)
        fo = jnp.asarray(idx % 2, jnp.int32)
        if self.shard:
            out = simulate_games_sharded(
                self.pack, self.cfg, self.heads_fn, self.heads_state,
                jax.random.PRNGKey(seed), n, fo, game_id=gid)
        else:
            from .config import resolve_nano_select
            cfg = resolve_nano_select(self.cfg, False)  # slate jit is score-only
            fn = _shared_slate_jit(cfg, _heads_fn_cached("table", cfg))
            out = fn(self.pack, self.heads_state, jax.random.PRNGKey(seed),
                     fo, gid, n)
        jax.block_until_ready(out.score)
        return out

    def summaries(self, out: GameState) -> pd.DataFrame:
        g = len(self.matchups)
        sc = np.asarray(out.score, dtype=float)
        per = sc.shape[0] // g
        rows = []
        for gi, (a, b) in enumerate(self.matchups):
            s = sc[gi * per:(gi + 1) * per]
            rows.append({
                "team_a": a.name, "team_b": b.name,
                "mean_a": s[:, 0].mean(), "mean_b": s[:, 1].mean(),
                "win_a": (s[:, 0] > s[:, 1]).mean(),
                "win_b": (s[:, 1] > s[:, 0]).mean(),
                "mean_margin_a": (s[:, 0] - s[:, 1]).mean(),
                "mean_total": s.sum(axis=1).mean(),
                "n_games": per,
            })
        return pd.DataFrame(rows)


# chunk-key convention for checkpointed sweeps (see simulate_matchup_batched)
_CHUNK_KEY_SCHEME = "fold_in-v2"

# Reusable runners for the slate/serving drivers.  A MatchupRunner is
# read-only after __post_init__ (pack, heads_state, heads_fn), so reuse is
# the library's own supported pattern (simulate_matchup's `runner=`).
# Contexts and heads are content-memoized singletons (data.context
# _CONTEXT_MEMO, models.heads._HEADS_MEMO), so INSTANCE IDENTITY is the
# staleness signal here; the memo holds strong refs, which keeps those ids
# unique for the lifetime of each entry.  Saves the host work of pack
# assembly + table-cache key hashing per matchup per call — serial in
# single-matchup serving requests.  FIFO-capped like the device-table
# cache.
def _fifo_memo(memo: Dict, cap: int, key, build):
    """Shared FIFO memo used by the runner caches below.  id()-based keys
    are safe ONLY because the cached value pins the keyed objects alive
    (the runner holds its contexts/heads), so an id can't be reused while
    its entry lives — keep that invariant if you touch eviction."""
    v = memo.get(key)
    if v is None:
        v = build()
        while len(memo) >= cap:
            memo.pop(next(iter(memo)))
        memo[key] = v
    return v


_RUNNER_MEMO: Dict[tuple, "MatchupRunner"] = {}
_RUNNER_MEMO_MAX = 128


def _runner_for(a: TeamContext, b: TeamContext, heads, cfg: SimConfig,
                mode: str, table_quality: str, shard: bool) -> "MatchupRunner":
    return _fifo_memo(
        _RUNNER_MEMO, _RUNNER_MEMO_MAX,
        (id(a), id(b), id(heads), cfg, mode, table_quality, shard),
        lambda: MatchupRunner(a, b, heads, cfg, mode=mode,
                              table_quality=table_quality, shard=shard))


_GAME_SHARD_MEMO: Dict = {}
_GAME_SHARD_MEMO_MAX = 4
# key -> original build-error message; FIFO-bounded like the memos so a
# transient failure can't mark a slate failed forever (ADVICE r4)
_GAME_SHARD_FAILED: Dict = {}
_GAME_SHARD_FAILED_MAX = 16

# the quality presets SlateRunner actually supports: anything else maps
# to a coarse FUSED table inside __post_init__ — a different quantization
# ladder than the loop's per-head tables, so routing must not send other
# presets here silently (cli --batched clamps to the same set)
GAME_SHARD_QUALITIES = ("nano", "turbo", "fused")


def _game_shard_runner(games, year, week, sp_df, heads, cfg, quality,
                       explicit=False):
    """Memoized game-sharded SlateRunner for the layout='auto'/'game_shard'
    path — without this every warm multi-device slate call would re-run
    build_direction/build_fused_table/pack/upload per request (the exact
    30-120s warm-call host-overhead class the round-3 memos eliminated).
    Context identity carries the content fingerprint: the team-context
    builder is itself memoized, so same inputs -> same cached instances
    -> same ids.  Returns None for a slate that already FAILED to build
    (non-fusible) so the auto path skips straight to the loop instead of
    paying the throwaway table builds again."""
    ctxs = []
    for ta, tb in games:
        ctxs.append(tuple(
            build_team_context_from_sp_flex(
                t, year, week, sp_df, player_slots=cfg.engine.player_slots)
            for t in (ta, tb)))
    key = (tuple((id(a), id(b)) for a, b in ctxs), id(heads), cfg, quality)
    if key in _GAME_SHARD_FAILED:
        if explicit:
            raise ValueError(
                "layout='game_shard': this slate previously failed to "
                f"build fusible tables: {_GAME_SHARD_FAILED[key]}")
        return None
    try:
        return _fifo_memo(
            _GAME_SHARD_MEMO, _GAME_SHARD_MEMO_MAX, key,
            lambda: SlateRunner(ctxs, heads, cfg, quality=quality,
                                game_shard=True))
    except Exception as e:
        while len(_GAME_SHARD_FAILED) >= _GAME_SHARD_FAILED_MAX:
            _GAME_SHARD_FAILED.pop(next(iter(_GAME_SHARD_FAILED)))
        _GAME_SHARD_FAILED[key] = f"{type(e).__name__}: {e}"
        raise


@lru_cache(maxsize=8)
def _shared_slate_jit(cfg: SimConfig, heads_fn):
    # slate summaries consume scores only: skip player AND box-score accrual
    return jax.jit(
        lambda pack, hs, key, fo, gid, n: simulate_games(
            pack, cfg, heads_fn, hs, key, n, fo, collect_players=False,
            game_id=gid, collect_stats=False),
        static_argnums=(5,))


def simulate_matchup_batched(
    team_a: TeamContext,
    team_b: TeamContext,
    heads: ModelHeads,
    n_pairs_total: int,
    batch_pairs: int,
    run_dir: str,
    *,
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    mode: str = "table",
    collect_players: bool = False,
) -> pd.DataFrame:
    """Checkpointed long sweep: trial batches are the resume unit (SURVEY
    §5.3/§5.4 rebuild note).  Completed chunks are parquet files in
    `run_dir`; re-invoking skips them, so a killed sweep continues where it
    stopped.  Chunk results are deterministic in (seed, chunk index): each
    chunk runs under fold_in(PRNGKey(seed), chunk).  A KEY_SCHEME marker
    in `run_dir` records that convention: dirs holding chunks from the
    pre-fold_in scheme (PRNGKey(seed+chunk)) are refused rather than
    silently spliced into a mixed-convention dataset no fresh run could
    reproduce."""
    from pathlib import Path

    cfg = cfg or SimConfig()
    d = Path(run_dir)
    d.mkdir(parents=True, exist_ok=True)
    scheme = d / "KEY_SCHEME"
    if scheme.exists():
        tag = scheme.read_text().strip()
        if tag != _CHUNK_KEY_SCHEME:
            raise ValueError(
                f"{run_dir} was written under chunk-key scheme {tag!r}; "
                f"this build uses {_CHUNK_KEY_SCHEME!r}. Resuming would mix "
                "two RNG conventions in one dataset — use a fresh run_dir "
                "(or delete the old chunks to restart).")
    elif any(d.glob("scores_chunk_*.parquet")):
        raise ValueError(
            f"{run_dir} holds chunks with no KEY_SCHEME marker (written "
            "before the fold_in chunk-key change). Resuming would splice "
            "two RNG conventions — use a fresh run_dir or delete the old "
            "chunks.")
    else:
        scheme.write_text(_CHUNK_KEY_SCHEME + "\n")
    runner = None
    n_chunks = (n_pairs_total + batch_pairs - 1) // batch_pairs
    root = jax.random.PRNGKey(seed)
    frames = []
    for ci in range(n_chunks):
        chunk_path = d / f"scores_chunk_{ci:05d}.parquet"
        if chunk_path.exists():
            frames.append(pd.read_parquet(chunk_path))
            continue
        pairs = min(batch_pairs, n_pairs_total - ci * batch_pairs)
        sims_df, players_df, runner = simulate_matchup(
            team_a, team_b, heads, pairs, cfg=cfg,
            key=jax.random.fold_in(root, ci),
            collect_players=collect_players, mode=mode, runner=runner)
        tmp = chunk_path.with_suffix(".tmp")
        sims_df.to_parquet(tmp, index=False)
        tmp.rename(chunk_path)
        if collect_players and players_df is not None:
            players_df.to_parquet(d / f"players_chunk_{ci:05d}.parquet", index=False)
        frames.append(sims_df)
    return pd.concat(frames, ignore_index=True)


def simulate_slate(
    games: List[Tuple[str, str]],
    *,
    sp_path: str,
    year: int = 2025,
    week: int = 1,
    n: int = 1000,
    artifact_dir: str = "seeded:0",
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
) -> pd.DataFrame:
    """Simulate a weekly slate; returns one summary row per matchup.

    Defaults to the fused single-gather tables: one compiled program is
    reused across all matchups (same table shapes), builds hit the disk
    cache on reuse."""
    cfg = cfg or SimConfig()
    heads = load_heads(artifact_dir)
    sp_df = load_sp_flex(sp_path)
    rows = []
    for gi, (ta, tb) in enumerate(games):
        a = build_team_context_from_sp_flex(ta, year, week, sp_df, focus_csv=focus_csv,
                                            player_slots=cfg.engine.player_slots)
        b = build_team_context_from_sp_flex(tb, year, week, sp_df, focus_csv=focus_csv,
                                            player_slots=cfg.engine.player_slots)
        runner = _runner_for(a, b, heads, cfg, mode, table_quality, False)
        sims_df, _, _ = simulate_matchup(a, b, heads, n, cfg=cfg,
                                         seed=seed + gi, mode=mode,
                                         runner=runner)
        s = summary_frame(sims_df)
        margin = sims_df.loc[sims_df.team == ta, "pts"].values - \
            sims_df.loc[sims_df.team == ta, "opp_pts"].values
        total = sims_df["pts"].values + sims_df["opp_pts"].values
        wa = float((sims_df.loc[sims_df.team == ta, "pts"].values >
                    sims_df.loc[sims_df.team == ta, "opp_pts"].values).mean())
        wb = float((sims_df.loc[sims_df.team == tb, "pts"].values >
                    sims_df.loc[sims_df.team == tb, "opp_pts"].values).mean())
        rows.append({
            "team_a": ta, "team_b": tb,
            "mean_a": float(s.loc[ta, "mean_pts"]), "mean_b": float(s.loc[tb, "mean_pts"]),
            "win_a": wa, "win_b": wb,
            "mean_margin_a": float(margin.mean()),
            "mean_total": float(total.mean()),
            "n_games": len(sims_df),
        })
    return pd.DataFrame(rows)


def simulate_slate_summaries(
    games: List[Tuple[str, str]],
    *,
    sp_path: str,
    year: int = 2025,
    week: int = 1,
    n_pairs: int = 50000,
    artifact_dir: str = "seeded:0",
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    shard: bool = False,
    chunk_pairs: int = 32768,
    return_summaries: bool = False,
    layout: str = "auto",
):
    """Production slate sweep: the per-matchup launch loop with device-
    accumulated ScoreMoments and ONE host transfer at the very end (the
    fastest slate shape on one chip of the earlier hardware; per-matchup
    transfers would serialize dispatch — hence the stacked single
    readback).  Warm repeat calls avoid host rebuilds: model forests pack
    once per heads instance, matchup tables
    are cached device-resident, and the host rebuild costs are memoized
    on content fingerprints (ops/pack.pack_heads memo, ops/table_lookup
    _DEVICE_TABLE_CACHE, models.heads.load_heads artifact-stat memo,
    data.context build_team_context_from_sp_flex memo).

    shard=True runs every launch as a shard_map over the full trial mesh
    (parallel.simulate_moments_sharded: per-device moment reduction + one
    ~1.3 KB psum per chunk) and scales chunk_pairs by the device count so
    each device keeps the same per-launch size.  The game-sharded
    SlateRunner (one launch, zero per-matchup dispatch) ran slightly below
    this loop on one chip of the earlier hardware and is the multi-chip
    game-axis layout; it needs fusible matchups and returns score
    summaries only, while this loop additionally serves focus rosters and
    player collection.

    Per-game root keys are fold_in(PRNGKey(seed), game), so no two games
    (or seeds) share draw streams.  Returns one summary row per matchup
    (same columns as SlateRunner.run_summaries); return_summaries=True
    additionally returns the per-matchup ScoreSummary objects (histograms
    included) for edge.slate_market_table pricing.

    layout picks between the two slate executions:
      'loop'       — the per-matchup launch loop above (shard=True makes
                     each launch trial-sharded over the mesh);
      'game_shard' — the game-sharded SlateRunner scan (one launch,
                     matchups sharded over a ('game',) mesh; the
                     multi-chip game-axis layout);
      'auto'       — loop on a single device (or a 1-game slate),
                     game-sharded scan on a multi-device mesh (unless
                     shard=True explicitly chose trial sharding, focus
                     rosters are in play, mode isn't 'table', or the
                     matchups aren't fusible — those fall back to the
                     loop).  An explicit 'game_shard' REJECTS focus_csv
                     and non-table modes instead of silently dropping
                     them."""
    cfg = cfg or SimConfig()
    if layout not in ("auto", "loop", "game_shard"):
        raise ValueError(f"layout must be auto|loop|game_shard, got {layout!r}")
    if not games:
        # mirror simulate_slate_props' empty-input contract instead of
        # letting tree_map die on zero summaries
        df = pd.DataFrame()
        return (df, []) if return_summaries else df
    heads = load_heads(artifact_dir)
    sp_df = load_sp_flex(sp_path)
    if layout == "game_shard":
        # an explicit request must not silently drop incompatible knobs:
        # focus rosters can't fuse into shared tables, the scan only
        # exists for table mode, shard=True means TRIAL sharding (a
        # different layout), and SlateRunner maps unsupported quality
        # presets to a coarse fused table (a different quantization
        # ladder than the loop's per-head tables)
        if focus_csv is not None:
            raise ValueError("layout='game_shard' cannot honor focus_csv "
                             "(focus rosters are player-dependent and "
                             "don't fuse); use layout='loop'")
        if mode != "table":
            raise ValueError(f"layout='game_shard' is table-mode only "
                             f"(got mode={mode!r}); use layout='loop'")
        if shard:
            raise ValueError("layout='game_shard' and shard=True (trial "
                             "sharding) are different layouts — pick one")
        if table_quality not in GAME_SHARD_QUALITIES:
            raise ValueError(
                f"layout='game_shard' supports table_quality in "
                f"{GAME_SHARD_QUALITIES} (got {table_quality!r}); other "
                f"presets would silently degrade to a coarse fused table")
    want_game_shard = layout == "game_shard" or (
        layout == "auto" and jax.device_count() > 1 and not shard
        and len(games) > 1 and focus_csv is None and mode == "table"
        and table_quality in GAME_SHARD_QUALITIES)
    if want_game_shard:
        sr = None
        try:
            sr = _game_shard_runner(
                tuple(tuple(g) for g in games), year, week, sp_df, heads,
                cfg, table_quality, explicit=layout == "game_shard")
        except Exception:
            # catch ALL build-failure types (KeyError/TypeError from
            # pack/table assembly, not just ValueError — ADVICE r4): an
            # unusual matchup must fall back to the loop, not fail the call
            if layout == "game_shard":
                raise     # explicitly requested: surface the reason
            # auto: non-fusible matchups (player-dependent heads etc.)
            # fall back to the per-matchup loop below
        if sr is not None:
            # runtime errors inside the run must SURFACE, not silently
            # re-simulate the slate through the loop
            return sr.run_summaries(n_pairs, seed=seed,
                                    chunk_pairs=chunk_pairs,
                                    return_summaries=return_summaries)
    if shard:
        chunk_pairs *= jax.device_count()
    root = jax.random.PRNGKey(seed)
    summs = []
    for gi, (ta, tb) in enumerate(games):
        a = build_team_context_from_sp_flex(
            ta, year, week, sp_df, focus_csv=focus_csv,
            player_slots=cfg.engine.player_slots)
        b = build_team_context_from_sp_flex(
            tb, year, week, sp_df, focus_csv=focus_csv,
            player_slots=cfg.engine.player_slots)
        runner = _runner_for(a, b, heads, cfg, mode, table_quality, shard)
        summs.append(runner.run_pairs_summary(
            n_pairs, key=jax.random.fold_in(root, gi),
            chunk_pairs=chunk_pairs, block=False))
    # stack the per-matchup summaries on device and transfer ONCE: a
    # per-matchup-per-field readback would cost ~60x8 synchronizing
    # transfers — the same class of tax as the per-chunk transfers this
    # path exists to avoid
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *summs)
    stacked = fetch_tree(stacked)  # the 8 leaves ride ONE transfer
    host = [jax.tree_util.tree_map(lambda x: x[gi], stacked)
            for gi in range(len(summs))]
    rows = []
    for (ta, tb), s in zip(games, host):
        mean, win = s.mean_pts, s.win_rate
        rows.append({
            "team_a": ta, "team_b": tb,
            "mean_a": float(mean[0]), "mean_b": float(mean[1]),
            "win_a": float(win[0]), "win_b": float(win[1]),
            "mean_margin_a": float(mean[0] - mean[1]),
            "mean_total": float(mean[0] + mean[1]),
            "n_games": int(s.n),
        })
    df = pd.DataFrame(rows)
    if return_summaries:
        return df, host
    return df


def _prepared_contexts(team_a, team_b, *, sp_path, year, week, artifact_dir,
                       focus_csv, cfg):
    """Memoized cold-path loads shared by the single-matchup entry points
    (heads + SP table + both team contexts) — everything needed to
    VALIDATE a request, without paying the runner's table build yet.
    Returns (heads, ctx_a, ctx_b, cfg)."""
    cfg = cfg or SimConfig()
    heads = load_heads(artifact_dir)
    sp_df = load_sp_flex(sp_path)
    a = build_team_context_from_sp_flex(
        team_a, year, week, sp_df, focus_csv=focus_csv,
        player_slots=cfg.engine.player_slots)
    b = build_team_context_from_sp_flex(
        team_b, year, week, sp_df, focus_csv=focus_csv,
        player_slots=cfg.engine.player_slots)
    return heads, a, b, cfg


def _prepared_runner(team_a, team_b, *, sp_path, year, week, artifact_dir,
                     focus_csv, mode, table_quality, cfg, shard):
    """_prepared_contexts plus the runner memo (which builds/uploads the
    matchup tables).  Returns (runner, ctx_a, ctx_b, cfg)."""
    heads, a, b, cfg = _prepared_contexts(
        team_a, team_b, sp_path=sp_path, year=year, week=week,
        artifact_dir=artifact_dir, focus_csv=focus_csv, cfg=cfg)
    return _runner_for(a, b, heads, cfg, mode, table_quality, shard), a, b, cfg


def simulate_live_game(
    team_a: str,
    team_b: str,
    situation: Situation,
    *,
    sp_path: str,
    year: int = 2025,
    week: int = 1,
    n_games: int = 65536,
    artifact_dir: str = "seeded:0",
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    shard: bool = False,
    chunk_games: int = 65536,
):
    """Live in-game win probability + market distribution for one matchup.

    Resumes `n_games` trials from `situation` (current possession, clock,
    down/distance, field position, score) and returns (row, ScoreSummary):
    `row` is the headline dict (win/tie rates, means, sds), and the summary
    carries the margin/total histograms for live market pricing via
    edge.market_odds_from_summary / edge.summary_moneyline.  Rides the same
    warm memo chain as the slate APIs (heads artifact-stat memo, context
    content memo, _runner_for, device-table cache), so a resident process
    answers repeat live queries at serving latency — the situation is a
    runtime input to one cached compiled program, never a recompile key.
    No reference counterpart (its simulate_game is kickoff-only)."""
    runner, a, b, cfg = _prepared_runner(
        team_a, team_b, sp_path=sp_path, year=year, week=week,
        artifact_dir=artifact_dir, focus_csv=focus_csv, mode=mode,
        table_quality=table_quality, cfg=cfg, shard=shard)
    summary = runner.run_live(situation, n_games=n_games, seed=seed,
                              chunk_games=chunk_games, block=False)
    s = fetch_tree(summary)
    row = {
        "team_a": team_a, "team_b": team_b,
        "offense": int(np.asarray(situation.offense)),
        "sec": int(np.asarray(situation.sec)),
        "down": int(np.asarray(situation.down)),
        "dist": float(np.asarray(situation.dist)),
        "ytg": float(np.asarray(situation.ytg)),
        "score_a": int(np.asarray(situation.score_a)),
        "score_b": int(np.asarray(situation.score_b)),
        "win_a": float(s.win_rate[0]), "win_b": float(s.win_rate[1]),
        "tie": float(s.tie_rate),
        "mean_a": float(s.mean_pts[0]), "mean_b": float(s.mean_pts[1]),
        "sd_a": float(s.sd_pts[0]), "sd_b": float(s.sd_pts[1]),
        "mean_margin_a": float(s.mean_pts[0] - s.mean_pts[1]),
        "mean_total": float(s.mean_pts[0] + s.mean_pts[1]),
        "n_games": int(s.n),
    }
    return row, s


def simulate_live_curve(
    team_a: str,
    team_b: str,
    situations,
    *,
    sp_path: str,
    year: int = 2025,
    week: int = 1,
    n_games_per: int = 8192,
    artifact_dir: str = "seeded:0",
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
):
    """Win-probability curve: price a LIST of mid-game situations in one
    launch (MatchupRunner.run_live_batch — S situations x n_games_per
    trials packed into one batch, per-situation reductions on device, one
    readback).  Returns (DataFrame of one headline row per situation in
    input order, stacked ScoreSummary with a leading S axis for market
    pricing per point).  Feed it a game's event log for a WP chart, or one
    state across hypothetical scores for a ladder.  No reference
    counterpart (its simulate_game is kickoff-only and one-state-at-a-
    time)."""
    runner, a, b, cfg = _prepared_runner(
        team_a, team_b, sp_path=sp_path, year=year, week=week,
        artifact_dir=artifact_dir, focus_csv=focus_csv, mode=mode,
        table_quality=table_quality, cfg=cfg, shard=False)
    stacked = runner.run_live_batch(situations, n_games_per=n_games_per,
                                    seed=seed, block=False)
    s = fetch_tree(stacked)
    rows = []
    for i, sit in enumerate(situations):
        rows.append({
            "team_a": team_a, "team_b": team_b,
            "offense": int(np.asarray(sit.offense)),
            "sec": int(np.asarray(sit.sec)),
            "down": int(np.asarray(sit.down)),
            "dist": float(np.asarray(sit.dist)),
            "ytg": float(np.asarray(sit.ytg)),
            "score_a": int(np.asarray(sit.score_a)),
            "score_b": int(np.asarray(sit.score_b)),
            "win_a": float(s.win_rate[i, 0]),
            "win_b": float(s.win_rate[i, 1]),
            "tie": float(s.tie_rate[i]),
            "mean_a": float(s.mean_pts[i, 0]),
            "mean_b": float(s.mean_pts[i, 1]),
            "mean_margin_a": float(s.mean_pts[i, 0] - s.mean_pts[i, 1]),
            "mean_total": float(s.mean_pts[i, 0] + s.mean_pts[i, 1]),
            "n_games": int(s.n[i]),
        })
    return pd.DataFrame(rows), s


def evaluate_fourth_down(
    team_a: str,
    team_b: str,
    situation: Situation,
    *,
    sp_path: str,
    year: int = 2025,
    week: int = 1,
    n_games: int = 65536,
    artifact_dir: str = "seeded:0",
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    chunk_games: int = 65536,
    choices=("policy", "go", "fg", "punt"),
) -> dict:
    """4th-down decision chart: from a down=4 `situation`, force the first
    play each way (go / field goal / punt) and report the offense's win
    probability under each choice next to the engine's own sampled policy
    (MatchupRunner.run_fourth_decision; the choices share continuation
    draw streams, so the DIFFERENCES are common-random-number precise).
    The reference cannot ask this — handle_fourth always samples its
    policy (fast_monte_carlo_cfb.py:1394-1421).

    Returns {"choices": {choice: row}, "best": <forced choice with top
    offense win prob>, "best_vs_policy_pp": delta, "se_pp": the single-
    choice MC scale}.  `fg` is priced even from silly range (the make
    curve floors at fg_long_prob); `row["fg_make_prob"]` says what the
    kick is."""
    from .models import analytic

    runner, a, b, cfg = _prepared_runner(
        team_a, team_b, sp_path=sp_path, year=year, week=week,
        artifact_dir=artifact_dir, focus_csv=focus_csv, mode=mode,
        table_quality=table_quality, cfg=cfg, shard=False)
    summaries = runner.run_fourth_decision(
        situation, n_games=n_games, seed=seed, chunk_games=chunk_games,
        choices=choices)
    fetched = fetch_tree(summaries)   # every choice in ONE packed transfer
    off = int(np.asarray(situation.offense))
    out = {}
    for choice, s in fetched.items():
        row = {
            "win_off": round(float(s.win_rate[off]), 6),
            "win_a": round(float(s.win_rate[0]), 6),
            "win_b": round(float(s.win_rate[1]), 6),
            "tie": round(float(s.tie_rate), 6),
            "mean_margin_off": round(
                float(s.mean_pts[0] - s.mean_pts[1]) * (1 - 2 * off), 3),
            "n_games": int(s.n),
        }
        if choice == "fg":
            row["fg_make_prob"] = round(float(analytic.field_goal_prob(
                float(np.asarray(situation.ytg))
                + cfg.st.fg_snap_plus_endzone, cfg)), 4)
        out[choice] = row
    forced = [c for c in out if c != "policy"]
    best = max(forced, key=lambda c: out[c]["win_off"]) if forced else None
    # MC scale off any priced choice (run_fourth_decision guarantees >= 1)
    p = out[best]["win_off"] if best else next(iter(out.values()))["win_off"]
    res = {
        "team_a": team_a, "team_b": team_b,
        "situation": {
            "offense": off, "sec": int(np.asarray(situation.sec)),
            "down": int(np.asarray(situation.down)),
            "dist": float(np.asarray(situation.dist)),
            "ytg": float(np.asarray(situation.ytg)),
            "score_a": int(np.asarray(situation.score_a)),
            "score_b": int(np.asarray(situation.score_b)),
        },
        "choices": out, "best": best,
        "se_pp": round(100 * float(np.sqrt(max(p * (1 - p), 1e-12)
                                           / max(n_games, 1))), 3),
    }
    if best is not None and "policy" in out:
        res["best_vs_policy_pp"] = round(
            (out[best]["win_off"] - out["policy"]["win_off"]) * 100, 2)
    return res


def simulate_parlay(
    team_a: str,
    team_b: str,
    legs,
    *,
    sp_path: str,
    year: int = 2025,
    week: int = 1,
    n_pairs: int = 32768,
    artifact_dir: str = "seeded:0",
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    shard: bool = False,
    price: Optional[int] = None,
    correlations: bool = False,
    round_robin=None,
) -> dict:
    """Price a same-game parlay (joint multi-leg ticket) for one matchup.

    Runs 2*n_pairs trials once and settles every leg per trial on device
    (edge.parlay_odds), so correlations between the legs — a favorite's
    moneyline and its cover, a QB's passing yards and the over — are priced
    from the joint sample.  No reference counterpart: edge_finder.py prices
    each market from its own marginal distribution only.

    Player stats are only collected (and only then cost sim throughput)
    when a prop leg is present.  `price` (American, e.g. +450) adds quoted
    edge/EV columns to the result; `correlations=True` adds the pairwise
    leg-correlation matrix (edge.parlay_correlations, computed off the
    SAME trial sample) under `leg_corr`; `round_robin` (a ticket size or
    list of sizes, e.g. 2 or (2, 3)) adds every size-k combination of the
    legs priced as its own ticket off the same trials
    (edge.round_robin) under `round_robin`."""
    heads, a, b, cfg = _prepared_contexts(
        team_a, team_b, sp_path=sp_path, year=year, week=week,
        artifact_dir=artifact_dir, focus_csv=focus_csv, cfg=cfg)
    # validate the legs BEFORE the runner's table build or any sim: a bad
    # leg must not cost a device upload, let alone a run (the resolved
    # encoding is passed through so pricing never re-resolves)
    resolved = edge.resolve_parlay_legs(a, b, legs)
    if round_robin is not None:  # bad sizes also fail before any sim
        edge._rr_sizes(round_robin, len(legs))
    runner = _runner_for(a, b, heads, cfg, mode, table_quality, shard)
    want_players = any(
        str(leg.get("kind", "")).strip().lower() == "prop" for leg in legs)
    out = runner.run_pairs(n_pairs, seed=seed,
                           collect_players=want_players,
                           collect_stats=False, block=False)
    res = edge.parlay_odds(out, a, b, legs, price=price, resolved=resolved)
    if correlations:
        res["leg_corr"] = edge.parlay_correlations(out, a, b, legs,
                                                   resolved=resolved)
    if round_robin is not None:
        res["round_robin"] = edge.round_robin(out, a, b, legs,
                                              by=round_robin, price=price,
                                              resolved=resolved)
    return res


def project_season(
    team: str,
    opponents: Optional[List[str]] = None,
    games: Optional[List[Tuple[str, str]]] = None,
    *,
    line: Optional[float] = None,
    sp_path: str,
    year: int = 2025,
    week: int = 1,
    n_pairs: int = 50000,
    artifact_dir: str = "seeded:0",
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    shard: bool = False,
    chunk_pairs: int = 32768,
    price: int = -110,
) -> dict:
    """Project a team's season win total from per-game simulations.

    Pass the schedule either as `opponents` (a list of opponent names —
    `team` takes side A in every matchup) or as explicit `games` rows in
    which `team` must appear on one side.  Each matchup runs through the
    production slate sweep (simulate_slate_summaries: per-matchup
    launches, device-accumulated moments, ONE end transfer, per-game
    fold_in roots), the team's strict win probability is read off each
    summary, and the season win-count distribution is composed EXACTLY
    (edge.season_win_pmf — distinct games are independent sims, so the
    Poisson-binomial convolution is not an approximation).  `line` adds
    the over/under market at the quoted win total (edge.season_win_market).

    Returns the market dict plus a `schedule` DataFrame (one row per
    matchup, slate-summary columns + the team's p_win).  No reference
    counterpart: edge_finder.py prices single matchups only; composing a
    season there means hand-gluing per-game CSV runs."""
    if (opponents is None) == (games is None):
        raise ValueError("pass exactly one of opponents= or games=")
    if opponents is not None:
        games = [(team, o) for o in opponents]
    tn = edge._norm_team(team)
    sides = []
    for ta, tb in games:
        if edge._norm_team(ta) == tn:
            sides.append("a")
        elif edge._norm_team(tb) == tn:
            sides.append("b")
        else:
            raise ValueError(
                f"{team!r} plays in every scheduled game, but ({ta!r}, "
                f"{tb!r}) doesn't include it")
    df = simulate_slate_summaries(
        list(games), sp_path=sp_path, year=year, week=week,
        n_pairs=n_pairs, artifact_dir=artifact_dir, focus_csv=focus_csv,
        mode=mode, table_quality=table_quality, cfg=cfg, seed=seed,
        shard=shard, chunk_pairs=chunk_pairs)
    p_wins = [float(row[f"win_{s}"])
              for s, (_, row) in zip(sides, df.iterrows())]
    res = edge.season_win_market(p_wins, line=line, team=team, price=price)
    res["schedule"] = df.assign(
        team_side=sides,
        p_win_team=np.round(p_wins, 6),
        opponent=[ta if s == "b" else tb
                  for s, (ta, tb) in zip(sides, games)])
    return res


def simulate_slate_props(
    games: List[Tuple[str, str]],
    *,
    sp_path: str,
    props_csv,  # CSV path or a prepared pd.DataFrame of prop rows
    year: int = 2025,
    week: int = 1,
    n_pairs: int = 8192,
    artifact_dir: str = "seeded:0",
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    min_abs_edge_pct: float = 2.0,
    shard: bool = False,
) -> pd.DataFrame:
    """Slate-wide player-prop scan: every matchup simulates with player
    collection and reduces its prop-sheet rows to per-prop scalars ON
    DEVICE (edge.reduce_props_device); all matchups' sim+reduce launches
    are enqueued before any host transfer, so the dispatch pipeline never
    drains (the device-accumulation pattern of simulate_slate_summaries).
    Prop rows are matched to matchups by team name; matchups with no
    matching rows are skipped entirely (no simulation).

    shard=True shards each matchup's trial axis over the full mesh
    (MatchupRunner(shard=True) -> parallel.simulate_games_sharded); the
    prop reduction jit consumes the trial-sharded pstats directly and
    GSPMD inserts the cross-device sums.

    The reference scans one matchup's props at a time from its saved
    players file (edge_finder.py scan_props_for_matchup :340-390 inside
    find_edges :586-614); this runs that scan across the week's sheet with
    zero files.  Index arrays are padded (edge.resolve_prop_rows) so the
    reduction compiles once per padded size, not per matchup.

    Returns the scan_props_for_matchup schema + edge/EV columns with a
    leading `matchup` column, best edges first across the whole slate."""
    from .edge import (
        prop_table_from_reductions, reduce_props_device, resolve_prop_rows,
    )

    cfg = cfg or SimConfig()
    heads = load_heads(artifact_dir)
    sp_df = load_sp_flex(sp_path)
    # a path (the CLI / reference-workflow shape) or an already-built
    # frame (the serving layer posts prop rows inline)
    props = props_csv if isinstance(props_csv, pd.DataFrame) \
        else pd.read_csv(props_csv)
    if shard:
        # each launch splits 2*n_pairs games across the mesh; round up to
        # a device multiple so arbitrary -n values don't trip the
        # divisibility check (prop scans consume only reductions, so a
        # few extra games are the documented whole-launch round-up)
        ndev = jax.device_count()
        n_pairs = -(-n_pairs // ndev) * ndev
    root = jax.random.PRNGKey(seed)
    pending = []
    for gi, (ta, tb) in enumerate(games):
        a = build_team_context_from_sp_flex(
            ta, year, week, sp_df, focus_csv=focus_csv,
            player_slots=cfg.engine.player_slots)
        b = build_team_context_from_sp_flex(
            tb, year, week, sp_df, focus_csv=focus_csv,
            player_slots=cfg.engine.player_slots)
        indices, meta = resolve_prop_rows(a, b, props)
        if not meta:
            continue
        runner = _runner_for(a, b, heads, cfg, mode, table_quality, shard)
        out = runner.run_pairs(n_pairs, key=jax.random.fold_in(root, gi),
                               collect_players=True, block=False)
        pending.append((ta, tb, meta,
                        reduce_props_device(out.pstats, indices)))
    if not pending:
        return pd.DataFrame()
    # batch the readback: pack each matchup's 8 reduction fields into one
    # (8, P) device array, stack matchups sharing a padded P, and transfer
    # one array per group — per-field np.asarray readbacks would each
    # synchronize (~60x8 for a weekly slate)
    fields = sorted(pending[0][3])
    packed = [jnp.stack([red[k] for k in fields]) for *_, red in pending]
    by_p: Dict[int, list] = {}
    for i, p in enumerate(packed):
        by_p.setdefault(p.shape[1], []).append(i)
    host_packed: Dict[int, np.ndarray] = {}
    for pw, idxs in by_p.items():
        arr = np.asarray(jnp.stack([packed[i] for i in idxs]))
        for j, i in enumerate(idxs):
            host_packed[i] = arr[j]
    frames = []
    for i, (ta, tb, meta, _red) in enumerate(pending):
        host = dict(zip(fields, host_packed[i]))
        df = prop_table_from_reductions(meta, host, min_abs_edge_pct)
        if not df.empty:
            df.insert(0, "matchup", f"{ta} vs {tb}")
            frames.append(df)
    if not frames:
        return pd.DataFrame()
    out_df = pd.concat(frames, ignore_index=True)
    order = out_df["edge_pct"].abs().sort_values(ascending=False).index
    return out_df.loc[order].reset_index(drop=True)
