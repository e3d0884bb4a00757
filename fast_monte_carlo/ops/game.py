"""The game engine: one fused, branchless play step under `lax.scan`.

The reference's per-game `while` loop with ~12 mutually exclusive outcome
paths (fast_monte_carlo_cfb.py:1026-1257, 1382-1421, 1447-1451) becomes a
fixed-length scan over MAX_PLAYS steps, vectorized over a batch of trials.
Every step computes all outcome paths for all trials and combines them with
masks; finished games (seconds == 0) no-op through the remaining steps.

Update ordering replicates the reference exactly (it matters around the
halftime flip inside tick_clock, :956-968):

  phase a (pre-tick):  advance_down / down+1 / sack spot math / INT or
                       turnover-on-downs possession flips
  phase b (tick):      clock decrement; halftime possession flip to the 75
  phase c (post-tick): kickoff/FG/punt possession flips

so e.g. a TD that ticks across halftime flips twice and the scoring team
keeps the ball at its 25 — same as the reference.

RNG is counter-based: one key per scan step (threefry or rbg,
EngineConfig.rng_impl), split into a uniform
block and a normal block; mutually exclusive outcome paths share draws
(pass/run/sack yardage normals, explosive/RZ gates), so a play consumes a
fixed 13 uniforms + 4 normals regardless of its branch.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..models import analytic
from ..models.heads import ST1_FEATURES
from ..stats import (
    N_PLAYER_STATS, N_TEAM_STATS, ROLE_PASS, ROLE_REC, ROLE_RUSH, TS,
)
from .forest_eval import predict
from .pack import HeadsPack, MatchupPack

F32 = jnp.float32
I32 = jnp.int32

# uniform draw slots (shared across exclusive branches)
U_GO, U_FG, U_TB, U_CALL, U_QB, U_WR, U_RB, U_COMPLETE, U_EXP, U_BOOST, \
    U_RZ, U_S2, U_FUM = range(13)
N_UNIFORMS = 13
# normal draw slots
N_PUNT_GROSS, N_PUNT_RET, N_YARDS, N_INT_RET = range(4)
N_NORMALS = 4


class GameState(NamedTuple):
    gid: jnp.ndarray      # (B,) i32 game (matchup) id — constant per trial
    fo: jnp.ndarray       # (B,) i32 first offense side — constant per trial
    off: jnp.ndarray      # (B,) i32 offense side 0/1
    sec: jnp.ndarray      # (B,) i32
    down: jnp.ndarray     # (B,) i32
    dist: jnp.ndarray     # (B,) f32
    ytg: jnp.ndarray      # (B,) f32
    period: jnp.ndarray   # (B,) i32
    in_rz: jnp.ndarray    # (B,) bool
    going: jnp.ndarray    # (B,) bool
    score: jnp.ndarray    # (B,2) i32
    stats: jnp.ndarray    # (B,2,N_TEAM_STATS) f32
    pstats: jnp.ndarray   # (B,2,3,K,6) f32


class StepObs(NamedTuple):
    """What a heads-eval implementation sees: play-start state + sampled slots.

    `x` (the 17-col ST1 feature stack) is only materialized for heads that
    declare `needs_x = True` (the exact compiled-forest path); table and
    analytic heads read the scalar state fields directly — building x costs
    ~20 elementwise passes per step for nothing in those modes."""
    x: Optional[jnp.ndarray]  # (B,17) ST1 feature rows, or None
    sd: jnp.ndarray       # (B,) f32 score_diff from the offense's view
    dirx: jnp.ndarray     # (B,) i32 direction row = gid*2 + off
    off: jnp.ndarray      # (B,) i32
    down: jnp.ndarray
    dist: jnp.ndarray
    ytg: jnp.ndarray
    sec: jnp.ndarray
    qb: jnp.ndarray       # (B,) i32 slot
    wr: jnp.ndarray
    rb: jnp.ndarray


class HeadOut(NamedTuple):
    """Final (fully post-processed) model quantities for one play step.

    Implementations bake in all deterministic transforms: stage1 matchup
    bias + clip, the stage-2 nudge (+ cumulative form), and quantile ->
    (mu, sigma) with sigma floors.  The play step consumes these directly.
    """
    p_complete: jnp.ndarray       # (B,) biased + clipped completion prob
    s2_cum: jnp.ndarray           # (B,2) post-nudge cumulative (P(inc), P(inc)+P(sack))
    pass_ms: jnp.ndarray          # (B,2) (mu, sigma) pass yards
    rush_ms: jnp.ndarray          # (B,2)
    sack_ms: jnp.ndarray          # (B,2)
    p_fumble: jnp.ndarray         # (B,)
    p_pass_ml: Optional[jnp.ndarray]  # (B,) or None if no ML policy


# heads_fn(heads_state, obs, pack) -> HeadOut.  heads_state is a pytree of
# device arrays (forests or tables) passed through jit as an ARGUMENT —
# never close over large arrays or they become jaxpr constants and blow up
# compile time.
HeadsEvalFn = Callable[[object, StepObs, MatchupPack], HeadOut]


def _gather2k(arr2k: jnp.ndarray, off: jnp.ndarray, slot: jnp.ndarray) -> jnp.ndarray:
    """arr (2,K) gathered at (off, slot) per trial."""
    k = arr2k.shape[1]
    return jnp.take(arr2k.reshape(-1), off * k + slot, mode="clip")


def _taper(y: jnp.ndarray, t1: float, t2: float, r1: float, r2: float):
    """mc-variant piecewise-linear long-gain taper (monte_carlo_cfb.py:470,
    482; definition fast_monte_carlo_cfb.py:133-145): unchanged to t1,
    slope r1 to t2, slope r2 beyond."""
    mid = t1 + (y - t1) * r1
    hi = t1 + (t2 - t1) * r1 + (y - t2) * r2
    return jnp.where(y <= t1, y, jnp.where(y <= t2, mid, hi))


def take_dir(t: jnp.ndarray, dirx: jnp.ndarray) -> jnp.ndarray:
    """Per-direction constant fetch.

    On the earlier chip a (B,)-indexed jnp.take paid a per-row gather
    latency regardless of table size, so tiny first-axis tables lower to a
    masked-sum select chain instead (~2 elementwise passes per row); not
    yet measured on the GPU.  Larger slates fall back to one real gather."""
    n = t.shape[0]
    if n <= 8:
        out = None
        for i in range(n):
            g = (dirx == i).astype(t.dtype)
            term = g * t[i] if t.ndim == 1 else g[:, None] * t[i]
            out = term if out is None else out + term
        return out
    return jnp.take(t, dirx, axis=0, mode="clip")


def make_exact_heads_eval(cfg: SimConfig) -> HeadsEvalFn:
    """Exact mode: full compiled-forest evaluation per play step.
    heads_state is a HeadsPack.  With cfg.engine.exact_merged (and a pack
    carrying a MergedForest) all heads' trees walk as ONE (B, T_total)
    front; the default is the per-forest walk — see the
    EngineConfig.exact_merged note (total gathered rows are the same
    either way)."""

    def heads_eval(hp: HeadsPack, obs: StepObs, pack: MatchupPack) -> HeadOut:
        if hp.merged is not None and cfg.engine.exact_merged:
            return _merged_exact_eval(hp, obs, pack, cfg)
        x, off, qb, wr, rb = obs.x, obs.dirx, obs.qb, obs.wr, obs.rb
        p_raw = predict(hp.stage1, x, {"passer_name": _gather2k(pack.ids_qb_stage1, off, qb)})
        p_c = jnp.clip(p_raw + jnp.take(pack.bias, off, mode="clip"),
                       cfg.model.stage1_clip_lo, cfg.model.stage1_clip_hi)
        if hp.stage2 is not None:
            probs = predict(hp.stage2, x, {
                "passer_name": _gather2k(pack.ids_qb_stage2, off, qb),
                "target_name": _gather2k(pack.ids_wr_stage2, off, wr),
            })
            o = hp.stage2_order
            inc, itc, sck = probs[:, o[0]], probs[:, o[1]], probs[:, o[2]]
        else:
            inc, itc, sck = analytic.stage2_fallback_probs(
                obs.down.astype(F32), obs.dist, cfg, jnp)
        inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg, jnp)
        s2_cum = jnp.stack([inc, inc + sck], axis=1)

        def ms(trio, cat, floor):
            q = jnp.stack([predict(f, x, cat) for f in trio], axis=1)
            sigma = jnp.maximum(floor, (q[:, 2] - q[:, 0]) / cfg.model.sigma_denom)
            return jnp.stack([q[:, 1], sigma], axis=1)

        pass_ms = ms(hp.pq, {"passer_name": _gather2k(pack.ids_qb_passq, off, qb),
                             "target_name": _gather2k(pack.ids_wr_passq, off, wr)},
                     cfg.model.pass_sigma_floor)
        rush_ms = ms(hp.rq, {"rusher_name": _gather2k(pack.ids_rb_rushq, off, rb)},
                     cfg.model.rush_sigma_floor)
        sack_ms = ms(hp.sq, {"passer_name": _gather2k(pack.ids_qb_sackq, off, qb)},
                     cfg.model.sack_sigma_floor)
        if hp.fumble is not None and cfg.model.enable_fumbles:
            p_f = predict(hp.fumble, x, {"rusher_name": _gather2k(pack.ids_rb_fumble, off, rb)})
        else:
            p_f = jnp.zeros_like(p_c)
        p_pass_ml = None
        if hp.play is not None and cfg.model.use_play_model:
            p_pass_ml = _play_pass_prob(hp, x, jnp.take(pack.coach_id, off, mode="clip"), cfg)
        return HeadOut(p_c, s2_cum, pass_ms, rush_ms, sack_ms, p_f, p_pass_ml)

    heads_eval.needs_x = True  # full ST1 feature rows feed the forests
    return heads_eval


def _merged_exact_eval(hp: HeadsPack, obs: StepObs, pack: MatchupPack,
                       cfg: SimConfig) -> HeadOut:
    """Exact heads via the one-walk MergedForest; outputs match the
    per-forest path to fp tolerance (same leaves; the class matmul reorders
    the per-tree sum)."""
    from .forest_eval import eval_merged

    mf = hp.merged
    x, off, qb, wr, rb = obs.x, obs.dirx, obs.qb, obs.wr, obs.rb
    sources = {
        "qb_stage1": lambda: _gather2k(pack.ids_qb_stage1, off, qb),
        "qb_stage2": lambda: _gather2k(pack.ids_qb_stage2, off, qb),
        "wr_stage2": lambda: _gather2k(pack.ids_wr_stage2, off, wr),
        "qb_passq": lambda: _gather2k(pack.ids_qb_passq, off, qb),
        "wr_passq": lambda: _gather2k(pack.ids_wr_passq, off, wr),
        "rb_rushq": lambda: _gather2k(pack.ids_rb_rushq, off, rb),
        "qb_sackq": lambda: _gather2k(pack.ids_qb_sackq, off, qb),
        "rb_fumble": lambda: _gather2k(pack.ids_rb_fumble, off, rb),
        "coach": lambda: take_dir(pack.coach_id, off),
    }
    cid = jnp.stack([sources[c]().astype(I32) for c in mf.cat_cols], axis=1)
    margins = eval_merged(mf, x, cid)
    cols = {name: (cb, nc) for name, cb, nc in mf.slices}

    def m_of(name):
        cb, nc = cols[name]
        return margins[:, cb:cb + nc]

    p_c = jnp.clip(jax.nn.sigmoid(m_of("stage1")[:, 0])
                   + take_dir(pack.bias, off),
                   cfg.model.stage1_clip_lo, cfg.model.stage1_clip_hi)
    if "stage2" in cols:
        probs = jax.nn.softmax(m_of("stage2"), axis=1)
        o = hp.stage2_order
        inc, itc, sck = probs[:, o[0]], probs[:, o[1]], probs[:, o[2]]
    else:
        inc, itc, sck = analytic.stage2_fallback_probs(
            obs.down.astype(F32), obs.dist, cfg, jnp)
    inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg, jnp)
    s2_cum = jnp.stack([inc, inc + sck], axis=1)

    def ms(prefix, floor):
        q10 = m_of(f"{prefix}0")[:, 0]
        q50 = m_of(f"{prefix}1")[:, 0]
        q90 = m_of(f"{prefix}2")[:, 0]
        sigma = jnp.maximum(floor, (q90 - q10) / cfg.model.sigma_denom)
        return jnp.stack([q50, sigma], axis=1)

    pass_ms = ms("pq", cfg.model.pass_sigma_floor)
    rush_ms = ms("rq", cfg.model.rush_sigma_floor)
    sack_ms = ms("sq", cfg.model.sack_sigma_floor)
    if "fumble" in cols and cfg.model.enable_fumbles:
        p_f = jax.nn.sigmoid(m_of("fumble")[:, 0])
    else:
        p_f = jnp.zeros_like(p_c)
    p_pass_ml = None
    if "play" in cols and cfg.model.use_play_model:
        z = m_of("play") / max(1e-6, hp.play_temperature)
        p = jax.nn.softmax(z, axis=1)
        p_pass = p[:, hp.play_pass_idx]
        if hp.play_run_idx >= 0:
            p_run = p[:, hp.play_run_idx]
            p_pass = p_pass / jnp.maximum(1e-9, p_pass + p_run)
        p_pass_ml = jnp.clip(p_pass, cfg.model.play_clip_lo,
                             cfg.model.play_clip_hi)
    return HeadOut(p_c, s2_cum, pass_ms, rush_ms, sack_ms, p_f, p_pass_ml)


def make_analytic_heads_eval(cfg: SimConfig) -> HeadsEvalFn:
    """Artifact-free heads: smooth closed-form stand-ins for every model
    head.  Lets the full engine run with no trained artifacts at all (and
    keeps multi-device tests fast); clearly NOT the reference models.
    heads_state is unused (pass None)."""

    def heads_eval(heads_state, obs: StepObs, pack: MatchupPack) -> HeadOut:
        bias = take_dir(pack.bias, obs.dirx)
        p_c = jnp.clip(
            0.68 - 0.022 * jnp.maximum(0.0, obs.dist - 3.0) + bias,
            cfg.model.stage1_clip_lo, cfg.model.stage1_clip_hi)
        inc, itc, sck = analytic.stage2_fallback_probs(
            obs.down.astype(F32), obs.dist, cfg, jnp)
        inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg, jnp)
        s2_cum = jnp.stack([inc, inc + sck], axis=1)
        b = obs.dist.shape[0]
        pass_mu = 4.5 + 0.45 * obs.dist
        pass_ms = jnp.stack([pass_mu, jnp.full((b,), 7.0, F32)], axis=1)
        rush_ms = jnp.stack([jnp.full((b,), 4.2, F32), jnp.full((b,), 4.0, F32)], axis=1)
        sack_ms = jnp.stack([jnp.full((b,), -6.0, F32), jnp.full((b,), 2.2, F32)], axis=1)
        return HeadOut(p_c, s2_cum, pass_ms, rush_ms, sack_ms,
                       jnp.full((b,), 0.012, F32), None)

    heads_eval.needs_x = False
    return heads_eval


def _play_pass_prob(hp: HeadsPack, x: jnp.ndarray, coach: jnp.ndarray, cfg: SimConfig):
    from .forest_eval import eval_margin
    jf = hp.play
    cols = [ST1_FEATURES.index(n) for n in jf.numeric_names]
    xp = x[:, cols]
    m = eval_margin(jf, xp, {"head_coach": coach})
    z = m / max(1e-6, hp.play_temperature)
    p = jax.nn.softmax(z, axis=1)
    p_pass = p[:, hp.play_pass_idx]
    if hp.play_run_idx >= 0:
        p_run = p[:, hp.play_run_idx]
        p_pass = p_pass / jnp.maximum(1e-9, p_pass + p_run)
    return jnp.clip(p_pass, cfg.model.play_clip_lo, cfg.model.play_clip_hi)


def _sample_slot(cum2k: jnp.ndarray, off: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Inverse-CDF slot sampling against (2,K) cumulative shares."""
    if cum2k.shape[1] == 1:  # single slot: no draw needed (and no gather)
        return jnp.zeros(off.shape, I32)
    cum = take_dir(cum2k, off)   # (B,K)
    slot = jnp.sum(u[:, None] >= cum, axis=1)
    return jnp.minimum(slot, cum2k.shape[1] - 1).astype(I32)


def _state_features(pack: MatchupPack, cfg: SimConfig, dirx, down, dist, ytg, sec, sd):
    half_s = cfg.clock.half_seconds
    sec_f = sec.astype(F32)
    sp = jnp.take(pack.sp, dirx, axis=0, mode="clip")  # (B,4)
    cols = [
        down.astype(F32), dist, ytg,
        (ytg <= 20).astype(F32),
        sd.astype(F32), sec_f,
        jnp.full_like(sec_f, cfg.timeouts), jnp.full_like(sec_f, cfg.timeouts),
        sp[:, 0], sp[:, 1], sp[:, 2], sp[:, 3],
        (dist >= ytg - 0.5).astype(F32),
        ((down == 4) & (dist <= 2.0)).astype(F32),
        (ytg <= 33).astype(F32),
        jnp.where(sec > half_s, 1.0, 2.0),
        ((sec % half_s) <= 120).astype(F32),
    ]
    return jnp.stack(cols, axis=1)


def play_step(
    s: GameState,
    key: jnp.ndarray,
    pack: MatchupPack,
    cfg: SimConfig,
    heads_eval: HeadsEvalFn,
    heads_state,
    collect_players: bool,
    collect_stats: bool = True,
) -> GameState:
    B = s.off.shape[0]
    # antithetic pairing (EngineConfig.antithetic): rows 4k+2, 4k+3 reuse
    # rows 4k, 4k+1's draws mirrored (u -> 1-u, n -> -n).  Partner offset 2
    # keeps each pair on the same matchup AND first-offense direction under
    # the standard layouts (fo = arange % 2, per-game gid blocks), so pair
    # outcomes correlate negatively.  Needs B % 4 == 0 (off otherwise).
    anti = cfg.engine.antithetic and B % 4 == 0
    Bd = B // 2 if anti else B
    ku, kn = jax.random.split(key)
    u = jax.random.uniform(ku, (Bd, N_UNIFORMS))
    n = jax.random.normal(kn, (Bd, N_NORMALS))
    if anti:
        def _mirror(a, flip):
            f = a.reshape(B // 4, 2, a.shape[-1])
            return jnp.concatenate([f, flip(f)], axis=1).reshape(B, -1)
        u = _mirror(u, lambda f: 1.0 - f)
        n = _mirror(n, lambda f: -f)

    active = s.sec > 0
    off, down0, dist0, ytg0, sec0 = s.off, s.down, s.dist, s.ytg, s.sec
    dirx = s.gid * 2 + off   # row into the (2G, ...) direction-indexed pack
    # score from the offense's view: arithmetic select (take_along_axis is a
    # real gather, see take_dir)
    sd = (s.score[:, 0] - s.score[:, 1]) * (1 - 2 * off)

    off_o = take_dir(pack.off_offense, dirx)
    def_d = take_dir(pack.def_defense, dirx)
    ymult = take_dir(pack.ymult, dirx)
    mz = take_dir(pack.mz, dirx)

    # ---- 4th-down decision --------------------------------------------------
    p_go = jnp.minimum(1.0, analytic.go_for_it_prob(
        ytg0, dist0, sd, sec0, cfg, jnp) * cfg.fourth.go_multiplier)
    is4 = down0 == 4
    if cfg.fourth.force is None:
        go = active & is4 & (u[:, U_GO] < p_go)
        st_play = active & is4 & ~go
        fg_att = st_play & (ytg0 <= cfg.st.fg_attempt_max_ytg)
        punt = st_play & ~fg_att
    else:
        # static decision override (FourthDownConfig.force) — used by the
        # 4th-down evaluator's forced FIRST play only; a Python branch, so
        # the default (None) program is unchanged.  Draw consumption is
        # identical either way (u columns are always generated), so forcing
        # never shifts another branch's stream.
        no = jnp.zeros_like(is4)
        if cfg.fourth.force == "go":
            go, st_play, fg_att, punt = active & is4, no, no, no
        elif cfg.fourth.force == "fg":
            go, st_play = no, active & is4
            fg_att, punt = st_play, no
        elif cfg.fourth.force == "punt":
            go, st_play = no, active & is4
            fg_att, punt = no, st_play
        else:
            raise ValueError(
                f"fourth.force must be None|'go'|'fg'|'punt', "
                f"got {cfg.fourth.force!r}")
    scrim = active & ~st_play
    was_going = go  # going_for_it is only ever true on the go play itself

    # FG
    p_fg = analytic.field_goal_prob(ytg0 + cfg.st.fg_snap_plus_endzone, cfg, jnp)
    fg_good = fg_att & (u[:, U_FG] < p_fg)
    fg_miss = fg_att & ~fg_good

    # punt
    gross = jnp.maximum(cfg.st.punt_gross_min,
                        cfg.st.punt_gross_mean + cfg.st.punt_gross_sd * n[:, N_PUNT_GROSS])
    pret = jnp.maximum(0.0, cfg.st.punt_return_mean + cfg.st.punt_return_sd * n[:, N_PUNT_RET])
    net = gross - pret
    tb_p = jnp.clip((cfg.st.punt_touchback_gate_ytg - ytg0) / 60.0,
                    cfg.st.punt_tb_lo, cfg.st.punt_tb_hi)
    tb = (ytg0 <= cfg.st.punt_touchback_gate_ytg) & (u[:, U_TB] < tb_p)
    net = jnp.where(tb, ytg0 - cfg.st.punt_tb_own_spot, net)
    net = jnp.trunc(jnp.clip(net, cfg.st.punt_net_min, ytg0 - 1.0))  # int() per :896
    punt_spot = jnp.clip(100.0 - (ytg0 - net), 1.0, 99.0)

    # ---- scrimmage play -----------------------------------------------------
    trip1 = scrim & ~s.in_rz & (ytg0 <= 20)

    x = (_state_features(pack, cfg, dirx, down0, dist0, ytg0, sec0, sd)
         if getattr(heads_eval, "needs_x", True) else None)
    qb = _sample_slot(pack.qb_cum, dirx, u[:, U_QB])
    wr = _sample_slot(pack.wr_cum, dirx, u[:, U_WR])
    rb = _sample_slot(pack.rb_cum, dirx, u[:, U_RB])
    obs = StepObs(x=x, sd=sd.astype(F32), dirx=dirx, off=off, down=down0,
                  dist=dist0, ytg=ytg0, sec=sec0, qb=qb, wr=wr, rb=rb)
    ho = heads_eval(heads_state, obs, pack)

    if cfg.model.use_play_model and ho.p_pass_ml is not None:
        p_pass = ho.p_pass_ml
    else:
        p_pass = analytic.pass_prob_v1(down0, dist0, ytg0, sec0, sd, cfg, jnp)
    is_pass = scrim & (u[:, U_CALL] < p_pass)
    is_run = scrim & ~is_pass

    complete = is_pass & (u[:, U_COMPLETE] < ho.p_complete)
    notc = is_pass & ~complete

    u2 = u[:, U_S2]
    o_inc = notc & (u2 < ho.s2_cum[:, 0])
    o_sck = notc & ~o_inc & (u2 < ho.s2_cum[:, 1])
    o_int = notc & ~o_inc & ~o_sck

    # pass yards (quirk: clip to ytg BEFORE the SP+ multiplier, :1091)
    pass_mu, pass_sg = ho.pass_ms[:, 0], ho.pass_ms[:, 1]
    if cfg.model.rz_pass_damping:
        # mc-variant goal-line damping (monte_carlo_cfb.py:462-464): scale
        # the quantiles, then re-floor sigma
        rz_scale = jnp.where(ytg0 < 15.0, 0.8 + 0.2 * (ytg0 / 15.0), 1.0)
        pass_mu = pass_mu * rz_scale
        pass_sg = jnp.maximum(cfg.model.pass_sigma_floor, pass_sg * rz_scale)
    py_raw = pass_mu + pass_sg * n[:, N_YARDS]
    if cfg.model.taper_enabled:
        py_raw = _taper(py_raw, *cfg.model.pass_taper)
    py = jnp.clip(py_raw, cfg.model.pass_clip_lo, ytg0)
    yards_p = py * ymult
    ep = analytic.explosive_prob(ytg0, off_o, def_d, cfg, jnp)
    exp_gate_p = (ytg0 > cfg.matchup.explosive_gate_ytg) & \
        (u[:, U_EXP] < cfg.matchup.explosive_pass_scale * ep)
    boost_p = cfg.matchup.explosive_pass_boost_lo + u[:, U_BOOST] * (
        cfg.matchup.explosive_pass_boost_hi - cfg.matchup.explosive_pass_boost_lo)
    yards_p = jnp.where(
        exp_gate_p,
        jnp.minimum(yards_p * (1.0 + boost_p * (1.0 + cfg.matchup.explosive_pass_z_k * mz)), ytg0),
        yards_p)
    rz_p = (ytg0 <= cfg.matchup.rz_pass_gate_ytg) & (down0 <= 3) & (
        u[:, U_RZ] < analytic.rz_finish_prob_pass(ytg0, down0, off_o, def_d, cfg, jnp))
    yards_p = jnp.where(rz_p, ytg0, yards_p)
    pass_td = complete & (yards_p + 1e-9 >= ytg0)
    pass_gain = complete & ~pass_td

    # sack loss
    sy = jnp.clip(ho.sack_ms[:, 0] + ho.sack_ms[:, 1] * n[:, N_YARDS],
                  cfg.model.sack_clip_lo, cfg.model.sack_clip_hi)
    loss = jnp.minimum(jnp.maximum(0.0, -sy), ytg0)  # quirk: cap = ytg (:1178)

    # INT return
    ret = jnp.clip(cfg.model.int_return_mean + cfg.model.int_return_sd * n[:, N_INT_RET],
                   0.0, ytg0)
    int_spot = 100.0 - (ytg0 - ret)

    # rush yards (same structure)
    ry_raw = ho.rush_ms[:, 0] + ho.rush_ms[:, 1] * n[:, N_YARDS]
    if cfg.model.taper_enabled:
        ry_raw = _taper(ry_raw, *cfg.model.rush_taper)
    ry = jnp.clip(ry_raw, cfg.model.rush_clip_lo, ytg0)
    yards_r = ry * ymult
    exp_gate_r = (ytg0 > cfg.matchup.explosive_gate_ytg) & \
        (u[:, U_EXP] < cfg.matchup.explosive_run_scale * ep)
    boost_r = cfg.matchup.explosive_run_boost_lo + u[:, U_BOOST] * (
        cfg.matchup.explosive_run_boost_hi - cfg.matchup.explosive_run_boost_lo)
    yards_r = jnp.where(
        exp_gate_r,
        jnp.minimum(yards_r * (1.0 + boost_r * (1.0 + cfg.matchup.explosive_run_z_k * mz)), ytg0),
        yards_r)
    rz_r = (ytg0 <= cfg.matchup.rz_run_gate_ytg) & (down0 <= 3) & (
        u[:, U_RZ] < analytic.rz_finish_prob_run(ytg0, down0, off_o, def_d, cfg, jnp))
    yards_r = jnp.where(rz_r, ytg0, yards_r)

    fum = is_run & (u[:, U_FUM] < ho.p_fumble) if cfg.model.enable_fumbles \
        else jnp.zeros_like(is_run)
    run_active = is_run & ~fum
    run_td = run_active & (yards_r + 1e-9 >= ytg0)
    run_gain = run_active & ~run_td
    fum_spot_ytg = jnp.maximum(0.0, ytg0 - jnp.clip(yards_r, cfg.model.rush_clip_lo, ytg0))

    # ---- phase a: pre-tick state updates ------------------------------------
    adv = pass_gain | run_gain
    gained = jnp.where(pass_gain, yards_p, 0.0) + jnp.where(run_gain, yards_r, 0.0)
    ytg_a = jnp.where(adv, jnp.maximum(0.0, ytg0 - gained), ytg0)
    first = adv & (gained + 1e-6 >= dist0)
    down_a = jnp.where(adv, jnp.where(first, 1, down0 + 1), down0)
    dist_a = jnp.where(adv, jnp.where(first, 10.0, dist0 - gained), dist0)
    downs_to = adv & ~first & (down_a > 4)

    ytg_a = jnp.where(o_sck, ytg0 + loss, ytg_a)
    dist_a = jnp.where(o_sck, dist0 + loss, dist_a)
    down_a = jnp.where(o_sck, down0 + 1, down_a)
    down_a = jnp.where(o_inc, down0 + 1, down_a)

    flip_a = downs_to | o_int | fum
    spot_a = jnp.where(o_int, int_spot,
                       jnp.where(fum, 100.0 - fum_spot_ytg, 100.0 - ytg_a))
    off_a = jnp.where(flip_a, 1 - off, off)
    ytg_a = jnp.where(flip_a, spot_a, ytg_a)
    down_a = jnp.where(flip_a, 1, down_a)
    dist_a = jnp.where(flip_a, 10.0, dist_a)
    in_rz_a = jnp.where(flip_a, False, s.in_rz | trip1)

    # ---- phase b: tick (+ halftime flip) ------------------------------------
    c = cfg.clock
    t = (fg_att * c.field_goal + punt * c.punt + pass_td * c.td_pass
         + pass_gain * c.pass_complete + o_inc * c.pass_incomplete
         + o_sck * c.sack + o_int * c.interception
         + (run_td | run_gain | fum) * c.run).astype(I32)
    sec_b = jnp.maximum(0, sec0 - t)
    period_b = jnp.where(sec_b > 0, 4 - ((sec_b - 1) // c.quarter_seconds), 4).astype(I32)
    halftime = active & (period_b != s.period) & (period_b == 3)
    off_b = jnp.where(halftime, 1 - off_a, off_a)
    ytg_b = jnp.where(halftime, cfg.kickoff_spot, ytg_a)
    down_b = jnp.where(halftime, 1, down_a)
    dist_b = jnp.where(halftime, 10.0, dist_a)
    in_rz_b = jnp.where(halftime, False, in_rz_a)

    # ---- phase c: post-tick possession flips --------------------------------
    flip_c = fg_good | fg_miss | punt | pass_td | run_td
    spot_c = jnp.where(fg_miss, 100.0 - ytg0,
                       jnp.where(punt, punt_spot, cfg.kickoff_spot))
    off_c = jnp.where(flip_c, 1 - off_b, off_b)
    ytg_c = jnp.where(flip_c, spot_c, ytg_b)
    down_c = jnp.where(flip_c, 1, down_b)
    dist_c = jnp.where(flip_c, 10.0, dist_b)
    in_rz_c = jnp.where(flip_c, False, in_rz_b)

    # run-branch red-zone recheck (quirk: old offense credited, :1253-1255)
    trip2 = run_gain & ~in_rz_c & (ytg_c <= 20)
    in_rz_f = in_rz_c | trip2

    going_f = jnp.where(active, False, s.going)

    # ---- scores --------------------------------------------------------------
    td = pass_td | run_td
    pts = td * cfg.model.td_points + fg_good * cfg.model.fg_points
    oh_side = jax.nn.one_hot(off, 2, dtype=I32)
    score_f = s.score + oh_side * pts[:, None]

    # ---- team stats -----------------------------------------------------------
    # one stacked delta (chained .at[].add would copy the whole (B,N) array
    # per field: ~20x the HBM traffic).  Score-only workloads (edge scans,
    # calibration sweeps) skip the whole block via collect_stats=False.
    if not collect_stats:
        stats_f = s.stats
    else:
      conv = (td & was_going) \
          | (pass_gain & was_going & (yards_p + 1e-6 >= dist0)) \
          | (run_gain & was_going & (yards_r + 1e-6 >= dist0))
      zeros = jnp.zeros((B,), F32)
      cols = {
          "plays": scrim.astype(F32),
          "pass_att": (complete | o_inc | o_int).astype(F32),
          "comp": complete.astype(F32),
          "pass_yds": jnp.where(pass_td, ytg0, jnp.where(pass_gain, yards_p, 0.0)),
          "pass_td": pass_td.astype(F32),
          "INT": o_int.astype(F32),
          "sacks": o_sck.astype(F32),
          "rush_att": is_run.astype(F32),
          "rush_yds": jnp.where(run_td, ytg0, jnp.where(run_gain, yards_r, 0.0)),
          "rush_td": run_td.astype(F32),
          "FG": fg_good.astype(F32),
          "FGA": fg_att.astype(F32),
          "punts": punt.astype(F32),
          "rz_trips": trip1.astype(F32) + trip2.astype(F32),
          "rz_TD": (run_td & (ytg0 <= 20)).astype(F32),  # quirk: rushing TDs only (:1237)
          "fourth_go": go.astype(F32),
          "fourth_conv": conv.astype(F32),
          "points": zeros,  # final score written after the scan
          "fumbles_lost": fum.astype(F32),
      }
      from ..stats import TEAM_STAT_FIELDS
      ds = jnp.stack([cols[name] for name in TEAM_STAT_FIELDS], axis=1)
      stats_f = s.stats + oh_side.astype(F32)[:, :, None] * ds[:, None, :]

    # ---- player stats ----------------------------------------------------------
    pstats_f = s.pstats
    if collect_players:
        K = pack.k
        team_pass_yds = jnp.where(pass_td, ytg0, jnp.where(pass_gain, yards_p, 0.0))
        qb_delta = jnp.stack([
            (complete | o_inc | o_int).astype(F32), complete.astype(F32),
            team_pass_yds, pass_td.astype(F32), o_int.astype(F32), o_sck.astype(F32),
        ], axis=1)
        wr_delta = jnp.stack([
            is_pass.astype(F32), complete.astype(F32),
            team_pass_yds, pass_td.astype(F32),
            jnp.zeros((B,), F32), jnp.zeros((B,), F32),
        ], axis=1)
        rb_delta = jnp.stack([
            is_run.astype(F32), jnp.zeros((B,), F32),
            jnp.where(run_td, ytg0, jnp.where(run_gain, yards_r, 0.0)),
            run_td.astype(F32), jnp.zeros((B,), F32), jnp.zeros((B,), F32),
        ], axis=1)
        oh_f = oh_side.astype(F32)
        role_upds = {}
        for role, slot, delta, tracked in (
            (ROLE_PASS, qb, qb_delta, pack.qb_tracked),
            (ROLE_REC, wr, wr_delta, pack.wr_tracked),
            (ROLE_RUSH, rb, rb_delta, pack.rb_tracked),
        ):
            gate = _gather2k(tracked, dirx, slot).astype(F32)
            oh_slot = jax.nn.one_hot(slot, K, dtype=F32) * gate[:, None]
            # HIGHEST: float32 stays float32 (no TF32 rounding of yards)
            role_upds[role] = jnp.einsum("bs,bk,bc->bskc", oh_f, oh_slot,
                                         delta,
                                         precision=jax.lax.Precision.HIGHEST)
        # single add: chained .at[].add would copy the (B,2,3,K,6) carry per role
        pstats_f = pstats_f + jnp.stack(
            [role_upds[r] for r in (ROLE_PASS, ROLE_RUSH, ROLE_REC)], axis=2)

    return GameState(
        gid=s.gid, fo=s.fo,
        off=off_c.astype(I32), sec=sec_b.astype(I32), down=down_c.astype(I32),
        dist=dist_c.astype(F32), ytg=ytg_c.astype(F32), period=period_b,
        in_rz=in_rz_f, going=going_f, score=score_f, stats=stats_f, pstats=pstats_f,
    )


class Situation(NamedTuple):
    """A mid-game state to resume simulation from (live win probability).

    Each field is a scalar — a Python number or a traced/device jnp scalar
    — or a per-trial (n,) array (the batched live curve resumes different
    trials from different situations in one launch).  Serving passes
    DEVICE values so one compiled program prices any live state (the
    situation is a runtime input, never a recompile key).  The
    reference has no equivalent: its `simulate_game` always starts at the
    opening kickoff (fast_monte_carlo_cfb.py:1428-1436); the fields mirror
    its game-state head (`off/sec/down/dist/ytg` + the score pair) exactly,
    and everything derived (`period`, `in_rz`, `going`) is reconstructed
    with the state machine's own formulas in `state_from_situation`.
    """
    offense: object      # side with the ball: 0 = team A, 1 = team B
    sec: object          # seconds remaining in the game (1..game_seconds)
    down: object         # 1..4
    dist: object         # yards to the first-down marker
    ytg: object          # yards to the opponent's goal line (1..99)
    score_a: object      # current points, team A
    score_b: object      # current points, team B


def state_from_situation(n: int, sit: Situation, cfg: SimConfig, k: int,
                         game_id=0, collect_players: bool = True,
                         collect_stats: bool = True) -> GameState:
    """GameState batch resuming every trial from one mid-game situation.

    Derived fields use the step's own conventions so the first simulated
    play is indistinguishable from the same state reached organically:

    * `period` uses the tick formula (`4 - ((sec-1) // quarter_seconds)`,
      play_step phase b / oracle `_tick`) — initializing it any other way
      could fire a spurious halftime possession flip on the first tick.
    * `in_rz` = (ytg <= 20): a drive already inside the 20 has had its
      red-zone trip counted on the play that entered, so resuming must not
      count a fresh one.  `in_rz` only gates the `rz_trips` stat — scores
      are unaffected either way (trip1/trip2 feed nothing else).
    * `going` = False: the go-for-it decision is made at the top of a
      4th-down play, so a resumed 4th down decides it organically.
    * `fo` records `offense` (possession at resume), keeping scores in
      fixed team-A/B orientation like every other path.

    With the kickoff situation (offense=fo, full clock, 1st-and-opening
    at the kickoff spot) this equals `initial_state` array-for-array —
    tested in tests/test_live.py.
    """
    B = n
    off = jnp.broadcast_to(jnp.asarray(sit.offense, I32), (B,))
    gid = jnp.broadcast_to(jnp.asarray(game_id, I32), (B,))
    sec = jnp.asarray(sit.sec, I32)
    period = jnp.where(
        sec > 0, 4 - ((sec - 1) // cfg.clock.quarter_seconds), 4).astype(I32)
    ytg = jnp.asarray(sit.ytg, F32)
    # axis=-1 so fields may be scalars (one situation for the whole batch)
    # OR (n,) arrays (a different situation per trial — the batched live
    # curve packs S situations x n/S trials into one launch)
    score = jnp.stack([jnp.asarray(sit.score_a, I32),
                       jnp.asarray(sit.score_b, I32)], axis=-1)
    stats_shape = (B, 2, N_TEAM_STATS) if collect_stats else (B, 1, 1)
    pstats_shape = (B, 2, 3, k, N_PLAYER_STATS) if collect_players \
        else (B, 1, 1, 1, 1)
    return GameState(
        gid=gid, fo=off,
        off=off,
        sec=jnp.broadcast_to(sec, (B,)),
        down=jnp.broadcast_to(jnp.asarray(sit.down, I32), (B,)),
        dist=jnp.broadcast_to(jnp.asarray(sit.dist, F32), (B,)),
        ytg=jnp.broadcast_to(ytg, (B,)),
        period=jnp.broadcast_to(period, (B,)),
        in_rz=jnp.broadcast_to(ytg <= 20.0, (B,)),
        going=jnp.zeros((B,), bool),
        score=jnp.broadcast_to(score, (B, 2)),
        stats=jnp.zeros(stats_shape, F32),
        pstats=jnp.zeros(pstats_shape, F32),
    )


def initial_state(n: int, first_offense, cfg: SimConfig, k: int,
                  game_id=0, collect_players: bool = True,
                  collect_stats: bool = True) -> GameState:
    B = n
    fo = jnp.broadcast_to(jnp.asarray(first_offense, I32), (B,))
    gid = jnp.broadcast_to(jnp.asarray(game_id, I32), (B,))
    # disabled collectors carry 1-element dummies: the full pstats array is
    # ~1.15 KB/game (K=8) and OOMs multi-million-game batches if allocated
    # (stats ~152 B/game) — shapes are static per trace so this is free
    stats_shape = (B, 2, N_TEAM_STATS) if collect_stats else (B, 1, 1)
    pstats_shape = (B, 2, 3, k, N_PLAYER_STATS) if collect_players \
        else (B, 1, 1, 1, 1)
    return GameState(
        gid=gid, fo=fo,
        off=fo,
        sec=jnp.full((B,), cfg.clock.game_seconds, I32),
        down=jnp.ones((B,), I32),
        dist=jnp.full((B,), cfg.opening_distance, F32),
        ytg=jnp.full((B,), cfg.kickoff_spot, F32),
        period=jnp.ones((B,), I32),
        in_rz=jnp.zeros((B,), bool),
        going=jnp.zeros((B,), bool),
        score=jnp.zeros((B, 2), I32),
        stats=jnp.zeros(stats_shape, F32),
        pstats=jnp.zeros(pstats_shape, F32),
    )


def simulate_games(
    pack: MatchupPack,
    cfg: SimConfig,
    heads_eval: HeadsEvalFn,
    heads_state,
    key: jnp.ndarray,
    n: int,
    first_offense,
    collect_players: bool = True,
    game_id=0,
    collect_stats: bool = True,
    situation: Optional[Situation] = None,
    init_state: Optional[GameState] = None,
) -> GameState:
    """Run n independent games to completion; returns the final GameState.

    `first_offense` may be a scalar (all trials) or a (n,) array (e.g.
    alternating home/away ordering within one batch).  `game_id` selects
    the matchup per trial when the pack carries a game axis (2G direction
    rows); scalar 0 for a single matchup.  `situation` resumes every trial
    from one mid-game state instead of the opening kickoff (live mode —
    `first_offense` is then ignored; possession comes from the situation,
    and the early-exit loop stops as soon as the shortened games finish);
    its fields may also be (n,) arrays, one situation per trial.
    `init_state` resumes from a fully materialized per-trial GameState
    (the 4th-down evaluator plays one forced play outside, then continues
    here) — it overrides both other initializers and must match n and the
    collect flags' stat shapes.
    """
    if init_state is not None:
        init = init_state
    elif situation is not None:
        init = state_from_situation(n, situation, cfg, pack.k, game_id,
                                    collect_players, collect_stats)
    else:
        init = initial_state(n, first_offense, cfg, pack.k, game_id,
                             collect_players, collect_stats)
    if cfg.engine.rng_impl == "rbg":
        raw = key if jnp.issubdtype(key.dtype, jnp.integer) else jax.random.key_data(key)
        raw = jnp.tile(raw.reshape(-1), 2)[:4].astype(jnp.uint32)
        key = jax.random.wrap_key_data(raw, impl="rbg")

    def step(s, k):
        return play_step(s, k, pack, cfg, heads_eval, heads_state,
                         collect_players, collect_stats), None

    if cfg.engine.early_exit:
        # chunked while_loop: stop as soon as every game in the batch is done
        # (identical semantics — finished games no-op; this only skips steps
        # that would have been all-no-op anyway)
        ch = cfg.engine.play_chunk
        n_chunks = -(-cfg.engine.max_plays // ch)
        unroll = cfg.engine.scan_unroll

        def chunk_scan(s, step0, ch_sz):
            """Advance ch_sz steps from absolute step index step0 (a traced
            i32); draw streams key on the absolute index, so every chunk
            schedule sees the same per-step streams."""
            def chunk_step(s2, j):
                return step(s2, jax.random.fold_in(key, step0 + j))

            s, _ = jax.lax.scan(chunk_step, s, jnp.arange(ch_sz),
                                unroll=unroll)
            return s

        def phase_loop(state, first_chunk, last_chunk, base_step, ch_sz):
            """while_loop over chunks [first_chunk, last_chunk) of ch_sz
            steps, stopping early once every game is done."""
            def cond(carry):
                s, ci = carry
                return (ci < last_chunk) & jnp.any(s.sec > 0)

            def body(carry):
                s, ci = carry
                return (chunk_scan(s, base_step + ci * ch_sz, ch_sz), ci + 1)

            out, _ = jax.lax.while_loop(
                cond, body, (state, jnp.asarray(first_chunk, I32)))
            return out

        def run_until_done(state, first_chunk):
            return phase_loop(state, first_chunk, n_chunks, 0, ch)

        ca = cfg.engine.compact_after
        if cfg.engine.compact_tail and n >= cfg.engine.compact_min_batch \
                and ca < cfg.engine.max_plays:
            # two-phase tail compaction (opt-in; see the EngineConfig note —
            # with the default workload's tight step-count tail it measured
            # negative on the earlier chip and is off): fixed-length phase to `compact_after`
            # plays, gather the still-active games into a
            # B/compact_cap_frac sub-batch, finish those, scatter back.  A
            # final full-batch early-exit loop guarantees correctness if
            # stragglers exceed the sub-batch (its cond no-ops otherwise).
            # Per-lane RNG streams are positional, so compaction re-keys
            # moved games — distributionally identical, not layout-invariant.
            p1_chunks = ca // ch

            def p1_body(s, ci):
                return chunk_scan(s, ci * ch, ch), None

            state, _ = jax.lax.scan(p1_body, init,
                                    jnp.arange(p1_chunks, dtype=I32))
            m = max(1, n // cfg.engine.compact_cap_frac)
            # first-m active indices via cumsum (argsort is ~10x costlier);
            # fill slots point out of range: their gathers clip (harmless
            # duplicate sims) and their writes drop
            (idx,) = jnp.nonzero(state.sec > 0, size=m, fill_value=n)
            sub = jax.tree_util.tree_map(lambda a: a[idx], state)
            sub = run_until_done(sub, p1_chunks)
            state = jax.tree_util.tree_map(
                lambda full, s_: full.at[idx].set(s_, mode="drop"),
                state, sub)
            final = run_until_done(state, p1_chunks)  # no-op unless overflow
        elif cfg.engine.play_chunk_tail:
            # descending chunk schedule (round-3 lever b): big chunks while
            # everyone is alive, a smaller tail chunk after `tail_after`
            # plays so the stop point quantizes nearer the batch's true max
            # step count (with chunk 24 the loop runs to 192 for a ~183
            # max; an 8-step tail stops at 184).  Draw streams key on the
            # absolute step index, so trajectories are bitwise-identical to
            # the single-chunk schedule.
            ta = cfg.engine.play_chunk_tail
            head_steps = (cfg.engine.tail_after // ch) * ch
            tail_chunks = -(-(cfg.engine.max_plays - head_steps) // ta)
            state = phase_loop(init, 0, head_steps // ch, 0, ch)
            final = phase_loop(state, 0, tail_chunks, head_steps, ta)
        else:
            final = run_until_done(init, 0)
    else:
        keys = jax.random.split(key, cfg.engine.max_plays)
        final, _ = jax.lax.scan(step, init, keys,
                                unroll=cfg.engine.scan_unroll)
    if not collect_stats:
        return final
    final_stats = final.stats.at[:, 0, TS["points"]].set(final.score[:, 0].astype(F32))
    final_stats = final_stats.at[:, 1, TS["points"]].set(final.score[:, 1].astype(F32))
    return final._replace(stats=final_stats)
