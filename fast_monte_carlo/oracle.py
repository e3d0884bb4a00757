"""CPU oracle: a faithful scalar re-implementation of the reference game
semantics, used as distributional ground truth for the device engine.

This mirrors `fast_monte_carlo_cfb.py`'s as-executed behavior branch by
branch — including its quirks, each marked with a `# quirk:` comment and a
file:line citation:

  * clip-then-multiply yardage (clip to ytg happens BEFORE the SP+ yardage
    multiplier, :1091, :1220) so multiplied gains can exceed ytg and score
  * rz_TD counted only on rushing TDs (:1237), never passing TDs
  * red-zone trip re-detection mid-drive only after runs (:1253-1255)
  * sack pushback capped at min(20, ytg) (:1177-1178) so ytg may exceed 100
  * timeouts never decrement (no timeout logic exists)
  * memoized model outputs keyed on the coarse state bins of :68-88 /
    :343-357 (score_diff excluded from all pass/yardage keys), first call
    wins within a process

Model calls flow through the compiled FlatForests (models/heads.py), so this
oracle needs no xgboost/sklearn at runtime.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .config import SimConfig
from .data.context import TeamContext
from .matchup import DirectionContext, build_direction
from .models import analytic
from .models.heads import ModelHeads
from .stats import (
    N_PLAYER_STATS, N_TEAM_STATS, PC_ATT, PC_COMP, PC_INT, PC_SACKS, PC_TD,
    PC_YDS, ROLE_PASS, ROLE_REC, ROLE_RUSH, TS,
)



def _taper_scalar(y, t1, t2, r1, r2):
    """mc-variant long-gain taper (monte_carlo_cfb.py:470,482)."""
    if y <= t1:
        return y
    if y <= t2:
        return t1 + (y - t1) * r1
    return t1 + (t2 - t1) * r1 + (y - t2) * r2

def _state_vec(d: DirectionContext, down, dist, ytg, sec, to_off, to_def, score_diff, cfg):
    half = 1 if sec > cfg.clock.half_seconds else 2
    return np.asarray([[
        down, dist, ytg,
        1.0 if ytg <= 20 else 0.0,
        score_diff, sec, to_off, to_def,
        d.sp_rating_off, d.sp_offense_rating_off,
        d.sp_defense_rating_def, d.sp_rating_def,
        1.0 if dist >= ytg - 0.5 else 0.0,
        1.0 if (down == 4 and dist <= 2.0) else 0.0,
        1.0 if ytg <= 33 else 0.0,
        half,
        1.0 if (sec % cfg.clock.half_seconds) <= 120 else 0.0,
    ]], dtype=np.float32)


def _coarse_key(down, dist, ytg, sec, to_off, to_def, slot, slot2=None):
    """The reference memo-cache key bins (fast_monte_carlo_cfb.py:68-88):
    0.5-yd distance, 1-yd ytg, 30-s seconds buckets; score_diff excluded."""
    return (
        int(down), round(dist * 2) / 2.0, int(round(ytg)), int(sec // 30),
        int(to_off), int(to_def), slot, slot2,
    )


@dataclass
class _GameState:
    off: int = 0           # 0 = first team has ball
    sec: int = 3600
    down: int = 1
    dist: float = 10.0
    ytg: float = 75.0
    period: int = 1
    in_rz: bool = False
    going: bool = False


class OracleMatchup:
    """One matchup; call simulate_game(first_offense, rng) repeatedly."""

    def __init__(
        self,
        team_a: TeamContext,
        team_b: TeamContext,
        heads: ModelHeads,
        cfg: Optional[SimConfig] = None,
        coach_map: Optional[Dict[str, str]] = None,
        memoize: bool = True,
        record_first_sd: bool = False,
        record_states: bool = False,
    ):
        self.cfg = cfg or SimConfig()
        self.heads = heads
        self.teams = (team_a, team_b)
        # direction[i] = team i on offense
        self.dirs = (
            build_direction(team_a, team_b, heads, self.cfg, coach_map),
            build_direction(team_b, team_a, heads, self.cfg, coach_map),
        )
        self.memoize = memoize
        self._caches = [dict(play={}, s1={}, s2={}, pq={}, rq={}, sq={}, fq={})
                        for _ in range(2)]
        # 'cachewarm' sd-mode support (models/tables.py cachewarm_collapse):
        # record, per memo-cache key, the live score_diff the FIRST call
        # carried and its global visit order — that pair fully determines
        # which model output the reference's first-write-wins cache froze
        # for that state bin (fast_monte_carlo_cfb.py:68-94: keys exclude
        # score_diff but the stored value was computed at the caller's sd).
        self.record_first_sd = record_first_sd
        self.first_sd = [dict(s1={}, s2={}, pq={}, rq={}, sq={}, fq={})
                         for _ in range(2)]
        self._visit = 0
        # dropback-state recording (train.pipeline.sample_dropback_states):
        # each pass play appends (st1_row17, passer_name, target_name) — the
        # realistic state distribution used to reconstruct the snapshot's
        # missing stage-2 booster on plausible football states
        self.record_states = record_states
        self.dropback_states: list = []

    def reset_caches(self) -> None:
        """Empty the memo caches, as a fresh reference worker process would.

        The reference's caches are module globals that live exactly as long
        as one Pool worker (fast_monte_carlo_cfb.py:90-94, :1302-1328): at
        the default run shape (n=500 pairs over 4 processes, :1474-1496)
        each cache sees only ~250 games before it is discarded.  A long
        single-cache oracle stream therefore drifts from the as-executed
        reference (VALIDATION.md: margin sd decays toward the frozen limit
        as the cache warms); resetting every ~250 games makes the referee
        stationary AND faithful to the reference's real run length."""
        self._caches = [dict(play={}, s1={}, s2={}, pq={}, rq={}, sq={},
                             fq={}) for _ in range(2)]
        self.first_sd = [dict(s1={}, s2={}, pq={}, rq={}, sq={}, fq={})
                         for _ in range(2)]
        self._visit = 0

    # -- model wrappers with reference-faithful memoization ----------------

    def _cached(self, side, cache, key, fn, sd=None):
        if not self.memoize:
            return fn()
        c = self._caches[side][cache]
        v = c.get(key)
        if v is None:
            if self.record_first_sd and cache in self.first_sd[side]:
                self.first_sd[side][cache][key] = (self._visit, float(sd or 0.0))
                self._visit += 1
            v = fn()
            c[key] = v
        return v

    def _p_pass(self, side, d, gs, score_diff):
        cfg = self.cfg
        if self.heads.play is None or not cfg.model.use_play_model:
            return float(analytic.pass_prob_v1(
                gs.down, gs.dist, gs.ytg, gs.sec, score_diff, cfg))
        key = _coarse_key(gs.down, gs.dist, gs.ytg, gs.sec, 3, 3, None) + (int(score_diff),)

        def compute():
            lay = self.heads.play.layout
            x = _state_vec(d, gs.down, gs.dist, gs.ytg, gs.sec, 3, 3, score_diff, cfg)
            # play layout may be the legacy 12-numeric one
            cols = [  # map ST1 17-vector -> play numeric order
                ("down", 0), ("distance", 1), ("yardsToGoal", 2), ("is_red_zone", 3),
                ("score_diff", 4), ("seconds_remaining", 5), ("offenseTimeouts", 6),
                ("defenseTimeouts", 7), ("sp_rating_off", 8), ("sp_offense_rating_off", 9),
                ("sp_defense_rating_def", 10), ("sp_rating_def", 11),
                ("goal_to_go", 12), ("fourth_and_short", 13), ("fg_range", 14),
                ("half", 15), ("two_minute", 16),
            ]
            pos = {n: i for n, i in cols}
            xp = np.asarray([[x[0, pos[n]] for n in lay.numeric_names]], dtype=np.float32)
            return float(self.heads.play_pass_prob(xp, np.asarray([d.coach_id]), cfg)[0])

        return self._cached(side, "play", key, compute)

    def _stage1(self, side, d, x, qb_slot, gs):
        key = _coarse_key(gs.down, gs.dist, gs.ytg, gs.sec, 3, 3, qb_slot)
        return self._cached(
            side, "s1", key,
            lambda: float(self.heads.stage1_prob(x, d.qb_stage1[qb_slot:qb_slot + 1])[0]),
            sd=float(x[0, 4]))

    def _stage2(self, side, d, x, qb_slot, wr_slot, gs):
        key = _coarse_key(gs.down, gs.dist, gs.ytg, gs.sec, 3, 3, qb_slot, wr_slot)
        return self._cached(
            side, "s2", key,
            lambda: tuple(float(v) for v in np.concatenate(self.heads.stage2_probs(
                x, d.qb_stage2[qb_slot:qb_slot + 1],
                d.wr_stage2[wr_slot:wr_slot + 1], self.cfg))),
            sd=float(x[0, 4]))

    def _pass_quants(self, side, d, x, qb_slot, wr_slot, gs):
        key = _coarse_key(gs.down, gs.dist, gs.ytg, gs.sec, 3, 3, qb_slot, wr_slot)
        return self._cached(
            side, "pq", key,
            lambda: tuple(float(v) for v in np.concatenate(self.heads.pass_yard_quants(
                x, d.qb_passq[qb_slot:qb_slot + 1], d.wr_passq[wr_slot:wr_slot + 1]))),
            sd=float(x[0, 4]))

    def _rush_quants(self, side, d, x, rb_slot, gs):
        key = _coarse_key(gs.down, gs.dist, gs.ytg, gs.sec, 3, 3, rb_slot)
        return self._cached(
            side, "rq", key,
            lambda: tuple(float(v) for v in np.concatenate(
                self.heads.rush_yard_quants(x, d.rb_rushq[rb_slot:rb_slot + 1]))),
            sd=float(x[0, 4]))

    def _sack_quants(self, side, d, x, qb_slot, gs):
        key = _coarse_key(gs.down, gs.dist, gs.ytg, gs.sec, 3, 3, qb_slot)
        return self._cached(
            side, "sq", key,
            lambda: tuple(float(v) for v in np.concatenate(
                self.heads.sack_loss_quants(x, d.qb_sackq[qb_slot:qb_slot + 1]))),
            sd=float(x[0, 4]))

    def _fumble_p(self, side, d, x, rb_slot, gs):
        key = _coarse_key(gs.down, gs.dist, gs.ytg, gs.sec, 3, 3, rb_slot)
        return self._cached(
            side, "fq", key,
            lambda: float(self.heads.fumble_prob(x, d.rb_fumble[rb_slot:rb_slot + 1])[0]),
            sd=float(x[0, 4]))

    # -- mechanics ----------------------------------------------------------

    def _change_possession(self, gs: _GameState, spot: Optional[float] = None):
        gs.off = 1 - gs.off
        gs.down = 1
        gs.dist = 10.0
        gs.in_rz = False
        gs.going = False
        gs.ytg = (100.0 - gs.ytg) if spot is None else spot

    def _tick(self, gs: _GameState, base: int):
        cfg = self.cfg
        gs.sec = max(0, gs.sec - base)
        old = gs.period
        gs.period = 4 - ((gs.sec - 1) // cfg.clock.quarter_seconds) if gs.sec > 0 else 4
        if gs.period != old and gs.period == 3:
            # halftime: kickoff to the other team (timeouts reset is a no-op
            # here since timeouts never change)
            self._change_possession(gs, spot=self.cfg.kickoff_spot)

    def _advance_down(self, gs: _GameState, gained: float):
        gs.ytg = max(0.0, gs.ytg - gained)
        if gained + 1e-6 >= gs.dist:
            gs.down = 1
            gs.dist = 10.0
        else:
            gs.down += 1
            gs.dist -= gained
            if gs.down > 4:
                self._change_possession(gs)  # turnover on downs at the spot

    @staticmethod
    def _slot(cum: np.ndarray, u: float) -> int:
        return min(int(np.searchsorted(cum, u, side="right")), len(cum) - 1)

    # -- game loop ----------------------------------------------------------

    def simulate_game(self, first_offense: int, rng: np.random.Generator,
                      start=None, force_first=None) -> dict:
        """One full game; `start` (any object with offense/sec/down/dist/
        ytg/score_a/score_b fields, e.g. ops.game.Situation) resumes from a
        mid-game state instead of the kickoff — the scalar referee twin of
        the engine's live mode.  Derived fields follow state_from_situation:
        period from the tick formula, in_rz = ytg <= 20 (no fresh rz_trip
        for a drive already inside the 20), going decided organically.

        `force_first` ('go' | 'fg' | 'punt', requires a down-4 `start`)
        overrides the FIRST play's 4th-down decision and lets the game
        continue under the normal policy — the referee twin of the
        engine's 4th-down evaluator (FourthDownConfig.force applied to
        one play; api.evaluate_fourth_down)."""
        cfg = self.cfg
        if start is None:
            gs = _GameState(off=first_offense, sec=cfg.clock.game_seconds,
                            ytg=cfg.kickoff_spot, dist=cfg.opening_distance)
            score = [0, 0]
        else:
            first_offense = int(start.offense)
            sec = int(start.sec)
            gs = _GameState(
                off=first_offense, sec=sec, down=int(start.down),
                dist=float(start.dist), ytg=float(start.ytg),
                period=(4 - ((sec - 1) // cfg.clock.quarter_seconds)
                        if sec > 0 else 4),
                in_rz=float(start.ytg) <= 20.0)
            score = [int(start.score_a), int(start.score_b)]
        stats = np.zeros((2, N_TEAM_STATS))
        K = self.teams[0].qb.k
        pstats = np.zeros((2, 3, K, N_PLAYER_STATS))

        if force_first is not None and (start is None or gs.down != 4):
            raise ValueError(
                "force_first needs a down=4 start situation, got "
                f"start={start!r}")
        while gs.sec > 0:
            force, force_first = force_first, None  # first play only
            if gs.down == 4 and self._handle_fourth(gs, score, stats, rng,
                                                    force=force):
                continue
            self._play(gs, score, stats, pstats, rng)

        stats[0, TS["points"]] = score[0]
        stats[1, TS["points"]] = score[1]
        return {
            "first_offense": first_offense,
            "score": tuple(score),
            "stats": stats,
            "pstats": pstats,
        }

    def _handle_fourth(self, gs, score, stats, rng, force=None) -> bool:
        cfg = self.cfg
        side = gs.off
        if force is None:
            sd = score[side] - score[1 - side]
            p_go = min(1.0, float(analytic.go_for_it_prob(
                np.float32(gs.ytg), np.float32(gs.dist), sd, gs.sec, cfg))
                * cfg.fourth.go_multiplier)
            go = rng.random() < p_go
            fg_att = gs.ytg <= cfg.st.fg_attempt_max_ytg
        elif force in ("go", "fg", "punt"):
            # decision override (the engine's FourthDownConfig.force
            # semantics): 'fg' kicks regardless of range, 'punt' punts
            # from anywhere; the play itself runs the normal models
            go, fg_att = force == "go", force == "fg"
        else:
            raise ValueError(
                f"force must be None|'go'|'fg'|'punt', got {force!r}")
        if go:
            gs.going = True
            stats[side, TS["fourth_go"]] += 1
            return False

        if fg_att:
            stats[side, TS["FGA"]] += 1
            p = float(analytic.field_goal_prob(
                np.float32(gs.ytg + cfg.st.fg_snap_plus_endzone), cfg))
            good = rng.random() < p
            self._tick(gs, cfg.clock.field_goal)
            if good:
                stats[side, TS["FG"]] += 1
                score[side] += cfg.model.fg_points
                stats[side, TS["points"]] = score[side]
                self._change_possession(gs, spot=cfg.kickoff_spot)
            else:
                self._change_possession(gs, spot=100.0 - gs.ytg)
            return True

        stats[side, TS["punts"]] += 1
        gross = max(cfg.st.punt_gross_min, rng.normal(cfg.st.punt_gross_mean, cfg.st.punt_gross_sd))
        ret = max(0.0, rng.normal(cfg.st.punt_return_mean, cfg.st.punt_return_sd))
        net = gross - ret
        if gs.ytg <= cfg.st.punt_touchback_gate_ytg:
            tb_p = min(max((60.0 - gs.ytg) / 60.0, cfg.st.punt_tb_lo), cfg.st.punt_tb_hi)
            if rng.random() < tb_p:
                net = gs.ytg - cfg.st.punt_tb_own_spot
        net = int(min(max(net, cfg.st.punt_net_min), gs.ytg - 1.0))  # int() per :896
        self._tick(gs, cfg.clock.punt)
        new_spot = min(max(100.0 - (gs.ytg - net), 1.0), 99.0)
        self._change_possession(gs, spot=new_spot)
        return True

    def _play(self, gs, score, stats, pstats, rng):
        cfg = self.cfg
        if gs.sec <= 0:
            return
        side = gs.off
        d = self.dirs[side]
        off_ctx = self.teams[side]
        sd = score[side] - score[1 - side]
        dist0, ytg0, was_going = gs.dist, gs.ytg, gs.going

        if not gs.in_rz and gs.ytg <= 20:
            stats[side, TS["rz_trips"]] += 1
            gs.in_rz = True

        p_pass = self._p_pass(side, d, gs, sd)
        stats[side, TS["plays"]] += 1
        is_pass = rng.random() < p_pass

        if is_pass:
            qb = self._slot(d.qb_cum, rng.random())
            wr = self._slot(d.wr_cum, rng.random())
            track_qb = bool(off_ctx.qb.tracked[qb])
            track_wr = bool(off_ctx.target.tracked[wr])
            if track_wr:
                pstats[side, ROLE_REC, wr, PC_ATT] += 1  # tgt

            x = _state_vec(d, gs.down, gs.dist, gs.ytg, gs.sec, 3, 3, sd, cfg)
            if self.record_states:
                self.dropback_states.append(
                    (x[0].copy(), str(off_ctx.qb.names[qb]),
                     str(off_ctx.target.names[wr])))
            p_c = self._stage1(side, d, x, qb, gs)
            p_c = min(max(p_c + d.bias, cfg.model.stage1_clip_lo), cfg.model.stage1_clip_hi)

            if rng.random() < p_c:  # completed
                q10, q50, q90 = self._pass_quants(side, d, x, qb, wr, gs)
                if cfg.model.rz_pass_damping and gs.ytg < 15:
                    # mc-variant goal-line damping (monte_carlo_cfb.py:462-464)
                    rz_scale = 0.8 + 0.2 * (gs.ytg / 15.0)
                    q10, q50, q90 = q10 * rz_scale, q50 * rz_scale, q90 * rz_scale
                sigma = max(cfg.model.pass_sigma_floor, (q90 - q10) / cfg.model.sigma_denom)
                y = rng.normal(q50, sigma)
                if cfg.model.taper_enabled:
                    y = _taper_scalar(y, *cfg.model.pass_taper)
                y = min(max(y, cfg.model.pass_clip_lo), gs.ytg)
                yards = y * d.ymult  # quirk: clip before multiplier (:1091)

                if ytg0 > cfg.matchup.explosive_gate_ytg and rng.random() < (
                        cfg.matchup.explosive_pass_scale
                        * float(analytic.explosive_prob(np.float32(ytg0), d.off.sp_offense, d.deff.sp_defense, cfg))):
                    boost = rng.uniform(cfg.matchup.explosive_pass_boost_lo,
                                        cfg.matchup.explosive_pass_boost_hi)
                    yards *= 1.0 + boost * (1.0 + cfg.matchup.explosive_pass_z_k * d.mz)
                    yards = min(yards, ytg0)
                if ytg0 <= cfg.matchup.rz_pass_gate_ytg and gs.down <= 3 and rng.random() < float(
                        analytic.rz_finish_prob_pass(ytg0, gs.down, d.off.sp_offense, d.deff.sp_defense, cfg)):
                    yards = ytg0

                stats[side, TS["pass_att"]] += 1
                if track_qb:
                    pstats[side, ROLE_PASS, qb, PC_ATT] += 1

                if yards + 1e-9 >= gs.ytg:  # TD pass
                    stats[side, TS["comp"]] += 1
                    stats[side, TS["pass_yds"]] += gs.ytg
                    stats[side, TS["pass_td"]] += 1
                    score[side] += cfg.model.td_points
                    stats[side, TS["points"]] = score[side]
                    if track_qb:
                        pstats[side, ROLE_PASS, qb, PC_COMP] += 1
                        pstats[side, ROLE_PASS, qb, PC_YDS] += gs.ytg
                        pstats[side, ROLE_PASS, qb, PC_TD] += 1
                    if track_wr:
                        pstats[side, ROLE_REC, wr, PC_COMP] += 1
                        pstats[side, ROLE_REC, wr, PC_YDS] += gs.ytg
                        pstats[side, ROLE_REC, wr, PC_TD] += 1
                    if was_going:
                        stats[side, TS["fourth_conv"]] += 1
                    gs.going = False
                    self._tick(gs, cfg.clock.td_pass)
                    self._change_possession(gs, spot=cfg.kickoff_spot)
                    return
                else:
                    stats[side, TS["comp"]] += 1
                    stats[side, TS["pass_yds"]] += yards
                    if track_qb:
                        pstats[side, ROLE_PASS, qb, PC_COMP] += 1
                        pstats[side, ROLE_PASS, qb, PC_YDS] += yards
                    if track_wr:
                        pstats[side, ROLE_REC, wr, PC_COMP] += 1
                        pstats[side, ROLE_REC, wr, PC_YDS] += yards
                    if was_going and yards + 1e-6 >= dist0:
                        stats[side, TS["fourth_conv"]] += 1
                    gs.going = False
                    self._advance_down(gs, yards)
                    self._tick(gs, cfg.clock.pass_complete)
                    return
            else:
                p_inc, p_int, p_sck = self._stage2(side, d, x, qb, wr, gs)
                p_inc, p_int, p_sck = analytic.stage2_nudge(p_inc, p_int, p_sck, cfg)
                u = rng.random()
                if u < p_inc:
                    stats[side, TS["pass_att"]] += 1
                    if track_qb:
                        pstats[side, ROLE_PASS, qb, PC_ATT] += 1
                    gs.down += 1
                    gs.going = False
                    self._tick(gs, cfg.clock.pass_incomplete)
                    return
                elif u < p_inc + p_sck:
                    stats[side, TS["sacks"]] += 1
                    if track_qb:
                        pstats[side, ROLE_PASS, qb, PC_SACKS] += 1
                    q10, q50, q90 = self._sack_quants(side, d, x, qb, gs)
                    sigma = max(cfg.model.sack_sigma_floor, (q90 - q10) / cfg.model.sigma_denom)
                    y = rng.normal(q50, sigma)
                    y = min(max(y, cfg.model.sack_clip_lo), cfg.model.sack_clip_hi)
                    loss = max(0.0, -y)
                    loss = min(loss, gs.ytg)  # quirk: cap = ytg (:1178)
                    gs.ytg += loss
                    gs.dist += loss
                    gs.down += 1
                    gs.going = False
                    self._tick(gs, cfg.clock.sack)
                    return
                else:  # intercepted
                    stats[side, TS["pass_att"]] += 1
                    stats[side, TS["INT"]] += 1
                    if track_qb:
                        pstats[side, ROLE_PASS, qb, PC_ATT] += 1
                        pstats[side, ROLE_PASS, qb, PC_INT] += 1
                    ret = min(max(rng.normal(cfg.model.int_return_mean,
                                             cfg.model.int_return_sd), 0.0), gs.ytg)
                    new_spot = 100.0 - (gs.ytg - ret)
                    gs.going = False
                    self._change_possession(gs, spot=new_spot)
                    self._tick(gs, cfg.clock.interception)
                    return
        else:  # run
            rb = self._slot(d.rb_cum, rng.random())
            track_rb = bool(off_ctx.rush.tracked[rb])
            if track_rb:
                pstats[side, ROLE_RUSH, rb, PC_ATT] += 1
            stats[side, TS["rush_att"]] += 1

            x = _state_vec(d, gs.down, gs.dist, gs.ytg, gs.sec, 3, 3, sd, cfg)
            q10, q50, q90 = self._rush_quants(side, d, x, rb, gs)
            sigma = max(cfg.model.rush_sigma_floor, (q90 - q10) / cfg.model.sigma_denom)
            y = rng.normal(q50, sigma)
            if cfg.model.taper_enabled:
                y = _taper_scalar(y, *cfg.model.rush_taper)
            y = min(max(y, cfg.model.rush_clip_lo), gs.ytg)
            yards = y * d.ymult  # quirk: clip before multiplier (:1220)

            if ytg0 > cfg.matchup.explosive_gate_ytg and rng.random() < (
                    cfg.matchup.explosive_run_scale
                    * float(analytic.explosive_prob(np.float32(ytg0), d.off.sp_offense, d.deff.sp_defense, cfg))):
                boost = rng.uniform(cfg.matchup.explosive_run_boost_lo,
                                    cfg.matchup.explosive_run_boost_hi)
                yards *= 1.0 + boost * (1.0 + cfg.matchup.explosive_run_z_k * d.mz)
                yards = min(yards, ytg0)
            if ytg0 <= cfg.matchup.rz_run_gate_ytg and gs.down <= 3 and rng.random() < float(
                    analytic.rz_finish_prob_run(ytg0, gs.down, d.off.sp_offense, d.deff.sp_defense, cfg)):
                yards = ytg0

            # optional fumble extension (head exists but is unwired upstream)
            if cfg.model.enable_fumbles and self.heads.fumble is not None:
                p_f = self._fumble_p(side, d, x, rb, gs)
                if rng.random() < p_f:
                    stats[side, TS["fumbles_lost"]] += 1
                    gained = min(max(yards, cfg.model.rush_clip_lo), ytg0)
                    spot_ytg = max(0.0, gs.ytg - gained)
                    gs.going = False
                    self._change_possession(gs, spot=100.0 - spot_ytg)
                    self._tick(gs, cfg.clock.run)
                    return

            if yards + 1e-9 >= ytg0:  # rushing TD
                stats[side, TS["rush_yds"]] += ytg0
                if track_rb:
                    pstats[side, ROLE_RUSH, rb, PC_YDS] += gs.ytg
                    pstats[side, ROLE_RUSH, rb, PC_TD] += 1
                stats[side, TS["rush_td"]] += 1
                if ytg0 <= 20:
                    stats[side, TS["rz_TD"]] += 1  # quirk: rush TDs only (:1237)
                score[side] += cfg.model.td_points
                stats[side, TS["points"]] = score[side]
                self._tick(gs, cfg.clock.run)
                self._change_possession(gs, spot=cfg.kickoff_spot)
                if was_going:
                    stats[side, TS["fourth_conv"]] += 1
                gs.going = False
                return
            else:
                stats[side, TS["rush_yds"]] += yards
                if track_rb:
                    pstats[side, ROLE_RUSH, rb, PC_YDS] += yards
                if was_going and yards + 1e-6 >= dist0:
                    stats[side, TS["fourth_conv"]] += 1
                self._advance_down(gs, yards)
                self._tick(gs, cfg.clock.run)
                if not gs.in_rz and gs.ytg <= 20:  # quirk: run-only recheck (:1253)
                    stats[side, TS["rz_trips"]] += 1
                    gs.in_rz = True
                gs.going = False
                return
