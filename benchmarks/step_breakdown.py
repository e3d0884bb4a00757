"""Surgical intra-step ablation of the play step on the device.

A local copy of a REPRESENTATIVE play step with toggles, so each cost
center (RNG, pack gathers, feature stack, heads, state machine, stats,
player sampling) can be zeroed independently.  Uses the analytic heads
(no tables) except the 'table-gather' variants which add N dummy fused
gathers from tables of the production sizes.

Usage: python benchmarks/step_breakdown.py [B] [STEPS]
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import jax
import jax.numpy as jnp
import numpy as np

from fast_monte_carlo.utils.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

B = int(sys.argv[1]) if len(sys.argv) > 1 else 131072
STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 360
F32, I32 = jnp.float32, jnp.int32
print("devices:", jax.devices(), "B:", B, "steps:", STEPS, flush=True)


def run(name, scan_fn, *args):
    g = jax.jit(scan_fn)
    t0 = time.perf_counter()
    out = g(*args)
    _ = np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:4]
    compile_s = time.perf_counter() - t0
    best = 1e9
    for _i in range(2):
        t0 = time.perf_counter()
        out = g(*args)
        _ = np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:4]
        best = min(best, time.perf_counter() - t0)
    print(f"{name:26s} {best:7.3f}s ({best/STEPS*1e3:6.3f} ms/step)"
          f"  [compile {compile_s:.0f}s]", flush=True)
    return best


from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.models import analytic

cfg = SimConfig()


def make_step(rng=True, packg=True, feats=True, heads=True, machine=True,
              stats=True, players=True, n_extra_gathers=0, table_rows=0):
    """One parameterized play step over simple carried state."""
    # tiny per-direction pack stand-ins (2 rows = 1 matchup)
    pk = dict(
        off_offense=jnp.asarray([35.7, 31.5], F32),
        def_defense=jnp.asarray([20.6, 20.0], F32),
        ymult=jnp.asarray([1.01, 0.99], F32),
        mz=jnp.asarray([0.11, -0.11], F32),
        bias=jnp.asarray([0.013, -0.013], F32),
        sp=jnp.asarray([[15.6, 35.7, 20.6, 11.0], [11.0, 31.5, 20.0, 15.6]], F32),
        cum=jnp.ones((2, 1), F32),
    )
    big_table = (jnp.arange(table_rows * 8, dtype=F32).reshape(table_rows, 8)
                 if table_rows else None)

    def step(s, key):
        off, sec, down, dist, ytg, period, in_rz, score, tstats = s
        active = sec > 0
        if rng:
            ku, kn = jax.random.split(key)
            u = jax.random.uniform(ku, (B, 13))
            n = jax.random.normal(kn, (B, 4))
        else:
            u = jnp.full((B, 13), 0.37, F32)
            n = jnp.full((B, 4), 0.1, F32)
        sd = (score[:, 0] - score[:, 1]) * jnp.where(off == 0, 1, -1)

        if packg:
            off_o = jnp.take(pk["off_offense"], off, mode="clip")
            def_d = jnp.take(pk["def_defense"], off, mode="clip")
            ymult = jnp.take(pk["ymult"], off, mode="clip")
            mz = jnp.take(pk["mz"], off, mode="clip")
            bias = jnp.take(pk["bias"], off, mode="clip")
            qb = jnp.sum(u[:, 4][:, None] >= jnp.take(pk["cum"], off, axis=0), axis=1)
            wr = jnp.sum(u[:, 5][:, None] >= jnp.take(pk["cum"], off, axis=0), axis=1)
            rb = jnp.sum(u[:, 6][:, None] >= jnp.take(pk["cum"], off, axis=0), axis=1)
        else:
            off_o, def_d = jnp.full((B,), 35.7), jnp.full((B,), 20.6)
            ymult, mz, bias = jnp.ones((B,)), jnp.zeros((B,)), jnp.zeros((B,))
            qb = wr = rb = jnp.zeros((B,), I32)

        if feats:
            half_s = cfg.clock.half_seconds
            sec_f = sec.astype(F32)
            sp = jnp.take(pk["sp"], off, axis=0, mode="clip")
            x = jnp.stack([
                down.astype(F32), dist, ytg, (ytg <= 20).astype(F32),
                sd.astype(F32), sec_f,
                jnp.full_like(sec_f, 3.0), jnp.full_like(sec_f, 3.0),
                sp[:, 0], sp[:, 1], sp[:, 2], sp[:, 3],
                (dist >= ytg - 0.5).astype(F32),
                ((down == 4) & (dist <= 2.0)).astype(F32),
                (ytg <= 33).astype(F32),
                jnp.where(sec > half_s, 1.0, 2.0),
                ((sec % half_s) <= 120).astype(F32),
            ], axis=1)
            feat_sum = x.sum(axis=1) * 1e-9
        else:
            feat_sum = jnp.zeros((B,))

        if heads:
            p_c = jnp.clip(0.68 - 0.022 * jnp.maximum(0.0, dist - 3.0) + bias,
                           0.02, 0.98)
            inc, itc, sck = analytic.stage2_fallback_probs(down.astype(F32), dist, cfg, jnp)
            inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg, jnp)
            s2c1, s2c2 = inc, inc + sck
            pass_mu, pass_sg = 4.5 + 0.45 * dist, jnp.full((B,), 7.0)
            rush_mu, rush_sg = jnp.full((B,), 4.2), jnp.full((B,), 4.0)
            sack_mu, sack_sg = jnp.full((B,), -6.0), jnp.full((B,), 2.2)
            p_pass = analytic.pass_prob_v1(down, dist, ytg, sec, sd, cfg, jnp)
            p_go = jnp.minimum(1.0, analytic.go_for_it_prob(
                ytg, dist, sd, sec, cfg, jnp) * cfg.fourth.go_multiplier)
            p_fg = analytic.field_goal_prob(ytg + 17.0, cfg, jnp)
            ep = analytic.explosive_prob(ytg, off_o, def_d, cfg, jnp)
            rzp = analytic.rz_finish_prob_pass(ytg, down, off_o, def_d, cfg, jnp)
            rzr = analytic.rz_finish_prob_run(ytg, down, off_o, def_d, cfg, jnp)
        else:
            p_c = jnp.full((B,), 0.62)
            s2c1, s2c2 = jnp.full((B,), 0.8), jnp.full((B,), 0.92)
            pass_mu, pass_sg = jnp.full((B,), 7.0), jnp.full((B,), 7.0)
            rush_mu, rush_sg = jnp.full((B,), 4.2), jnp.full((B,), 4.0)
            sack_mu, sack_sg = jnp.full((B,), -6.0), jnp.full((B,), 2.2)
            p_pass, p_go, p_fg = (jnp.full((B,), v) for v in (0.5, 0.1, 0.8))
            ep, rzp, rzr = (jnp.full((B,), v) for v in (0.05, 0.4, 0.38))

        extra = jnp.zeros((B,))
        if n_extra_gathers and big_table is not None:
            idx = (sec * 131 + down * 7 + (dist * 2).astype(I32)) % table_rows
            for gi in range(n_extra_gathers):
                row = jnp.take(big_table, (idx + gi) % table_rows, axis=0,
                               mode="clip")
                extra = extra + row[:, 0] * 1e-12

        if machine:
            is4 = down == 4
            go = active & is4 & (u[:, 0] < p_go)
            st_play = active & is4 & ~go
            fg_att = st_play & (ytg <= 38.0)
            punt = st_play & ~fg_att
            scrim = active & ~st_play
            fg_good = fg_att & (u[:, 1] < p_fg)
            fg_miss = fg_att & ~fg_good
            gross = jnp.maximum(30.0, 43.0 + 6.0 * n[:, 0])
            pret = jnp.maximum(0.0, 6.0 + 3.0 * n[:, 1])
            net = gross - pret
            tb_p = jnp.clip((60.0 - ytg) / 60.0, 0.10, 0.55)
            tb = (ytg <= 60.0) & (u[:, 2] < tb_p)
            net = jnp.where(tb, ytg - 25.0, net)
            net = jnp.trunc(jnp.clip(net, 15.0, ytg - 1.0))
            punt_spot = jnp.clip(100.0 - (ytg - net), 1.0, 99.0)
            trip1 = scrim & ~in_rz & (ytg <= 20)
            is_pass = scrim & (u[:, 3] < p_pass)
            is_run = scrim & ~is_pass
            complete = is_pass & (u[:, 7] < p_c + extra)
            notc = is_pass & ~complete
            o_inc = notc & (u[:, 11] < s2c1)
            o_sck = notc & ~o_inc & (u[:, 11] < s2c2)
            o_int = notc & ~o_inc & ~o_sck
            py = jnp.clip(pass_mu + pass_sg * n[:, 2], 0.0, ytg) * ymult
            expg = (ytg > 25.0) & (u[:, 8] < 0.6 * ep)
            boost = 0.35 + u[:, 9] * 0.6
            py = jnp.where(expg, jnp.minimum(py * (1 + boost * (1 + 0.5 * mz)), ytg), py)
            rz_p = (ytg <= 12.0) & (down <= 3) & (u[:, 10] < rzp)
            py = jnp.where(rz_p, ytg, py)
            pass_td = complete & (py + 1e-9 >= ytg)
            pass_gain = complete & ~pass_td
            sy = jnp.clip(sack_mu + sack_sg * n[:, 2], -20.0, 0.0)
            loss = jnp.minimum(jnp.maximum(0.0, -sy), ytg)
            ret = jnp.clip(6.0 + 5.0 * n[:, 3], 0.0, ytg)
            int_spot = 100.0 - (ytg - ret)
            ry = jnp.clip(rush_mu + rush_sg * n[:, 2], -4.0, ytg) * ymult
            expr = (ytg > 25.0) & (u[:, 8] < 0.5 * ep)
            ry = jnp.where(expr, jnp.minimum(ry * (1 + boost), ytg), ry)
            rz_r = (ytg <= 9.0) & (down <= 3) & (u[:, 10] < rzr)
            ry = jnp.where(rz_r, ytg, ry)
            run_td = is_run & (ry + 1e-9 >= ytg)
            run_gain = is_run & ~run_td
            adv = pass_gain | run_gain
            gained = jnp.where(pass_gain, py, 0.0) + jnp.where(run_gain, ry, 0.0)
            ytg_a = jnp.where(adv, jnp.maximum(0.0, ytg - gained), ytg)
            first = adv & (gained + 1e-6 >= dist)
            down_a = jnp.where(adv, jnp.where(first, 1, down + 1), down)
            dist_a = jnp.where(adv, jnp.where(first, 10.0, dist - gained), dist)
            downs_to = adv & ~first & (down_a > 4)
            ytg_a = jnp.where(o_sck, ytg + loss, ytg_a)
            dist_a = jnp.where(o_sck, dist + loss, dist_a)
            down_a = jnp.where(o_sck | o_inc, down + 1, down_a)
            flip_a = downs_to | o_int
            spot_a = jnp.where(o_int, int_spot, 100.0 - ytg_a)
            off_a = jnp.where(flip_a, 1 - off, off)
            ytg_a = jnp.where(flip_a, spot_a, ytg_a)
            down_a = jnp.where(flip_a, 1, down_a)
            dist_a = jnp.where(flip_a, 10.0, dist_a)
            in_rz_a = jnp.where(flip_a, False, in_rz | trip1)
            t = (fg_att * 6 + punt * 6 + pass_td * 20 + pass_gain * 26
                 + o_inc * 10 + o_sck * 24 + o_int * 12
                 + (run_td | run_gain) * 28).astype(I32)
            sec_b = jnp.maximum(0, sec - t)
            period_b = jnp.where(sec_b > 0, 4 - ((sec_b - 1) // 900), 4).astype(I32)
            halftime = active & (period_b != period) & (period_b == 3)
            off_b = jnp.where(halftime, 1 - off_a, off_a)
            ytg_b = jnp.where(halftime, 75.0, ytg_a)
            down_b = jnp.where(halftime, 1, down_a)
            dist_b = jnp.where(halftime, 10.0, dist_a)
            in_rz_b = jnp.where(halftime, False, in_rz_a)
            flip_c = fg_good | fg_miss | punt | pass_td | run_td
            spot_c = jnp.where(fg_miss, 100.0 - ytg,
                               jnp.where(punt, punt_spot, 75.0))
            off_c = jnp.where(flip_c, 1 - off_b, off_b)
            ytg_c = jnp.where(flip_c, spot_c, ytg_b)
            down_c = jnp.where(flip_c, 1, down_b)
            dist_c = jnp.where(flip_c, 10.0, dist_b)
            in_rz_c = jnp.where(flip_c, False, in_rz_b)
            td = pass_td | run_td
            pts = td * 7 + fg_good * 3
            oh = jax.nn.one_hot(off, 2, dtype=I32)
            score_f = score + oh * pts[:, None]
        else:
            off_c, sec_b = off, jnp.maximum(0, sec - 26)
            down_c, dist_c, ytg_c = down, dist, ytg
            period_b, in_rz_c = period, in_rz
            score_f = score
            scrim = active
            complete = active
            pass_td = run_td = fg_good = fg_att = punt = active & False
            pass_gain = run_gain = o_inc = o_sck = o_int = is_run = is_pass = scrim
            py = ry = jnp.zeros((B,))
            trip1 = go = scrim & False
            oh = jax.nn.one_hot(off, 2, dtype=I32)

        if stats:
            zeros = jnp.zeros((B,), F32)
            colvals = [
                scrim.astype(F32), (complete | o_inc | o_int).astype(F32),
                complete.astype(F32),
                jnp.where(pass_td, ytg, jnp.where(pass_gain, py, 0.0)),
                pass_td.astype(F32), o_int.astype(F32), o_sck.astype(F32),
                is_run.astype(F32),
                jnp.where(run_td, ytg, jnp.where(run_gain, ry, 0.0)),
                run_td.astype(F32), fg_good.astype(F32), fg_att.astype(F32),
                punt.astype(F32), trip1.astype(F32),
                (run_td & (ytg <= 20)).astype(F32), go.astype(F32),
                zeros, zeros, zeros,
            ]
            ds = jnp.stack(colvals, axis=1)
            tstats_f = tstats + oh.astype(F32)[:, :, None] * ds[:, None, :]
        else:
            tstats_f = tstats

        if players:
            K = 1
            qb_delta = jnp.stack([complete.astype(F32)] * 6, axis=1)
            ohs = jax.nn.one_hot(qb, K, dtype=F32)
            upd = jnp.einsum("bs,bk,bc->bskc", oh.astype(F32), ohs, qb_delta)
            tstats_f = tstats_f + upd[:, :, 0, :1] * 1e-9  # fold in, keep shapes

        return (off_c.astype(I32), sec_b.astype(I32), down_c.astype(I32),
                dist_c.astype(F32), ytg_c.astype(F32), period_b.astype(I32),
                in_rz_c, score_f, tstats_f), None

    def scan_fn(key):
        init = (jnp.zeros((B,), I32), jnp.full((B,), 3600, I32),
                jnp.ones((B,), I32), jnp.full((B,), 10.0, F32),
                jnp.full((B,), 75.0, F32), jnp.ones((B,), I32),
                jnp.zeros((B,), bool), jnp.zeros((B, 2), I32),
                jnp.zeros((B, 2, 19), F32))
        keys = jax.random.split(key, STEPS)
        out, _ = jax.lax.scan(step, init, keys)
        return out[7]

    return scan_fn


key = jax.random.PRNGKey(0)
full = run("FULL (analytic)", make_step(), key)
run("- rng", make_step(rng=False), key)
run("- pack gathers", make_step(packg=False), key)
run("- feature stack", make_step(feats=False), key)
run("- analytic heads", make_step(heads=False), key)
run("- state machine", make_step(machine=False), key)
run("- team stats", make_step(stats=False), key)
run("- players", make_step(players=False), key)
run("MINIMAL (clock only)", make_step(rng=False, packg=False, feats=False,
                                      heads=False, machine=False, stats=False,
                                      players=False), key)
run("+ 1 gather 1.7M rows", make_step(n_extra_gathers=1, table_rows=1_700_000), key)
run("+ 1 gather 131k rows", make_step(n_extra_gathers=1, table_rows=131_072), key)
run("+ 7 gathers 131k rows", make_step(n_extra_gathers=7, table_rows=131_072), key)
