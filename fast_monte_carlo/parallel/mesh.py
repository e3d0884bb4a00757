"""Multi-chip scale-out: shard the trial axis over a device mesh.

The reference's only parallelism is a process pool over Monte-Carlo trials
(fast_monte_carlo_cfb.py:1496-1507).  Here the same data parallelism is a
1-D `('trial',)` jax mesh: each device runs an independent slice of the
trial batch through the same scan (no cross-device communication during the
game loop — counter-based threefry keys are folded per device so results
are independent of the device count *layout*), and aggregation happens with
on-device collectives afterwards (parallel.aggregate).

For multi-matchup slates, `api.SlateRunner(shard=True)` runs the whole
slate through this same trial-sharded entry (game id selects direction
rows per trial) — the ('game','trial') layout of SURVEY §7.1.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import SimConfig
from ..ops.game import GameState, HeadsEvalFn, simulate_games
from ..ops.pack import MatchupPack


def trial_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), ("trial",))


@lru_cache(maxsize=64)
def _games_sharded_jit(cfg, heads_eval, mesh, n_local,
                       collect_players, collect_stats):
    """Cached jit around the trial-sharded game launch.

    shard_map called EAGERLY re-traces, re-lowers, and re-hits the compile
    cache on every call, leaving the device idle while the host works in
    _shard_map_impl / _compile_and_write_cache.  Every shard_map entry
    therefore goes
    through one of these lru_cached jits, keyed on the static config so
    repeated launches reuse ONE compiled executable, exactly like the
    unsharded _shared_sim_jit."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("trial"), P("trial"), P("trial")),
        out_specs=P("trial"),
        check_vma=False,
    )
    def run(pack, heads_state, local_keys, local_fo, local_gid):
        return simulate_games(pack, cfg, heads_eval, heads_state,
                              local_keys[0], n_local, local_fo,
                              collect_players=collect_players,
                              game_id=local_gid,
                              collect_stats=collect_stats)

    return jax.jit(run)


def simulate_games_sharded(
    pack: MatchupPack,
    cfg: SimConfig,
    heads_eval: HeadsEvalFn,
    heads_state,
    key: jnp.ndarray,
    n: int,
    first_offense: int | jnp.ndarray,
    mesh: Optional[Mesh] = None,
    collect_players: bool = False,
    game_id=0,
    collect_stats: bool = True,
) -> GameState:
    """Run n games sharded over the trial axis of `mesh`.

    n must be divisible by the device count.  Each shard gets its own
    fold_in'd key, so the global result stream is a deterministic function
    of (key, n, ndev) and every shard is statistically independent.
    """
    mesh = mesh or trial_mesh()
    ndev = mesh.devices.size
    if n % ndev:
        raise ValueError(f"n={n} not divisible by {ndev} devices")
    n_local = n // ndev

    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(ndev))
    if isinstance(first_offense, (int, np.integer)):
        fo = jnp.full((n,), first_offense, jnp.int32)
    else:
        fo = jnp.asarray(first_offense, jnp.int32)
    if isinstance(game_id, (int, np.integer)):
        gid = jnp.full((n,), game_id, jnp.int32)
    else:
        gid = jnp.asarray(game_id, jnp.int32)

    fn = _games_sharded_jit(cfg, heads_eval, mesh, n_local,
                            collect_players, collect_stats)
    return fn(pack, heads_state, keys, fo, gid)


def simulate_moments_sharded(
    pack: MatchupPack,
    cfg: SimConfig,
    heads_eval: HeadsEvalFn,
    heads_state,
    key: jnp.ndarray,
    n: int,
    first_offense,
    mesh: Optional[Mesh] = None,
    game_id=0,
    collect_stats: bool = False,
    situation=None,
):
    """The production multi-chip summary workload: each device simulates its
    trial shard AND reduces it to additive ScoreMoments locally, then one
    `psum` over ICI merges the (tiny, ~1.3 KB) moment pytree — the
    full (B, 2) score batch never crosses devices or reaches the host.

    `situation` (ops.game.Situation of device scalars) resumes every trial
    from one mid-game state — live win-probability over the full mesh; the
    situation replicates to each device as runtime scalars, so one compiled
    program serves every live state.

    This is the device-side shape of the reference's Pool → parent-append →
    groupby flow (fast_monte_carlo_cfb.py:1496-1507, 1681-1687): the
    per-worker result pickle becomes per-device registers, the parent
    append becomes the collective.  Returns a replicated ScoreMoments;
    callers accumulate across pipelined launches on device
    (MatchupRunner.run_pairs_summary(shard=True)) and transfer once.
    """
    mesh = mesh or trial_mesh()
    ndev = mesh.devices.size
    if n % ndev:
        raise ValueError(f"n={n} not divisible by {ndev} devices")
    n_local = n // ndev

    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(ndev))
    if isinstance(game_id, (int, np.integer)):
        gid = jnp.full((n,), game_id, jnp.int32)
    else:
        gid = jnp.asarray(game_id, jnp.int32)

    if situation is not None:
        # the live path never consumes first_offense (possession comes
        # from the situation) — don't build its (n,) device array
        fn = _moments_sharded_live_jit(cfg, heads_eval, mesh, n_local,
                                       collect_stats)
        return fn(pack, heads_state, keys, gid, situation)
    if isinstance(first_offense, (int, np.integer)):
        fo = jnp.full((n,), first_offense, jnp.int32)
    else:
        fo = jnp.asarray(first_offense, jnp.int32)
    fn = _moments_sharded_jit(cfg, heads_eval, mesh, n_local, collect_stats)
    return fn(pack, heads_state, keys, fo, gid)


@lru_cache(maxsize=64)
def _moments_sharded_jit(cfg, heads_eval, mesh, n_local, collect_stats):
    """Cached jit for the sharded-summary launch (see _games_sharded_jit
    for why eager shard_map is never called per chunk)."""
    from .aggregate import score_moments

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("trial"), P("trial"), P("trial")),
        out_specs=P(),
        check_vma=False,
    )
    def run(pack, heads_state, local_keys, local_fo, local_gid):
        out = simulate_games(pack, cfg, heads_eval, heads_state,
                             local_keys[0], n_local, local_fo,
                             collect_players=False,
                             game_id=local_gid,
                             collect_stats=collect_stats)
        m = score_moments(out.score)
        return jax.tree_util.tree_map(lambda x: jax.lax.psum(x, "trial"), m)

    return jax.jit(run)


@lru_cache(maxsize=64)
def _moments_sharded_live_jit(cfg, heads_eval, mesh, n_local, collect_stats):
    """Live (mid-game-situation) variant of _moments_sharded_jit: the
    Situation scalars replicate to every device (P() spec) and flow into
    state_from_situation as runtime inputs — no recompile across live
    states, same per-device moment reduction + one psum."""
    from .aggregate import score_moments

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("trial"), P("trial"), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(pack, heads_state, local_keys, local_gid, sit):
        out = simulate_games(pack, cfg, heads_eval, heads_state,
                             local_keys[0], n_local, 0,
                             collect_players=False,
                             game_id=local_gid,
                             collect_stats=collect_stats,
                             situation=sit)
        m = score_moments(out.score)
        return jax.tree_util.tree_map(lambda x: jax.lax.psum(x, "trial"), m)

    return jax.jit(run)
