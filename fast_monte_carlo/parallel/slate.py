"""Game-sharded slate execution: device d owns matchups g ≡ d (mod N).

The one-launch ('game','trial') slate layout (api.SlateRunner shard=True)
concatenates every matchup's nano table into one shared device table — at
weekly-slate scale (~60 matchups) that is a ~983k-row gather target, which
on the earlier chip sat far past a gather row-count cliff.  This module
keeps every gather on a single-matchup table by sharding the GAME axis
instead of the trial axis:

  * per-matchup MatchupPack + TableHeads pytrees are STACKED on a leading
    game axis and sharded P('game') — each device materializes only its
    own matchups' ~16k-row tables;
  * inside the shard, `lax.scan` walks the local games one at a time, so
    the play-step gather always hits a single-matchup table;
  * each game reduces to additive ScoreMoments in-scan; the launch output
    is a (G,) moment pytree, still sharded — only the final per-matchup
    summaries (~1.3 KB each) ever transfer.

This is the device-side replacement for the reference's process pool over
trials (fast_monte_carlo_cfb.py:1496-1507) at slate scale: the pool's
"one worker per task" becomes "one device per matchup stripe", with the
per-game play loop as the scan axis (SURVEY §2.4).
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import SimConfig
from ..ops.game import HeadsEvalFn, simulate_games
from .aggregate import ScoreMoments, score_moments


def game_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), ("game",))


def stack_games(pytrees):
    """Stack same-structure per-game pytrees on a new leading game axis.

    Static fields (profiles, slot counts) are part of the treedef and must
    match across games — they do whenever the slate was built with one
    table profile, which is also what lets the scan body compile once."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *pytrees)


def pad_games(stacked, g: int, g_padded: int):
    """Pad the leading game axis to g_padded by repeating the last game
    (simulated-but-dropped; keeps every device's stripe the same length)."""
    if g_padded == g:
        return stacked
    return jax.tree_util.tree_map(
        lambda a: jnp.concatenate(
            [a, jnp.broadcast_to(a[-1], (g_padded - g,) + a.shape[1:])]),
        stacked)


def simulate_slate_moments(
    stacked_pack,
    cfg: SimConfig,
    heads_eval: HeadsEvalFn,
    stacked_tables,
    key: jnp.ndarray,
    g_padded: int,
    n_per_game: int,
    mesh: Optional[Mesh] = None,
) -> ScoreMoments:
    """One launch: every device scans its local game stripe, simulating
    `n_per_game` games per matchup (alternating first offense) and reducing
    each to ScoreMoments in-scan.  Returns a ScoreMoments pytree with a
    leading (g_padded,) axis, sharded P('game') — accumulate across
    pipelined launches on device and transfer once.

    `key` should already encode the launch index (fold_in per chunk);
    per-game keys are folded from it inside."""
    mesh = mesh or game_mesh()
    ndev = mesh.devices.size
    if g_padded % ndev:
        raise ValueError(f"g_padded={g_padded} not divisible by {ndev} devices")

    keys = jax.vmap(lambda g: jax.random.fold_in(key, g))(jnp.arange(g_padded))
    fn = _slate_moments_jit(cfg, heads_eval, mesh, n_per_game)
    return fn(stacked_pack, stacked_tables, keys)


@lru_cache(maxsize=16)
def _slate_moments_jit(cfg, heads_eval, mesh, n_per_game):
    """Cached jit around the game-sharded slate launch.

    An eager shard_map call re-traces and re-lowers the whole program on
    the host EVERY launch, leaving the device idle; wrapping the launch in
    one lru_cached jit — same pattern as api._shared_sim_jit — avoids
    that."""
    fo = jnp.asarray(np.arange(n_per_game) % 2, jnp.int32)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("game"), P("game"), P("game")),
        out_specs=P("game"),
        check_vma=False,
    )
    def run(local_pack, local_tables, local_keys):
        def body(carry, xs):
            pack_g, th_g, key_g = xs
            # materialize the scan's per-game table slice so the play-step
            # gather's operand is the per-game (~16k-row) table, not a
            # dynamic-slice view of the full stacked array (the large
            # gather target this layout exists to avoid).  It paid on the
            # earlier chip; not yet measured on the GPU.
            th_g = jax.lax.optimization_barrier(th_g)
            out = simulate_games(pack_g, cfg, heads_eval, th_g, key_g,
                                 n_per_game, fo, collect_players=False,
                                 game_id=0, collect_stats=False)
            return carry, score_moments(out.score)

        _, ms = jax.lax.scan(body, None,
                             (local_pack, local_tables, local_keys))
        return ms

    return jax.jit(run)
