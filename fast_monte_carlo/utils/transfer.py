"""One-transfer device→host fetch for small pytrees.

Every host materialization (``np.asarray`` of a device array) synchronizes
with the device and pays a fixed per-transfer latency regardless of size,
so an 8-leaf ScoreSummary fetched leaf-by-leaf pays it eight times.
``fetch_tree`` flattens a pytree on device into a single f32 vector,
transfers once, and rebuilds the numpy tree on host.

Integer leaves ride the wire as TWO f32 halves (hi = x >> 16 arithmetic,
lo = x & 0xffff), each an exact small integer in f32 — NOT a bitcast:
a bitcast int32 whose bit pattern happens to be a signaling NaN could be
silently quieted (flipping a mantissa bit) by any float-canonicalizing
hop in the transfer stack.  The split encoding has no NaN/inf patterns
by construction, so counts stay exact at any magnitude on any backend.

This is a latency lever, not a throughput one: pipelined sweeps already
amortize transfers across launches; the resident serving layer's
single-matchup requests do not.  Its worth on the GPU is not yet
measured."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

# dtypes packable into the f32 wire format exactly (4-byte ints split
# into two 16-bit halves; f32 passes through)
_SPLIT = {"int32", "uint32"}

# past this many elements the payload is bandwidth-bound and packing
# stops paying (and int splitting doubles the bytes) — fall back
_MAX_WIRE_ELEMS = 4_000_000


@lru_cache(maxsize=64)
def _packer(spec):
    """Jitted leaf-packer for one (shape, dtype) signature.  AotJit: a warm
    ServeConfig.aot_dir snapshots it along with the launch programs, so a
    fresh serving process compiles nothing (plain jax.jit when no aot dir
    is active)."""
    from .aot import AotJit

    def pack(*leaves):
        flat = []
        for x, (_, dt) in zip(leaves, spec):
            x = jnp.ravel(x)
            if dt in _SPLIT:
                # arithmetic shift keeps int32 sign in hi; lo is 0..65535
                hi = (x >> 16).astype(jnp.float32)
                lo = (x & 0xFFFF).astype(jnp.float32)
                flat += [hi, lo]
            else:
                flat.append(x)
        return jnp.concatenate(flat)
    import hashlib
    return AotJit(pack, key=f"pack_v1_{hashlib.sha256(repr(spec).encode()).hexdigest()[:10]}")


def fetch_tree(tree):
    """Materialize a device pytree on host with ONE device→host transfer.

    Equivalent to ``jax.tree_util.tree_map(np.asarray, tree)`` — exactly,
    for any int32/uint32/float32 leaves — but costs one synchronizing
    transfer instead of one per leaf.  Falls back to the per-leaf path for
    non-array leaves, other dtypes, or an empty tree."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    if not leaves or any(not hasattr(x, "shape") for x in leaves):
        return jax.tree_util.tree_map(np.asarray, tree)
    spec = tuple((tuple(x.shape), jnp.result_type(x).name) for x in leaves)
    if any(dt not in _SPLIT and dt != "float32" for _, dt in spec):
        return jax.tree_util.tree_map(np.asarray, tree)
    if sum(int(np.prod(s, dtype=np.int64)) if s else 1
           for s, _ in spec) > _MAX_WIRE_ELEMS:
        # bulk payloads are bandwidth-bound, not round-trip-bound, and the
        # int hi/lo split would double their wire size — per-leaf is right
        return jax.tree_util.tree_map(np.asarray, tree)
    flat = np.asarray(_packer(spec)(*leaves))
    host, off = [], 0
    for shape, dt in spec:
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if dt in _SPLIT:
            hi = flat[off:off + n].astype(np.int64)
            lo = flat[off + n:off + 2 * n].astype(np.int64)
            seg = ((hi << 16) | lo).astype(dt)
            off += 2 * n
        else:
            seg = flat[off:off + n]
            off += n
        host.append(seg.reshape(shape))
    return jax.tree_util.tree_unflatten(treedef, host)
