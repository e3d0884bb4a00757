"""fetch_tree: the one-round-trip pytree readback must be bitwise equal to
the per-leaf np.asarray path (int leaves ride the f32 wire bitcast)."""
import jax
import jax.numpy as jnp
import numpy as np

from fast_monte_carlo.utils.transfer import fetch_tree


def test_fetch_tree_matches_per_leaf():
    tree = {
        "scalar": jnp.asarray(3.5, jnp.float32),
        "vec": jnp.arange(5, dtype=jnp.float32) * 0.25,
        "mat": jnp.arange(6, dtype=jnp.int32).reshape(2, 3),
        "nested": (jnp.asarray([1, 2], jnp.int32),
                   jnp.asarray([[0.1], [0.2]], jnp.float32)),
    }
    got = fetch_tree(tree)
    want = jax.tree_util.tree_map(np.asarray, tree)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_fetch_tree_int_exact_past_f32_mantissa():
    """Counts above 2^24 would round if CAST to f32; the split wire
    format keeps them exact.  2139095041 (0x7F800001) is the value whose
    BITCAST image is a signaling NaN — a NaN-canonicalizing transfer hop
    would silently flip it, which is why the wire format is hi/lo halves
    rather than a bitcast."""
    vals = [16_777_217, 2**31 - 1, -7, 2139095041, -2**31, 0]
    out = fetch_tree({"h": jnp.asarray(vals, jnp.int32)})["h"]
    np.testing.assert_array_equal(out, np.asarray(vals, np.int32))
    u = [0, 2**32 - 1, 2139095041, 65536]
    outu = fetch_tree({"u": jnp.asarray(u, jnp.uint32)})["u"]
    np.testing.assert_array_equal(outu, np.asarray(u, np.uint32))


def test_fetch_tree_python_scalar_leaf_falls_back():
    """Documented drop-in equivalence: trees carrying plain Python
    scalars must transfer (per-leaf fallback), not crash on .shape."""
    out = fetch_tree({"n": 5, "x": jnp.ones(3, jnp.float32)})
    assert out["n"] == 5
    np.testing.assert_array_equal(out["x"], np.ones(3, np.float32))


def test_fetch_tree_summary_roundtrip():
    """The production payload: a ScoreSummary fetched packed equals the
    per-leaf readback bit for bit."""
    from fast_monte_carlo.parallel import summarize_scores

    score = jnp.asarray(np.random.default_rng(0).integers(0, 80, (512, 2)),
                        jnp.int32)
    s = jax.jit(summarize_scores)(score)
    got = fetch_tree(s)
    want = jax.tree_util.tree_map(np.asarray, s)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_fetch_tree_fallback_on_unpackable_dtype():
    tree = {"b": jnp.asarray([True, False]), "f": jnp.ones(3, jnp.float32)}
    got = fetch_tree(tree)
    assert got["b"].dtype == np.bool_
    np.testing.assert_array_equal(got["b"], [True, False])


def test_fetch_tree_empty():
    assert fetch_tree({}) == {}
