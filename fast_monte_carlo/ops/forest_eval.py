"""Device-side FlatForest evaluation (exact mode).

The FlatForest node soup becomes a pytree of jnp arrays with per-node
metadata pre-resolved host-side (numeric index vs categorical group/local
id), and evaluation is a depth-bounded vectorized gather walk — the same
algorithm as FlatForest.eval_margin_np, traced once under jit.

Class aggregation is a (B,T) x (T,C) matmul at HIGHEST precision (float32,
no TF32 rounding of leaf values).  Total node storage across every head in
the reference is ~75k nodes (~1.5 MB).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.forest import FlatForest


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class JaxForest:
    """Device representation of a FlatForest (metadata fields are static).

    All per-node metadata lives in ONE (N, 8) f32 table so each walk level
    costs a single gather instead of seven: on the earlier chip per-row
    gather latency dominated and extra channels were nearly free."""

    nodes: jnp.ndarray         # (N, 8) f32: [num_idx, is_cat, cat_group,
                               #  cat_local, thresh, left, right, default_left]
    leaf: jnp.ndarray          # (N,) float32
    roots: jnp.ndarray         # (T,) int32
    class_matrix: jnp.ndarray  # (T, C) float32 one-hot tree->class
    base_margin: jnp.ndarray   # (C,) float32
    max_depth: int = field(metadata=dict(static=True))
    n_classes: int = field(metadata=dict(static=True))
    link: str = field(metadata=dict(static=True))
    cmp_lt: bool = field(metadata=dict(static=True))
    zero_as_missing: bool = field(metadata=dict(static=True))
    group_names: Tuple[str, ...] = field(metadata=dict(static=True))
    numeric_names: Tuple[str, ...] = field(metadata=dict(static=True))


def pack_forest(f: FlatForest) -> JaxForest:
    lay = f.layout
    ncat = lay.n_cat
    feat = f.feat
    internal = feat >= 0
    is_cat = internal & (feat < ncat)
    num_idx = np.where(internal & ~is_cat, feat - ncat, 0).astype(np.int32)
    cat_group = np.zeros_like(feat, dtype=np.int32)
    cat_local = np.zeros_like(feat, dtype=np.int32)
    for g, (off, size) in enumerate(zip(lay.cat_group_offsets, lay.cat_group_sizes)):
        in_g = is_cat & (feat >= off) & (feat < off + size)
        cat_group = np.where(in_g, g, cat_group)
        cat_local = np.where(in_g, feat - off, cat_local)
    class_matrix = np.zeros((f.n_trees, f.n_classes), dtype=np.float32)
    class_matrix[np.arange(f.n_trees), f.tree_class] = 1.0
    # leaves: make left/right self-loops so a finished walk stays put
    idx = np.arange(f.n_nodes, dtype=np.int32)
    left = np.where(internal, f.left, idx).astype(np.int32)
    right = np.where(internal, f.right, idx).astype(np.int32)
    # one (N, 8) f32 node table -> one gather per walk level.  Exact int
    # round-trip through f32 holds for every field (indices < 2^24).
    nodes = np.stack([
        num_idx.astype(np.float32),
        is_cat.astype(np.float32),
        cat_group.astype(np.float32),
        cat_local.astype(np.float32),
        f.thresh.astype(np.float32),
        left.astype(np.float32),
        right.astype(np.float32),
        f.default_left.astype(np.float32),
    ], axis=1)
    return JaxForest(
        nodes=jnp.asarray(nodes),
        leaf=jnp.asarray(f.leaf),
        roots=jnp.asarray(f.roots),
        class_matrix=jnp.asarray(class_matrix),
        base_margin=jnp.asarray(f.base_margin),
        max_depth=int(f.max_depth),
        n_classes=int(f.n_classes),
        link=f.link,
        cmp_lt=(f.cmp == "lt"),
        zero_as_missing=bool(f.zero_as_missing),
        group_names=tuple(lay.cat_group_names),
        numeric_names=tuple(lay.numeric_names),
    )


def eval_margin(jf: JaxForest, x_num: jnp.ndarray, cat_ids: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """Raw margins (B, C).  x_num: (B, n_numeric) f32; cat_ids: group -> (B,) i32."""
    B = x_num.shape[0]
    T = jf.roots.shape[0]
    # (B, G) matrix of the trial's category id per group
    if jf.group_names:
        cid = jnp.stack(
            [cat_ids.get(g, jnp.full((B,), -1, jnp.int32)).astype(jnp.int32)
             for g in jf.group_names], axis=1)
    else:
        cid = jnp.zeros((B, 1), jnp.int32)

    node = jnp.broadcast_to(jf.roots[None, :], (B, T)).astype(jnp.int32)

    def body(_, node):
        # ONE gather per level: all node metadata rides as channels
        # (per-row gather latency dominates; channels are nearly free)
        nd = jnp.take(jf.nodes, node.reshape(-1), axis=0,
                      mode="clip").reshape(B, T, 8)
        f_num = nd[..., 0].astype(jnp.int32)
        is_cat = nd[..., 1] != 0.0
        grp = nd[..., 2].astype(jnp.int32)
        cat_local = nd[..., 3].astype(jnp.int32)
        th = nd[..., 4]
        left = nd[..., 5].astype(jnp.int32)
        right = nd[..., 6].astype(jnp.int32)
        numv = jnp.take_along_axis(x_num, f_num, axis=1)
        trial_cat = jnp.take_along_axis(cid, grp, axis=1)
        catv = (trial_cat == cat_local).astype(x_num.dtype)
        val = jnp.where(is_cat, catv, numv)
        go_left = (val < th) if jf.cmp_lt else (val <= th)
        if jf.zero_as_missing:
            go_left = jnp.where(val == 0.0, nd[..., 7] != 0.0, go_left)
        return jnp.where(go_left, left, right)

    node = jax.lax.fori_loop(0, jf.max_depth, body, node)
    leaf_vals = jnp.take(jf.leaf, node, mode="clip")    # (B, T)
    margins = jnp.dot(leaf_vals, jf.class_matrix,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)
    return margins + jf.base_margin[None, :]


def predict(jf: JaxForest, x_num, cat_ids) -> jnp.ndarray:
    m = eval_margin(jf, x_num, cat_ids)
    if jf.link == "identity":
        return m[:, 0] if jf.n_classes == 1 else m
    if jf.link == "sigmoid":
        return jax.nn.sigmoid(m[:, 0])
    return jax.nn.softmax(m, axis=1)


# ---------------------------------------------------------------------------
# merged multi-forest evaluation: ONE gather walk for every head
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MergedForest:
    """Every head's trees in one node soup, walked together.

    Walking ALL ~4.7k trees as one (B, T_total) front needs max_depth x 3
    ops total instead of ~200 per-forest ops per play step.  OFF by
    default (EngineConfig.exact_merged): total gathered rows are identical
    either way, and on the earlier chip the merged 75k-row node table sat
    past a gather row-count cliff, so it measured negative there.  Not yet
    measured on the GPU.

    Per-node channels (N, 10): [num_idx, is_cat, cat_col, cat_local,
    thresh, left, right, default_left, cmp_lt, zero_as_missing] — the last
    two are per-node because xgboost ('lt', zero-as-missing) and sklearn
    ('le') forests merge into one table.  num_idx indexes the SHARED ST1
    feature row; cat_col indexes the caller-built (B, G) per-trial category
    id matrix (one column per (head, cat-group): id spaces differ per head).
    Class aggregation is one (B,T)x(T,C_total) matmul against a
    block-diagonal tree->column matrix; `slices` maps head name ->
    (col_start, n_classes)."""

    nodes: jnp.ndarray         # (N, 10) f32
    leaf: jnp.ndarray          # (N,)
    roots: jnp.ndarray         # (T,)
    class_matrix: jnp.ndarray  # (T, C_total)
    base_margin: jnp.ndarray   # (C_total,)
    max_depth: int = field(metadata=dict(static=True))
    slices: Tuple[Tuple[str, int, int], ...] = field(
        metadata=dict(static=True), default=())
    cat_cols: Tuple[str, ...] = field(metadata=dict(static=True), default=())


def merge_forests(named: "list[tuple[str, object, dict]]",
                  feature_order: "tuple[str, ...]") -> MergedForest:
    """named: [(head_name, FlatForest, {group_name: cat_col_label})].
    feature_order: the shared numeric row layout (ST1_FEATURES)."""
    nodes_l, leaf_l, roots_l = [], [], []
    class_blocks = []
    base_l = []
    slices = []
    cat_cols: list = []
    node_base = 0
    col_base = 0
    tree_counts = []
    max_depth = 1
    for name, f, cat_map in named:
        lay = f.layout
        ncat = lay.n_cat
        feat = f.feat
        internal = feat >= 0
        is_cat = internal & (feat < ncat)
        # numeric index remapped into the shared feature row
        remap = np.asarray(
            [feature_order.index(n) for n in lay.numeric_names], np.int32)
        num_idx = np.where(internal & ~is_cat,
                           remap[np.clip(feat - ncat, 0, len(remap) - 1)], 0)
        # categorical group -> merged cid column
        cat_col = np.zeros_like(feat, dtype=np.int32)
        cat_local = np.zeros_like(feat, dtype=np.int32)
        for g, (off, size) in enumerate(zip(lay.cat_group_offsets,
                                            lay.cat_group_sizes)):
            label = cat_map[lay.cat_group_names[g]]
            if label not in cat_cols:
                cat_cols.append(label)
            gcol = cat_cols.index(label)
            in_g = is_cat & (feat >= off) & (feat < off + size)
            cat_col = np.where(in_g, gcol, cat_col)
            cat_local = np.where(in_g, feat - off, cat_local)
        idx = np.arange(f.n_nodes, dtype=np.int32)
        left = np.where(internal, f.left, idx) + node_base
        right = np.where(internal, f.right, idx) + node_base
        nodes_l.append(np.stack([
            num_idx.astype(np.float32),
            is_cat.astype(np.float32),
            cat_col.astype(np.float32),
            cat_local.astype(np.float32),
            f.thresh.astype(np.float32),
            left.astype(np.float32),
            right.astype(np.float32),
            f.default_left.astype(np.float32),
            np.full(f.n_nodes, 1.0 if f.cmp == "lt" else 0.0, np.float32),
            np.full(f.n_nodes, 1.0 if f.zero_as_missing else 0.0, np.float32),
        ], axis=1))
        leaf_l.append(f.leaf.astype(np.float32))
        roots_l.append(f.roots.astype(np.int32) + node_base)
        cm = np.zeros((f.n_trees, f.n_classes), np.float32)
        cm[np.arange(f.n_trees), f.tree_class] = 1.0
        class_blocks.append(cm)
        base_l.append(f.base_margin.astype(np.float32))
        slices.append((name, col_base, int(f.n_classes)))
        tree_counts.append(f.n_trees)
        node_base += f.n_nodes
        col_base += f.n_classes
        max_depth = max(max_depth, int(f.max_depth))
    t_total = int(sum(tree_counts))
    class_matrix = np.zeros((t_total, col_base), np.float32)
    r = 0
    for (name, cb, nc), cm in zip(slices, class_blocks):
        class_matrix[r:r + cm.shape[0], cb:cb + nc] = cm
        r += cm.shape[0]
    return MergedForest(
        nodes=jnp.asarray(np.concatenate(nodes_l, axis=0)),
        leaf=jnp.asarray(np.concatenate(leaf_l)),
        roots=jnp.asarray(np.concatenate(roots_l)),
        class_matrix=jnp.asarray(class_matrix),
        base_margin=jnp.asarray(np.concatenate(base_l)),
        max_depth=max_depth,
        slices=tuple(slices),
        cat_cols=tuple(cat_cols),
    )


def eval_merged(mf: MergedForest, x_num: jnp.ndarray,
                cid: jnp.ndarray) -> jnp.ndarray:
    """All heads' margins (B, C_total) in one depth-bounded walk.
    cid: (B, G) int32, columns in mf.cat_cols order."""
    B = x_num.shape[0]
    T = mf.roots.shape[0]
    node = jnp.broadcast_to(mf.roots[None, :], (B, T)).astype(jnp.int32)

    def body(_, node):
        nd = jnp.take(mf.nodes, node.reshape(-1), axis=0,
                      mode="clip").reshape(B, T, 10)
        f_num = nd[..., 0].astype(jnp.int32)
        is_cat = nd[..., 1] != 0.0
        grp = nd[..., 2].astype(jnp.int32)
        cat_local = nd[..., 3].astype(jnp.int32)
        th = nd[..., 4]
        left = nd[..., 5].astype(jnp.int32)
        right = nd[..., 6].astype(jnp.int32)
        numv = jnp.take_along_axis(x_num, f_num, axis=1)
        trial_cat = jnp.take_along_axis(cid, grp, axis=1)
        catv = (trial_cat == cat_local).astype(x_num.dtype)
        val = jnp.where(is_cat, catv, numv)
        go_left = jnp.where(nd[..., 8] != 0.0, val < th, val <= th)
        go_left = jnp.where((nd[..., 9] != 0.0) & (val == 0.0),
                            nd[..., 7] != 0.0, go_left)
        return jnp.where(go_left, left, right)

    node = jax.lax.fori_loop(0, mf.max_depth, body, node)
    leaf_vals = jnp.take(mf.leaf, node, mode="clip")
    return jnp.dot(leaf_vals, mf.class_matrix,
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32) + mf.base_margin[None, :]
