"""Golden tests for the tree-ensemble compiler against the reference artifacts.

- sklearn GBR pipelines: compiled FlatForest must match Pipeline.predict
  exactly (fp64 tolerance) on random plausible inputs.
- xgboost JSON models: compiled FlatForest must match an independent
  recursive walk of the raw JSON trees (written here, separately from the
  flattener) node for node.
"""
import json

import numpy as np
import pandas as pd
import pytest

from fast_monte_carlo.compat import load_sklearn_artifact
from fast_monte_carlo.models import (
    FlatForest,
    forest_from_gbr_pipeline,
    forest_from_xgb_json,
    load_xgb_json,
)
from fast_monte_carlo.models.sklearn_gbr import layout_from_column_transformer

from conftest import make_state_batch

ST_ORDER = [
    "down", "distance", "yardsToGoal", "is_red_zone", "score_diff",
    "seconds_remaining", "offenseTimeouts", "defenseTimeouts",
    "sp_rating_off", "sp_offense_rating_off", "sp_defense_rating_def",
    "sp_rating_def", "goal_to_go", "fourth_and_short", "fg_range",
    "half", "two_minute",
]


def _frame_and_arrays(cols, layout, rng, n):
    df = pd.DataFrame(cols)
    x = np.column_stack([cols[c] for c in layout.numeric_names])
    cat_ids = {}
    for g in layout.cat_group_names:
        cats = list(layout.categories[g])
        # mix of known and unknown names
        picks = rng.integers(-1, len(cats), n)
        names = [cats[p] if p >= 0 else f"__unseen_{i}" for i, p in enumerate(picks)]
        df[g] = names
        cat_ids[g] = np.where(picks >= 0, picks, -1)
    return df, x, cat_ids


@pytest.mark.parametrize("stem", [
    "pass_yards_q10", "pass_yards_q50", "pass_yards_q90",
    "run_yards_q10", "run_yards_q50", "run_yards_q90",
    "sack_yards_q10", "sack_yards_q50", "sack_yards_q90",
])
def test_gbr_pipeline_exact(reference_dir, rng, stem):
    pipe = load_sklearn_artifact(reference_dir / f"{stem}.joblib")
    forest = forest_from_gbr_pipeline(pipe, name=stem)
    n = 512
    cols = make_state_batch(rng, n)
    df, x, cat_ids = _frame_and_arrays(cols, forest.layout, rng, n)
    want = pipe.predict(df)
    got = forest.predict_np(x, cat_ids)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _recursive_xgb_margin(model, x_dense):
    """Independent oracle: walk raw JSON trees recursively."""
    learner = model["learner"]
    trees = learner["gradient_booster"]["model"]["trees"]
    tree_info = learner["gradient_booster"]["model"]["tree_info"]
    num_class = max(1, int(learner["learner_model_param"]["num_class"]))
    out = np.zeros((x_dense.shape[0], num_class))
    for t, cls in zip(trees, tree_info):
        left = t["left_children"]
        right = t["right_children"]
        sidx = t["split_indices"]
        cond = t["split_conditions"]
        dleft = t["default_left"]
        for b in range(x_dense.shape[0]):
            i = 0
            while left[i] != -1:
                v = x_dense[b, sidx[i]]
                if v == 0.0:  # CSR sparse zero == missing to xgboost
                    go_left = bool(dleft[i])
                else:
                    go_left = v < cond[i]
                i = left[i] if go_left else right[i]
            out[b, cls] += cond[i]
    return out


def test_xgb_stage1_matches_recursive(reference_dir, rng):
    model = load_xgb_json(reference_dir / "pass_stage1_complete_vs_not.json")
    pre = load_sklearn_artifact(reference_dir / "pass_stage1_preprocessor.joblib")
    layout = layout_from_column_transformer(pre)
    forest = forest_from_xgb_json(model, layout, name="stage1")
    assert forest.n_trees == 188
    assert forest.link == "sigmoid"

    n = 64
    cols = make_state_batch(rng, n)
    _, x, cat_ids = _frame_and_arrays(cols, layout, rng, n)

    # dense one-hot matrix for the recursive oracle
    dense = np.zeros((n, layout.n_features), dtype=np.float64)
    off = layout.cat_group_offsets[0]
    ids = cat_ids[layout.cat_group_names[0]]
    for b, pid in enumerate(ids):
        if pid >= 0:
            dense[b, off + pid] = 1.0
    dense[:, layout.n_cat:] = x

    want_margin = _recursive_xgb_margin(model, dense)[:, 0]
    got_margin = forest.eval_margin_np(x, cat_ids)[:, 0] - forest.base_margin[0]
    np.testing.assert_allclose(got_margin, want_margin, rtol=1e-5, atol=1e-5)

    p = forest.predict_np(x, cat_ids)
    assert ((p > 0) & (p < 1)).all()
    assert 0.25 < p.mean() < 0.95  # completion-ish probabilities on random states


def test_xgb_fumble_compiles(reference_dir, rng):
    model = load_xgb_json(reference_dir / "run_fumble.json")
    pre = load_sklearn_artifact(reference_dir / "run_fumble_preprocessor.joblib")
    layout = layout_from_column_transformer(pre)
    forest = forest_from_xgb_json(model, layout, name="fumble")
    n = 64
    cols = make_state_batch(rng, n)
    _, x, cat_ids = _frame_and_arrays(cols, layout, rng, n)
    p = forest.predict_np(x, cat_ids)
    assert ((p >= 0) & (p <= 1)).all()
    assert p.mean() < 0.10  # fumbles are rare


def test_threshold_introspection(reference_dir):
    model = load_xgb_json(reference_dir / "pass_stage1_complete_vs_not.json")
    pre = load_sklearn_artifact(reference_dir / "pass_stage1_preprocessor.joblib")
    layout = layout_from_column_transformer(pre)
    forest = forest_from_xgb_json(model, layout)
    thr = forest.numeric_thresholds()
    assert "down" in thr and len(thr["down"]) <= 4
    used = forest.used_cat_locals("passer_name")
    assert used.size > 0
