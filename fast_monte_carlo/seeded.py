"""Seeded artifact set: model heads and an SP+ sheet made from a seed.

The reference's trained artifacts (xgboost boosters, sklearn quantile
pipelines, the 2025 SP+ sheet) are not shipped with this package.  This
module builds stand-ins at the published shapes so every model-backed mode
runs without them:

  stage-1      188 trees, xgboost depth <= 7, 563 passer one-hot columns +
               the 17 ST1 numerics, ``lt`` splits, zero-as-missing
  quantiles    nine GBR heads (pass/rush/sack x q10/q50/q90), 400 full
               depth-3 trees each, sklearn ``le`` splits
  fumble       104 trees over 1,879 features (1,862 rusher columns + 17)
  stage-2, play policy   absent, as in the reference snapshot (the
               analytic stage-2 and the heuristic play call take over)
  SP+ sheet    137 teams in schema B, the size of the 2025 file

The forests are written directly as FlatForests, so neither xgboost nor
scikit-learn is needed.  Base margins and leaf scales are set so the games
look like football (p(complete) near 0.6, pass-yard quantiles near
0/7/20, totals in the usual range).  The one-hot widths of the quantile
heads' target and rusher groups are not published; they are assumed here
(``_WIDTHS``).

Seeded data is selected explicitly with the spelling ``"seeded:<int>"``
wherever an artifact directory or an SP+ path is accepted; a missing real
path stays an error.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .models.forest import FeatureLayout, FlatForest, stack_nodes
from .models.heads import ST1_FEATURES, ModelHeads

PREFIX = "seeded:"

# one-hot group widths: passer 563 (stage-1, published) and rusher 1,862
# (fumble: 1,879 - 17, published); target is assumed
_WIDTHS = {"passer_name": 563, "target_name": 1400, "rusher_name": 1862}

N_TEAMS = 137

# split-feature weights: mostly the continuous state features, a few
# matchup constants and flags, rarely the two multi-axis flags
_FEATURE_WEIGHTS = {
    "down": 6, "distance": 18, "yardsToGoal": 18, "is_red_zone": 2,
    "score_diff": 12, "seconds_remaining": 14, "offenseTimeouts": 2,
    "defenseTimeouts": 2, "sp_rating_off": 3, "sp_offense_rating_off": 3,
    "sp_defense_rating_def": 3, "sp_rating_def": 3, "goal_to_go": 0.5,
    "fourth_and_short": 0.5, "fg_range": 2, "half": 2, "two_minute": 2,
}


def seed_of(spec) -> Optional[int]:
    """The seed of a ``"seeded:<int>"`` spelling; None for anything else."""
    if not isinstance(spec, str) or not spec.startswith(PREFIX):
        return None
    tail = spec[len(PREFIX):]
    if not tail.isdigit():
        raise ValueError(f"seeded artifacts are spelled 'seeded:<int>', "
                         f"got {spec!r}")
    return int(tail)


def _threshold(rng: np.random.Generator, name: str) -> float:
    if name == "down":
        return float(rng.choice([1.5, 2.5, 3.5]))
    if name == "distance":
        return float(np.round(rng.uniform(0.5, 25.0) * 2) / 2 + 0.25)
    if name == "yardsToGoal":
        return float(rng.integers(1, 99)) + 0.5
    if name == "score_diff":
        return float(rng.integers(-21, 22)) + 0.5
    if name == "seconds_remaining":
        return float(rng.integers(0, 3600)) + 0.5
    if name in ("offenseTimeouts", "defenseTimeouts"):
        return float(rng.choice([0.5, 1.5, 2.5]))
    if name in ("sp_rating_off", "sp_rating_def"):
        return float(rng.uniform(-25.0, 25.0))
    if name in ("sp_offense_rating_off", "sp_defense_rating_def"):
        return float(rng.uniform(15.0, 45.0))
    if name == "half":
        return 1.5
    return 0.5   # 0/1 flags


def _random_tree(rng: np.random.Generator, layout: FeatureLayout,
                 depth: int, p_split: float, leaf_scale: float,
                 cat_share: float, cmp: str) -> dict:
    """One tree as local-index arrays (stack_nodes format), grown breadth
    first: every node above depth 2 splits; deeper nodes split with
    probability p_split (a full tree at 1.0) until `depth` split levels."""
    names = list(_FEATURE_WEIGHTS)
    w = np.asarray([_FEATURE_WEIGHTS[n] for n in names], np.float64)
    w /= w.sum()
    num_base = layout.n_cat
    num_index = {n: i for i, n in enumerate(layout.numeric_names)}
    feat, thresh, left, right, dleft, leaf = [], [], [], [], [], []
    frontier = [(0, 0)]
    feat.append(-1); thresh.append(0.0); left.append(-1); right.append(-1)
    dleft.append(True); leaf.append(0.0)
    while frontier:
        i, d = frontier.pop(0)
        split = d < depth and (p_split >= 1.0 or d < 2
                               or rng.random() < p_split)
        if not split:
            leaf[i] = float(rng.normal() * leaf_scale)
            continue
        if layout.n_cat and rng.random() < cat_share:
            g = int(rng.integers(len(layout.cat_group_sizes)))
            f = layout.cat_group_offsets[g] + int(
                rng.integers(layout.cat_group_sizes[g]))
            th = 1.0 if cmp == "lt" else 0.5
        else:
            name = names[int(rng.choice(len(names), p=w))]
            f = num_base + num_index[name]
            th = _threshold(rng, name)
        li, ri = len(feat), len(feat) + 1
        for _ in range(2):
            feat.append(-1); thresh.append(0.0); left.append(-1)
            right.append(-1); dleft.append(True); leaf.append(0.0)
        feat[i], thresh[i], left[i], right[i] = f, th, li, ri
        dleft[i] = bool(rng.random() < 0.5)
        frontier += [(li, d + 1), (ri, d + 1)]
    return dict(feat=feat, thresh=thresh, left=left, right=right,
                default_left=dleft, leaf=leaf)


def _layout(groups: Sequence[str]) -> FeatureLayout:
    return FeatureLayout(
        cat_group_names=tuple(groups),
        cat_group_sizes=tuple(_WIDTHS[g] for g in groups),
        numeric_names=ST1_FEATURES,
        categories={g: tuple(f"{g}_{i:04d}" for i in range(_WIDTHS[g]))
                    for g in groups},
    )


def _forest(rng: np.random.Generator, *, groups, n_trees, depth, p_split,
            base, leaf_scale, cmp, link, name, zero_as_missing=False,
            cat_share=0.1) -> FlatForest:
    layout = _layout(groups)
    trees = [_random_tree(rng, layout, depth, p_split, leaf_scale,
                          cat_share, cmp) for _ in range(n_trees)]
    return stack_nodes(trees, layout, tree_class=[0] * n_trees, n_classes=1,
                       base_margin=np.asarray([base], np.float32), link=link,
                       cmp=cmp, name=name, zero_as_missing=zero_as_missing)


# (head, one-hot groups, (q10, q50, q90) base values in yards)
_QUANT_HEADS = (
    ("pass_quants", ("passer_name", "target_name"), (1.0, 8.0, 22.0)),
    ("rush_quants", ("rusher_name",), (-1.0, 4.0, 10.0)),
    ("sack_quants", ("passer_name",), (-11.0, -7.0, -3.0)),
)


def seeded_heads(seed: int) -> ModelHeads:
    """ModelHeads at the published shapes, a pure function of `seed`."""
    def rng_for(i):
        return np.random.default_rng([seed, i])

    out: Dict[str, object] = {}
    # logit(0.6) base; margin sd ~0.35 across states over 188 trees
    out["stage1"] = _forest(
        rng_for(0), groups=("passer_name",), n_trees=188, depth=7,
        p_split=0.65, base=float(np.log(0.6 / 0.4)),
        leaf_scale=0.35 / np.sqrt(188), cmp="lt", link="sigmoid",
        name="stage1", zero_as_missing=True)
    for h, (attr, groups, bases) in enumerate(_QUANT_HEADS):
        trio = tuple(
            _forest(rng_for(1 + 3 * h + q), groups=groups, n_trees=400,
                    depth=3, p_split=1.0, base=b, leaf_scale=1.5 / 20.0,
                    cmp="le", link="identity",
                    name=f"{attr[:-7]}_q{(10, 50, 90)[q]}")
            for q, b in enumerate(bases))
        out[attr] = trio
    # logit(0.012) base: about one lost fumble per team-game
    out["fumble"] = _forest(
        rng_for(10), groups=("rusher_name",), n_trees=104, depth=6,
        p_split=0.6, base=float(np.log(0.012 / 0.988)),
        leaf_scale=0.3 / np.sqrt(104), cmp="lt", link="sigmoid",
        name="fumble", zero_as_missing=True)
    return ModelHeads(**out)


def team_names(n: int = N_TEAMS) -> Tuple[str, ...]:
    """Seeded team names, best SP+ rating first: 'Team 001', ..."""
    return tuple(f"Team {i:03d}" for i in range(1, n + 1))


def seeded_sp_sheet(seed: int):
    """An SP+ sheet in schema B ('Current SP+', 'Past SP+', 'Rating',
    'Offense Rating', 'Defense Rating'), 137 rows, sorted by rating.
    Ratings follow SP+'s identity Rating = Offense - Defense."""
    import pandas as pd

    rng = np.random.default_rng([seed, 1000])
    rating = np.sort(rng.normal(0.0, 12.0, N_TEAMS))[::-1]
    offense = 30.0 + 0.5 * rating + rng.normal(0.0, 3.0, N_TEAMS)
    names = team_names()
    past = list(names)
    rng.shuffle(past)
    return pd.DataFrame({
        "Current SP+": names, "Past SP+": past,
        "Rating": np.round(rating, 1),
        "Offense Rating": np.round(offense, 1),
        "Defense Rating": np.round(np.round(offense, 1) - np.round(rating, 1), 1),
    })
