"""Build the committed reconstructed-mode artifact overlay (VERDICT r4 #6).

Produces `fast_monte_carlo/artifacts/reconstructed/`:

* `pass_stage2_sklearn.joblib` (+ classes csv / eval dump) — the
  snapshot-missing stage-2 booster, reconstructed by
  `train.pipeline.reconstruct_stage2` (oracle-sampled dropback states,
  analytic-conditional labels with logit jitter; the reference's own
  artifact cannot be recovered — SURVEY §0.1).
* `calibration.json` — a NON-unit softmax temperature for the recovered
  5-class play model, fitted with the pipeline's own
  `temperature_calibrate` grid (train_play_model.py:173-187 recipe)
  against pass/run labels drawn from the as-executed heuristic policy on
  the same oracle-sampled states.  A documented stand-in: the snapshot
  ships no calibration.json (the reference ran T=1.0 as-executed,
  fast_monte_carlo_cfb.py:335); this exercises the full temperature path
  end-to-end.  Swap labels for real CFBD outcomes when data files exist.

Deterministic (fixed seeds) — rerunning reproduces the committed
artifacts up to sklearn's own training determinism.

Usage: python benchmarks/build_reconstructed.py
"""
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import numpy as np

from fast_monte_carlo.data import build_team_context_from_sp_flex, load_sp_flex
from fast_monte_carlo.models import analytic
from fast_monte_carlo.models.heads import load_heads
from fast_monte_carlo.config import SimConfig
from fast_monte_carlo.train import pipeline as P

OUT = REPO / "fast_monte_carlo" / "artifacts" / "reconstructed"
OUT.mkdir(parents=True, exist_ok=True)

sp = load_sp_flex("/root/reference/PregameSPPlus2025_1.csv")
A = build_team_context_from_sp_flex("Kansas State", 2025, 1, sp)
B = build_team_context_from_sp_flex("Iowa State", 2025, 1, sp)
heads = load_heads("/root/reference")
cfg = SimConfig()

print("== stage-2 reconstruction ==", flush=True)
path = P.reconstruct_stage2(A, B, heads, OUT, cfg=cfg, n_games=96,
                            seed=123, label_seed=7)
print(f"  wrote {path.name}")

print("== play-model temperature calibration ==", flush=True)
df = P.sample_dropback_states(A, B, heads, cfg=cfg, n_games=96, seed=321)
forest = heads.play
assert forest is not None, "recovered play_model.xgb failed to load"
x = df[list(forest.layout.numeric_names)].to_numpy(np.float32)
# coach is a stand-in constant (sampled states don't record the side);
# temperature is a global scalar, insensitive to the coach column
cat = {g: np.zeros(len(df), np.int64) for g in forest.layout.cat_group_names}
margins = forest.eval_margin_np(x, cat)
rng = np.random.default_rng(99)
p_pass = analytic.pass_prob_v1(
    df["down"].to_numpy(), df["distance"].to_numpy(),
    df["yardsToGoal"].to_numpy(), df["seconds_remaining"].to_numpy(),
    df["score_diff"].to_numpy(), cfg)
lab_name = np.where(rng.random(len(df)) < p_pass, "pass", "run")
classes = ("field_goal", "pass", "punt", "run", "timeout")
y = np.asarray([classes.index(c) for c in lab_name])
t = P.temperature_calibrate(margins, y)
(OUT / "calibration.json").write_text(json.dumps(
    {"temperature": t,
     "note": "fitted vs heuristic-policy labels on oracle-sampled "
             "states (build_reconstructed.py); reference as-executed "
             "had no calibration.json (T=1.0)"}))
print(f"  temperature = {t}")
print("\nartifacts:", sorted(p.name for p in OUT.iterdir()))
