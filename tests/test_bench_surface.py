"""The bench surface: `python bench.py --smoke` must run end to end on CPU
with the seeded inputs and print exactly one parseable JSON line with the
contract fields and the self-describing `meta` block."""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _run(*extra, timeout=900):
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--smoke", *extra],
        capture_output=True, text=True, timeout=timeout, cwd=REPO)
    return proc


def _one_json_line(proc):
    lines = [l for l in proc.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, f"expected ONE json line on stdout, got: {lines}"
    return json.loads(lines[0])


def test_bench_smoke_json_contract():
    proc = _run("--repeats", "1")
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = _one_json_line(proc)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "meta"}
    assert rec["unit"] == "games/sec" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 40.0, 1)
    # the meta block makes BENCH_r* files self-describing across rounds
    meta = rec["meta"]
    assert {"n_games", "chunk_games", "rng", "mode", "workload", "stats",
            "quality", "ndev", "sharded", "device", "setup_s", "compile_s",
            "runs"} <= set(meta)
    assert meta["device"]["platform"] == "cpu" and len(meta["runs"]) >= 1
    # sanity block goes to stderr, not stdout
    assert "sanity" in proc.stderr


def test_bench_shard_smoke():
    """--shard runs the trial-sharded moments pipeline over the visible
    mesh and marks the metric + meta accordingly."""
    proc = _run("--repeats", "1", "--shard", "-n", "512", "--chunk", "128")
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = _one_json_line(proc)
    assert rec["metric"].endswith("_sharded")
    assert rec["meta"]["sharded"] is True and rec["meta"]["ndev"] >= 1


def test_bench_without_gpu_measures_nothing():
    """Outside --smoke the bench refuses a CPU backend: it exits non-zero
    and prints no JSON rather than timing the CPU."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "-n", "64", "--no-lanes"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "no GPU" in proc.stderr
