"""What keeps the GPU path honest when it is run here, on the CPU: the
smoke script and the bench refuse to run without a GPU, the compile cache
resolves to one fixed place, and rng_impl takes only what XLA provides."""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from fast_monte_carlo.config import EngineConfig, SimConfig

REPO = Path(__file__).resolve().parents[1]


def _cpu_env():
    return {**os.environ, "JAX_PLATFORMS": "cpu"}


def test_chip_smoke_refuses_cpu():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=_cpu_env())
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs 1 GPU" in proc.stderr


def test_chip_smoke_multi_refuses_cpu():
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--multi"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=_cpu_env())
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repo, the script has nothing to run and fails."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in _cpu_env().items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from fast_monte_carlo.utils import compile_cache as cc

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.compile_cache_dir() == str(tmp_path)

    calls = []
    import jax
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert calls == []      # the env var is JAX's own; nothing set in code


def test_compile_cache_fixed_path_otherwise(monkeypatch):
    from fast_monte_carlo.utils import compile_cache as cc

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cc.compile_cache_dir() == str(REPO / ".jax_cache")
    calls = []
    import jax
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    cc.enable_compile_cache()
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]


@pytest.mark.parametrize("impl", ["pallas", "pallas_chunk", "philox", ""])
def test_rng_impl_rejects_unknown(impl):
    with pytest.raises(ValueError, match="rng_impl"):
        EngineConfig(rng_impl=impl)
    cfg = SimConfig()
    with pytest.raises(ValueError, match="rng_impl"):
        dataclasses.replace(cfg.engine, rng_impl=impl)


@pytest.mark.parametrize("impl", ["threefry", "rbg"])
def test_rng_impl_accepts_xla_generators(impl):
    assert EngineConfig(rng_impl=impl).rng_impl == impl


def test_cli_bench_runs_in_process(monkeypatch):
    """`cli bench` calls bench.main in the same process (a child process
    could not get the card while the parent holds it)."""
    from fast_monte_carlo import cli

    monkeypatch.setattr(subprocess, "call", lambda *a, **k: pytest.fail(
        "cli bench must not spawn a process"))
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail(
        "cli bench must not spawn a process"))
    # on the CPU the bench refuses to measure and returns non-zero
    assert cli.main(["bench", "-n", "64"]) != 0
