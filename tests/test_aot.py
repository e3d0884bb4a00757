"""AOT executable snapshots (utils/aot.py): save once, boot with zero
compiles.  The round trip runs in a clean single-device CPU subprocess:
under this suite's FORCED 8-device host mesh, jax 0.9.0's deserialized
executables reconstruct an 8-shard device assignment while reporting
single-device input shardings and refuse plain-array calls — a
multi-virtual-device artifact of the host mesh."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import sys, json
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from fast_monte_carlo.utils.aot import aot_compile_cached

traces = []
def f(x):
    traces.append(1)
    return jnp.sin(x @ x.T).sum() + 12345.0

tmp = sys.argv[1]
x = jnp.ones((64, 64), jnp.float32)
exe1 = aot_compile_cached(f, (x,), key="t", cache_dir=tmp)
want = float(exe1(x))
n_files1 = len(list(__import__("pathlib").Path(tmp).glob("t_*.aotx")))

exe2 = aot_compile_cached(f, (x,), key="t", cache_dir=tmp)
got = float(exe2(x))

y = jnp.ones((32, 32), jnp.float32)
exe3 = aot_compile_cached(f, (y,), key="t", cache_dir=tmp)
ok3 = bool(jnp.isfinite(exe3(y)))
n_files2 = len(list(__import__("pathlib").Path(tmp).glob("t_*.aotx")))

# corrupt snapshot falls back to a fresh compile
p = sorted(__import__("pathlib").Path(tmp).glob("t_*.aotx"))[0]
p.write_bytes(b"garbage")
exe4 = aot_compile_cached(f, (x,), key="t", cache_dir=tmp)
got4 = float(exe4(x))

print(json.dumps({{"want": want, "got": got, "got4": got4, "ok3": ok3,
                   "traces": len(traces), "n1": n_files1, "n2": n_files2}}))
"""


def test_aot_snapshot_roundtrip(tmp_path):
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
           "HOME": "/root"}
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(repo=str(REPO)),
         str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["got"] == out["want"]          # snapshot load, same result
    assert out["got4"] == out["want"]         # corrupt file -> recompile
    assert out["ok3"]
    # traces: exe1 compile + exe3 (new signature) = 2; exe2 loaded the
    # snapshot without retracing, and exe4's corrupt-fallback recompile
    # reuses jax's in-process trace cache (same fn + avals)
    assert out["traces"] == 2
    assert out["n1"] == 1 and out["n2"] == 2  # one snapshot per signature


def test_aot_fingerprint_keys_on_signature():
    import jax.numpy as jnp

    from fast_monte_carlo.utils.aot import aot_fingerprint

    x = jnp.ones((8, 8)), jnp.zeros((4,), jnp.int32)
    assert aot_fingerprint("a", x) == aot_fingerprint("a", x)
    assert aot_fingerprint("a", x) != aot_fingerprint("b", x)
    y = jnp.ones((8, 8)), jnp.zeros((5,), jnp.int32)
    assert aot_fingerprint("a", x) != aot_fingerprint("a", y)
    # static args key by VALUE: a chunk-size change must miss the snapshot
    z24 = (jnp.ones((8, 8)), 24)
    z48 = (jnp.ones((8, 8)), 48)
    assert aot_fingerprint("a", z24, (1,)) != aot_fingerprint("a", z48, (1,))
    # and non-arraylike statics don't crash the fingerprint
    assert aot_fingerprint("a", (jnp.ones((4,)), "mode"), (1,))


def test_aotjit_inactive_is_plain_jit(tmp_path):
    import jax.numpy as jnp

    from fast_monte_carlo.utils.aot import AotJit, get_aot_dir

    assert get_aot_dir() is None
    g = AotJit(lambda x, n: (x * n).sum(), key="t1", static_argnums=(1,))
    x = jnp.arange(8.0)
    assert float(g(x, 3)) == float((x * 3).sum())
    assert not list(tmp_path.glob("*.aotx"))   # nothing written when off


def test_aotjit_active_snapshots_and_falls_back(tmp_path):
    """Active AotJit: same results as jit, one snapshot per signature, and
    a SECOND instance (a fresh process stand-in) that hits the
    deserialized-executable path still answers correctly — under this
    suite's forced 8-device CPU mesh jax 0.9 deserialized executables
    refuse plain-array calls (module docstring), so this exercises the
    permanent-fallback guard the serve wiring relies on."""
    import jax.numpy as jnp

    from fast_monte_carlo.utils.aot import AotJit, set_aot_dir

    x = jnp.arange(16.0)
    try:
        set_aot_dir(str(tmp_path))
        g = AotJit(lambda x, n: (x * n).sum(), key="t2", static_argnums=(1,))
        want3, want5 = float((x * 3).sum()), float((x * 5).sum())
        assert float(g(x, 3)) == want3
        assert float(g(x, 5)) == want5          # statics dispatch by value
        assert float(g(x, 3)) == want3          # repeat hits the memo
        files = list(tmp_path.glob("t2_*.aotx"))
        assert len(files) == 2                  # one snapshot per signature

        g2 = AotJit(lambda x, n: (x * n).sum(), key="t2", static_argnums=(1,))
        assert float(g2(x, 3)) == want3         # load-or-fallback, same answer
        assert float(g2(x, 3)) == want3
    finally:
        set_aot_dir(None)


@pytest.mark.slow   # compiles the full sim program (~50s on this host)
def test_serve_config_activates_aot(tmp_path, reference_dir):
    """ServeConfig.aot_dir flips the process switch, and a real (tiny,
    analytic) /sim request through the service writes sim-program
    snapshots while returning a normal answer."""
    from fast_monte_carlo.serve import ServeConfig, SimService
    from fast_monte_carlo.utils.aot import get_aot_dir, set_aot_dir

    try:
        svc = SimService(ServeConfig(
            sp_path=str(reference_dir / "PregameSPPlus2025_1.csv"),
            artifact_dir=str(reference_dir), mode="analytic",
            aot_dir=str(tmp_path)))
        assert get_aot_dir() == str(tmp_path)
        out = svc.sim({"team_a": "Kansas State", "team_b": "Iowa State",
                       "n_pairs": 64, "mode": "analytic"})
        assert "moneyline" in out and "summary" in out
        assert list(tmp_path.glob("sim_v1_*.aotx"))   # program snapshotted
    finally:
        set_aot_dir(None)
