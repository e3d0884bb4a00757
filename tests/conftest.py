import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
# are exercised without accelerators.  Must be set before jax initializes;
# the platform is forced through jax.config as well.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
REFERENCE = Path("/root/reference")
sys.path.insert(0, str(REPO))


@pytest.fixture(scope="session")
def reference_dir() -> Path:
    if not REFERENCE.exists():
        pytest.skip("reference artifacts not mounted")
    return REFERENCE


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(0)


def make_state_batch(rng: np.random.Generator, n: int) -> "np.ndarray":
    """Random plausible 17-feature state rows in the reference's ST1 order."""
    down = rng.integers(1, 5, n)
    distance = np.round(rng.uniform(0.5, 25, n) * 2) / 2
    ytg = rng.integers(1, 100, n).astype(np.float64)
    seconds = rng.integers(0, 3601, n).astype(np.float64)
    half = np.where(seconds > 1800, 1, 2)
    cols = {
        "down": down.astype(np.float64),
        "distance": distance,
        "yardsToGoal": ytg,
        "is_red_zone": (ytg <= 20).astype(np.float64),
        "score_diff": rng.integers(-30, 31, n).astype(np.float64),
        "seconds_remaining": seconds,
        "offenseTimeouts": rng.integers(0, 4, n).astype(np.float64),
        "defenseTimeouts": rng.integers(0, 4, n).astype(np.float64),
        "sp_rating_off": rng.uniform(-20, 30, n),
        "sp_offense_rating_off": rng.uniform(10, 45, n),
        "sp_defense_rating_def": rng.uniform(10, 45, n),
        "sp_rating_def": rng.uniform(-20, 30, n),
        "goal_to_go": (distance >= ytg - 0.5).astype(np.float64),
        "fourth_and_short": ((down == 4) & (distance <= 2.0)).astype(np.float64),
        "fg_range": (ytg <= 33).astype(np.float64),
        "half": half.astype(np.float64),
        "two_minute": ((seconds % 1800) <= 120).astype(np.float64),
    }
    return cols


# ---------------------------------------------------------------------------
# Suite-time governance (VERDICT r4 #7): every run records per-test call
# durations + slow-marker status to .pytest_durations.json; the standalone
# auditor `python tests/check_suite_time.py` fails when the not-slow subset
# outgrows its budget or an unmarked test exceeds the per-test cap (and
# names the tests to move behind @pytest.mark.slow).
# ---------------------------------------------------------------------------

_DURATIONS: dict = {}


def pytest_collection_modifyitems(config, items):
    # record EVERY collected item's slow status (even ones a -m/-k filter
    # later deselects) so a partial run still refreshes marker state in
    # the durations record — newly-marked tests must not stay recorded
    # as not-slow until the next full run
    config._fmc_slow_map = {i.nodeid: bool(i.get_closest_marker("slow"))
                            for i in items}


def pytest_runtest_logreport(report):
    if report.when == "call":
        _DURATIONS[report.nodeid] = round(report.duration, 2)


def pytest_sessionfinish(session, exitstatus):
    import json

    slow_map = getattr(session.config, "_fmc_slow_map", {})
    if not _DURATIONS and not slow_map:
        return
    path = REPO / ".pytest_durations.json"
    try:
        prev = json.loads(path.read_text()) if path.exists() else {}
    except Exception:
        prev = {}
    # merge: partial runs (-k, -m) update only the tests they ran, so the
    # auditor can judge the full picture from the most recent full run +
    # later partials; marker status refreshes for everything COLLECTED
    tests = prev.get("tests", {})
    for nid, dur in _DURATIONS.items():
        tests[nid] = {"s": dur, "slow": slow_map.get(nid, False)}
    for nid, is_slow in slow_map.items():
        if nid in tests and nid not in _DURATIONS:
            tests[nid]["slow"] = is_slow
    try:
        path.write_text(json.dumps(
            {"tests": tests, "host_nproc": os.cpu_count()}, indent=0))
    except Exception:
        pass
