"""Compatibility loaders for the reference's pickled model artifacts.

The reference repo ships sklearn 1.3-era joblib pickles (GradientBoosting
quantile pipelines, ColumnTransformer preprocessors) and XGBoost JSON models.
This environment runs sklearn 1.9 / no xgboost, so:

  * ``load_sklearn_artifact`` unpickles old sklearn objects under the current
    sklearn, stubbing out two classes that moved/disappeared
    (``_RemainderColsList`` and the Cython ``CyPinballLoss`` reconstructor).
    Only *inference-relevant* state (trees, init constants, OHE categories)
    is consumed downstream, never the loss objects.
  * XGBoost JSON models need no xgboost at all — they are parsed directly by
    :mod:`fast_monte_carlo.models.xgb_json`.
  * ``extract_xgb_pickle_raw`` pulls the embedded serialized booster bytes out
    of a pickled ``xgboost.sklearn`` estimator (e.g. the reference's
    ``play_model.xgb``) without importing xgboost.

Reference artifacts this understands (the reference repository's file list):
  pass_stage1_preprocessor.joblib, pass_stage2_preprocessor.joblib,
  {pass,run,sack}_yards_q{10,50,90}.joblib, run_fumble_preprocessor.joblib,
  play_model.xgb, label_encoder.pkl, features.pkl, coach_label_encoder.pkl.
"""
from __future__ import annotations

import pickle
import warnings
from pathlib import Path
from typing import Any


class _StubLoss:
    """Placeholder for pickled sklearn Cython loss objects (training-only)."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        self._state = state

    def __call__(self, *a, **k):  # pragma: no cover - never used at inference
        raise RuntimeError("stubbed sklearn loss object is inference-only")


def _stub_pyx_unpickle(cls, checksum, state):
    obj = _StubLoss()
    if state is not None:
        obj.__setstate__(state)
    return obj


def _install_sklearn_shims() -> None:
    import sklearn.compose._column_transformer as _ct

    if not hasattr(_ct, "_RemainderColsList"):
        class _RemainderColsList(list):
            pass

        _ct._RemainderColsList = _RemainderColsList


class _CompatMixin:
    def find_class(self, module: str, name: str):  # type: ignore[override]
        if name.startswith("__pyx_unpickle_"):
            return _stub_pyx_unpickle
        if module == "_loss" or module.endswith("._loss"):
            return _StubLoss
        return super().find_class(module, name)  # type: ignore[misc]


def load_sklearn_artifact(path: str | Path) -> Any:
    """Load an old-sklearn joblib/pickle artifact under the current sklearn."""
    _install_sklearn_shims()
    from joblib.numpy_pickle import NumpyUnpickler

    class _CompatNumpyUnpickler(_CompatMixin, NumpyUnpickler):
        pass

    path = Path(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with open(path, "rb") as fh:
            try:
                return _CompatNumpyUnpickler(
                    str(path), fh, ensure_native_byte_order=False
                ).load()
            except TypeError:  # older joblib signature
                fh.seek(0)
                return _CompatNumpyUnpickler(str(path), fh).load()


def load_plain_pickle(path: str | Path) -> Any:
    """Plain-pickle loader with the same class shims (e.g. *.pkl files)."""
    _install_sklearn_shims()

    class _CompatUnpickler(_CompatMixin, pickle.Unpickler):
        pass

    with open(path, "rb") as fh:
        return _CompatUnpickler(fh).load()


# ---------------------------------------------------------------------------
# xgboost-free extraction of a pickled xgboost sklearn estimator
# ---------------------------------------------------------------------------

class _FakeXGBObject:
    """Records pickled attribute state of any xgboost class without xgboost."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # pragma: no cover
            self.__dict__["_state"] = state


def extract_xgb_pickle_raw(path: str | Path) -> bytes:
    """Return the serialized booster bytes embedded in a pickled xgboost
    sklearn estimator (``play_model.xgb`` in the reference is such a pickle,
    not a native xgboost binary).  The bytes are UBJSON or JSON depending on
    the xgboost version that wrote them; see models.xgb_json.loads_auto."""

    class _XGBUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("xgboost"):
                return type(name, (_FakeXGBObject,), {})
            return super().find_class(module, name)

    with open(path, "rb") as fh:
        est = _XGBUnpickler(fh).load()

    def _hunt(obj, depth=0):
        if depth > 4:
            return None
        if isinstance(obj, (bytes, bytearray)) and len(obj) > 256:
            return bytes(obj)
        d = getattr(obj, "__dict__", None)
        if isinstance(d, dict):
            for key in ("handle", "_handle", "raw", "_Booster"):
                if key in d:
                    found = _hunt(d[key], depth + 1)
                    if found is not None:
                        return found
            for v in d.values():
                found = _hunt(v, depth + 1)
                if found is not None:
                    return found
        return None

    raw = _hunt(est)
    if raw is None:
        raise ValueError(f"no embedded booster bytes found in {path}")
    return raw
