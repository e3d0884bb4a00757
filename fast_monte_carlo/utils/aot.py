"""Opt-in AOT executable snapshots (zero-compile cold starts).

The persistent compilation cache keys on backend/version fingerprints
outside our control, and a cold one pays every compile again.
`jax.experimental.serialize_executable` round-trips the COMPILED
executable itself (bitwise-equal results, tested), so a production
deployment can snapshot its warm program set once and boot every
subsequent process with zero compiles:

    from fast_monte_carlo.utils.aot import aot_compile_cached

    exe = aot_compile_cached(step_fn, example_args, key="sim_chunk")
    out = exe(*args)          # same contract as jax.jit(step_fn)(*args)

Snapshots are keyed by (caller key, function bytecode, jax version,
device topology — count + kinds, abstract input signature, static-arg
values); any mismatch — a code edit, new jax, different chip or mesh
width, new shapes — quietly falls back to a fresh lower+compile and
rewrites the snapshot.  Closure-captured values are NOT hashed: version
the `key` string when semantics change outside the function body.
Executables are hardware-specific by nature: treat the cache directory
as a per-deployment artifact, not a portable one (XLA:CPU snapshots in
particular embed host CPU features and may refuse to load elsewhere).

This is deliberately NOT wired into the library's jit-cache hot paths:
those are protected by golden/parity tests and the persistent cache
already covers the common case.  Use it at the deployment boundary
(serving boot, bench capture) where cold-start latency matters.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from pathlib import Path
from typing import Any, Callable, Optional

__all__ = ["aot_compile_cached", "aot_fingerprint", "AotJit",
           "set_aot_dir", "get_aot_dir", "cfg_fingerprint"]


def aot_fingerprint(key: str, args: tuple,
                    static_argnums: tuple = (),
                    fn: Optional[Callable] = None) -> str:
    """Stable id for (program, jax/backend/topology, input signature).

    Static args are fingerprinted by VALUE (the executable is specialized
    on them — two calls differing only in a static int must not share a
    snapshot); traced args by shape/dtype; non-arraylike traced leaves by
    repr.  The fingerprint also hashes:

    * the FUNCTION's bytecode (co_code/consts/names recursively) when
      `fn` is given — a code change must not serve the pre-change
      executable.  Closure-captured VALUES and functions the kernel calls
      are not visible to this hash; version the `key` string when
      semantics change outside the function body.
    * the device topology (count + per-device kinds), not just device 0 —
      a snapshot from an 8-device mesh deserializes FINE in a 1-device
      process and then refuses every call (tests/test_aot.py), which
      would bypass the load-failure recompile fallback.
    """
    import jax
    import jax.numpy as jnp

    def leaf_sig(x):
        try:
            return (tuple(jnp.shape(x)), str(jnp.result_type(x)))
        except Exception:
            return ("repr", repr(x))

    def code_sig(code):
        consts = tuple(
            code_sig(c) if hasattr(c, "co_code") else repr(c)
            for c in code.co_consts)
        return (code.co_code, consts, code.co_names, code.co_varnames)

    fn_sig = ""
    if fn is not None:
        inner = getattr(fn, "__wrapped__", fn)
        code = getattr(inner, "__code__", None)
        fn_sig = (repr(code_sig(code)) if code is not None
                  else repr(inner))

    devs = jax.devices()
    topo = (len(devs), tuple(getattr(d, "device_kind", d.platform)
                             for d in devs))
    sig = tuple(
        ("static", repr(a)) if i in static_argnums
        else jax.tree_util.tree_map(leaf_sig, a)
        for i, a in enumerate(args))
    raw = repr((key, jax.__version__, devs[0].platform, topo, fn_sig, sig))
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def aot_compile_cached(
    fn: Callable,
    example_args: tuple,
    *,
    key: str,
    cache_dir: str = ".aot_cache",
    static_argnums: tuple = (),
    verbose: bool = False,
) -> Any:
    """Return a loaded executable for `fn(*example_args)` — from the
    snapshot when one matches, else freshly compiled (and snapshotted).

    The returned object is callable with the same pytree contract as
    `jax.jit(fn)` at the example signature.  Snapshot write failures are
    non-fatal (the compiled executable is returned regardless); load
    failures fall back to compiling.
    """
    import jax
    from jax.experimental.serialize_executable import (
        deserialize_and_load, serialize,
    )

    fp = aot_fingerprint(key, example_args, static_argnums, fn=fn)
    path = Path(cache_dir) / f"{key}_{fp}.aotx"
    if path.exists():
        try:
            with open(path, "rb") as fh:
                blob, in_tree, out_tree = pickle.load(fh)
            exe = deserialize_and_load(blob, in_tree, out_tree)
            if verbose:
                print(f"# aot: loaded {path.name} ({path.stat().st_size:,}B)")
            return exe
        except Exception as e:  # stale/corrupt/foreign snapshot: recompile
            if verbose:
                print(f"# aot: snapshot load failed ({type(e).__name__}: "
                      f"{e}); recompiling")
    compiled = (jax.jit(fn, static_argnums=static_argnums)
                .lower(*example_args).compile())
    try:
        blob, in_tree, out_tree = serialize(compiled)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as fh:
            pickle.dump((blob, in_tree, out_tree), fh)
        os.replace(tmp, path)
        if verbose:
            print(f"# aot: wrote {path.name} ({len(blob):,}B)")
    except Exception as e:  # backend without serialize support: still usable
        if verbose:
            print(f"# aot: snapshot write failed ({type(e).__name__}: {e})")
    return compiled


# ---------------------------------------------------------------------------
# Process-wide AOT switch + jit-compatible wrapper (round 5, VERDICT r4 #2)
# ---------------------------------------------------------------------------

_AOT_DIR: Optional[str] = None


def set_aot_dir(d: Optional[str]) -> None:
    """Activate (or deactivate, with None) AOT snapshot serving for every
    AotJit call site in the process.  Serving boot sets this from
    ServeConfig.aot_dir; the default None keeps every hot path on plain
    jax.jit exactly as before."""
    global _AOT_DIR
    _AOT_DIR = d


def get_aot_dir() -> Optional[str]:
    return _AOT_DIR


def cfg_fingerprint(obj: Any) -> str:
    """Deterministic short hash of a (frozen, repr-stable) config object —
    AotJit call sites fold it into their snapshot key because closure
    contents are invisible to the bytecode fingerprint.  repr-based, not
    hash(): Python salts str hashes per process."""
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:10]


class AotJit:
    """``jax.jit``-compatible callable that can serve each input signature
    from an AOT executable snapshot.

    With no AOT dir active (`set_aot_dir(None)`, the default) every call
    forwards to a plain ``jax.jit`` of `fn` — the hot paths are untouched
    beyond one global read.  With a dir active, the first call for each
    (static values, input avals) signature loads a topology-fingerprinted
    executable via `aot_compile_cached` (compiling + snapshotting on miss),
    and later calls dispatch to it directly.  Any executable-call failure
    — e.g. the jax-0.9 forced-CPU-mesh caveat where DESERIALIZED
    executables refuse plain-array args (tests/test_aot.py) — falls back
    to the jit path permanently for that signature, so activation can
    never change results or break a call, only skip compiles.

    `key` must encode everything the program depends on beyond `fn`'s own
    bytecode (closure-captured configs: use `cfg_fingerprint`)."""

    def __init__(self, fn: Callable, *, key: str, static_argnums: tuple = ()):
        import jax

        self._fn = fn
        self._key = key
        self._static = tuple(static_argnums)
        self._jit = jax.jit(fn, static_argnums=static_argnums)
        self._exes: dict = {}

    def _cache_size(self):
        """jax.jit-compatible trace-cache probe (tests pin no-recompile
        behavior with it); counts the inner jit's traces plus any AOT
        executables served for distinct signatures."""
        return self._jit._cache_size() + len(self._exes)

    def _sig(self, args: tuple):
        import jax
        import jax.numpy as jnp

        out = []
        for i, a in enumerate(args):
            if i in self._static:
                out.append(("s", a if isinstance(a, (int, bool, float, str))
                            else repr(a)))
            else:
                leaves, treedef = jax.tree_util.tree_flatten(a)
                out.append((tuple((tuple(jnp.shape(x)),
                                   str(jnp.result_type(x)))
                                  for x in leaves), treedef))
        return tuple(out)

    def __call__(self, *args):
        d = get_aot_dir()
        if d is None:
            return self._jit(*args)
        sig = self._sig(args)
        ent = self._exes.get(sig)
        if ent is None:
            dyn_idx = tuple(i for i in range(len(args))
                            if i not in self._static)
            fn, nargs = self._fn, len(args)
            statics = {i: args[i] for i in self._static}

            def bound(*dyn):
                full = [None] * nargs
                for j, i in enumerate(dyn_idx):
                    full[i] = dyn[j]
                for i, v in statics.items():
                    full[i] = v
                return fn(*full)

            import re
            safe = re.sub(r"[^A-Za-z0-9_.-]", "", self._key)
            skey = f"{safe}_{hashlib.sha256(repr(sig).encode()).hexdigest()[:10]}"
            verbose = bool(os.environ.get("FMC_AOT_DEBUG"))
            try:
                exe = aot_compile_cached(bound, tuple(args[i] for i in dyn_idx),
                                         key=skey, cache_dir=d,
                                         verbose=verbose)
            except Exception as e:
                if verbose:
                    print(f"# aot[{skey}]: compile path failed "
                          f"({type(e).__name__}: {e}); staying on jit")
                exe = None  # lower/compile path failed: stay on jit
            ent = self._exes[sig] = {"exe": exe, "dyn": dyn_idx}
        if ent["exe"] is not None:
            try:
                return ent["exe"](*(args[i] for i in ent["dyn"]))
            except Exception as e:
                if os.environ.get("FMC_AOT_DEBUG"):
                    print(f"# aot[{self._key}]: executable call failed "
                          f"({type(e).__name__}: {e}); permanent jit "
                          f"fallback for this signature")
                ent["exe"] = None   # e.g. deserialized-exe arg refusal
        return self._jit(*args)
