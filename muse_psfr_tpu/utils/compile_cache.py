"""Persistent XLA compilation cache wiring (cold-start mitigation).

The production pipeline compiles for tens of seconds per shape per
process while the computation itself takes milliseconds — a fresh
``muse-psfr --values 1,0.7,25`` run pays the compile for a tiny amount
of compute (the pure-NumPy reference pays zero compile; reference
cli.py:63-64 runs in one process).  JAX's persistent compilation cache
removes that cost from every process after the first.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; this module
  sets only the size and time thresholds, never a directory.
* otherwise, when the package runs from a source checkout (a ``.git``
  or ``pyproject.toml`` beside the ``muse_psfr_tpu`` directory): the
  fixed directory ``<checkout>/.jax_cache`` (git ignores it).  The path
  is part of the cache key, so it is never built from a temporary name,
  a pid or the time.
* otherwise (an installed package): the cache is off, so nothing is
  written into the installation.
* ``MUSE_PSFR_COMPILE_CACHE=0`` turns the cache off.

Host-side precomputed tables (numpy, backend independent) live in
``<checkout>/.jax_cache/host_tables``, in a source checkout only;
``MUSE_PSFR_HOST_CACHE=0`` turns that cache off.

Call :func:`ensure_compile_cache` before the first compile; it is
idempotent and cheap, so every public entry point calls it.
"""

import os

import jax

from .log import get_logger

logger = get_logger()

_DONE = None     # tri-state: None = not decided, False = off, str = dir

_OFF = ("0", "false", "no", "")


def default_cache_dir():
    """``<checkout>/.jax_cache``, the fixed cache directory used when
    ``JAX_COMPILATION_CACHE_DIR`` is not set; ``None`` when the package
    does not run from a source checkout."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(pkg)
    if not any(os.path.exists(os.path.join(root, marker))
               for marker in (".git", "pyproject.toml")):
        return None
    return os.path.join(root, ".jax_cache")


def host_cache_dir():
    """Directory for HOST-side precomputed tables, or ``None`` when
    disabled with ``MUSE_PSFR_HOST_CACHE=0``, outside a source checkout
    or not writable.  Tables
    are keyed by their full parameter tuple plus a format version, so
    stale entries are never read; writes are atomic (tmp + rename)."""
    v = os.environ.get("MUSE_PSFR_HOST_CACHE")
    if v is not None and v.strip() in _OFF:
        return None
    root = default_cache_dir()
    if root is None:
        return None
    path = os.path.join(root, "host_tables")
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    return path


def host_cache_load(name: str, key: tuple):
    """Load dict-of-arrays for (name, key), or None on any miss."""
    import numpy as np
    d = host_cache_dir()
    if d is None:
        return None
    import hashlib
    h = hashlib.sha256(repr(key).encode()).hexdigest()[:24]
    path = os.path.join(d, f"{name}-{h}.npz")
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except Exception:  # noqa: BLE001 — missing/corrupt: recompute
        return None


def host_cache_store(name: str, key: tuple, arrays: dict):
    """Atomically store dict-of-arrays under (name, key); best-effort."""
    import numpy as np
    d = host_cache_dir()
    if d is None:
        return
    import hashlib
    import tempfile
    h = hashlib.sha256(repr(key).encode()).hexdigest()[:24]
    path = os.path.join(d, f"{name}-{h}.npz")
    try:
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except Exception as err:  # noqa: BLE001
        logger.debug("host cache store failed for %s: %s", name, err)


def ensure_compile_cache() -> bool:
    """Enable the persistent compilation cache (see the module
    docstring for where it lives).  Returns whether the cache is
    active.  Idempotent: the decision is made once per process."""
    global _DONE
    if _DONE is not None:
        return bool(_DONE)
    forced = os.environ.get("MUSE_PSFR_COMPILE_CACHE")
    if forced is not None and forced.strip() in _OFF:
        _DONE = False
        return False
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cache_dir = env_dir or default_cache_dir()
    if cache_dir is None:
        logger.debug("no persistent compilation cache: not a source "
                     "checkout and JAX_COMPILATION_CACHE_DIR is unset")
        _DONE = False
        return False
    try:
        # the night's executables are all multi-second compiles, but the
        # CLI's tiny fit/plot helpers benefit too — cache everything.
        # The DIR is set LAST: a failure on any earlier update (e.g. a
        # JAX version without these config names) must leave the cache
        # fully off, never half-enabled.
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        if not env_dir:
            os.makedirs(cache_dir, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache_dir)
        _DONE = cache_dir
        logger.debug("persistent compilation cache at %s", cache_dir)
        return True
    except Exception as err:  # noqa: BLE001 — cache is best-effort
        logger.warning("could not enable the persistent compilation "
                       "cache at %s: %s", cache_dir, err)
        if not env_dir:
            try:
                jax.config.update("jax_compilation_cache_dir", None)
            except Exception:  # noqa: BLE001
                pass
        _DONE = False
        return False
