"""Persistent-compilation-cache wiring (utils/compile_cache.py).

These tests pin where the caches live: ``JAX_COMPILATION_CACHE_DIR``
when it is set (JAX reads it; the code sets no directory), otherwise
the fixed ``<checkout>/.jax_cache`` — never a temporary, per-process or
home-directory path.
"""

import os

import pytest

from muse_psfr_tpu.utils import compile_cache as cc

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    import jax
    monkeypatch.setattr(cc, "_DONE", None)
    monkeypatch.delenv("MUSE_PSFR_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_forced_off(monkeypatch):
    monkeypatch.setenv("MUSE_PSFR_COMPILE_CACHE", "0")
    assert cc.ensure_compile_cache() is False


def test_forced_path(monkeypatch, tmp_path):
    """``JAX_COMPILATION_CACHE_DIR`` set: the code sets the thresholds
    only — the directory stays JAX's own, and the default directory is
    neither configured nor created."""
    import jax
    monkeypatch.setattr(cc, "default_cache_dir",
                        lambda: str(tmp_path / "default"))
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert cc.ensure_compile_cache() is True
    assert jax.config.jax_compilation_cache_dir == before
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0
    assert not (tmp_path / "default").exists()


def test_idempotent(monkeypatch, tmp_path):
    target = str(tmp_path / "cache")
    monkeypatch.setattr(cc, "default_cache_dir", lambda: target)
    assert cc.ensure_compile_cache() is True
    # the decision is sticky: a later env change does not re-decide
    monkeypatch.setenv("MUSE_PSFR_COMPILE_CACHE", "0")
    assert cc.ensure_compile_cache() is True


def test_default_is_checkout_jax_cache():
    """Without the env var the cache goes to ``<checkout>/.jax_cache``,
    which git ignores."""
    import jax
    want = os.path.join(CHECKOUT, ".jax_cache")
    assert cc.default_cache_dir() == want
    assert cc.ensure_compile_cache() is True
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)
    with open(os.path.join(CHECKOUT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("var", ["HOME", "TMPDIR", "XDG_CACHE_HOME"])
def test_cache_dirs_never_follow_home_or_tmp(monkeypatch, tmp_path, var):
    """The cache path is part of the cache key, so it is fixed: changing
    the home, temporary or XDG directory moves neither cache, and
    neither lies under them."""
    import tempfile
    before = (cc.default_cache_dir(), cc.host_cache_dir())
    monkeypatch.setenv(var, str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    after = (cc.default_cache_dir(), cc.host_cache_dir())
    assert after == before
    for d in after:
        assert not d.startswith(str(tmp_path))
        assert d.startswith(os.path.join(CHECKOUT, ".jax_cache"))


@pytest.mark.parametrize("marker", [".git", "pyproject.toml", None])
def test_default_dir_only_in_a_source_checkout(monkeypatch, tmp_path,
                                               marker):
    """A checkout (``.git`` or ``pyproject.toml`` beside the package)
    caches in ``<checkout>/.jax_cache``; an installed package caches
    nothing by default, so nothing is written into site-packages."""
    import jax
    fake = tmp_path / "muse_psfr_tpu" / "utils" / "compile_cache.py"
    monkeypatch.setattr(cc, "__file__", str(fake))
    if marker is None:
        before = jax.config.jax_compilation_cache_dir
        assert cc.default_cache_dir() is None
        assert cc.host_cache_dir() is None
        assert cc.ensure_compile_cache() is False
        assert jax.config.jax_compilation_cache_dir == before
        assert list(tmp_path.iterdir()) == []
    else:
        (tmp_path / marker).mkdir()
        want = str(tmp_path / ".jax_cache")
        assert cc.default_cache_dir() == want
        assert cc.host_cache_dir() == os.path.join(want, "host_tables")
        assert cc.ensure_compile_cache() is True
        assert jax.config.jax_compilation_cache_dir == want


def test_installed_package_uses_the_env_dir(monkeypatch, tmp_path):
    """Outside a checkout the cache is on only through
    ``JAX_COMPILATION_CACHE_DIR``, which JAX reads itself."""
    import jax
    fake = tmp_path / "muse_psfr_tpu" / "utils" / "compile_cache.py"
    monkeypatch.setattr(cc, "__file__", str(fake))
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert cc.ensure_compile_cache() is True
    assert jax.config.jax_compilation_cache_dir == before


def test_host_cache_switch(monkeypatch):
    assert cc.host_cache_dir() == os.path.join(CHECKOUT, ".jax_cache",
                                               "host_tables")
    monkeypatch.setenv("MUSE_PSFR_HOST_CACHE", "0")
    assert cc.host_cache_dir() is None
    assert cc.host_cache_load("dphi_basis", ("k",)) is None
