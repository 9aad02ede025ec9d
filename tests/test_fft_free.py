"""The FFT-free (DFT-matmul + direct-convolution) execution mode is
exact against the FFT path; the FFT decision per backend."""

import numpy as np
import jax.numpy as jnp
import pytest

from muse_psfr_tpu import GalacsiConfig
from muse_psfr_tpu.psd.model import simulate_psd
from muse_psfr_tpu.otf.psf import psf_cube
from muse_psfr_tpu.otf.convolve import convolve_final
from muse_psfr_tpu.parallel.batch import resolve_fft_mode, fft_available


def _run(cfg, lb):
    dt = cfg.dtype
    psd = simulate_psd(jnp.asarray(1.0, dt), jnp.asarray(0.7, dt),
                       jnp.asarray(25.0, dt), jnp.ones(4, dt),
                       jnp.asarray([100.0, 10000.0], dt), 12.0, 1, cfg)
    cube = psf_cube(psd, jnp.asarray(lb, dt), cfg)
    return np.asarray(convolve_final(cube, jnp.asarray(lb, dt),
                                     1.0, 0.7, 25.0, cfg))


def test_fft_free_exact_in_float64():
    lb = np.array([500.0, 700.0, 900.0])
    a = _run(GalacsiConfig(dtype="float64", use_fft=True), lb)
    b = _run(GalacsiConfig(dtype="float64", use_fft=False), lb)
    assert np.abs(a - b).max() < 1e-13


def test_fft_free_rms_in_float32():
    lb = np.linspace(490, 930, 35)
    import os
    golden = np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "golden_psf_35l_s1.0_gl0.7_l025.npy"))
    out = _run(GalacsiConfig(dtype="float32", use_fft=False), lb)
    rms = np.sqrt(np.mean((out.astype(np.float64) - golden) ** 2))
    assert rms < 1e-5


def test_fft_free_requires_zoom():
    with pytest.raises(ValueError):
        _run(GalacsiConfig(dtype="float64", use_fft=False,
                           use_zoom_dft=False), np.array([700.0]))


def test_resolve_fft_mode_on_cpu():
    assert fft_available()  # CPU backend always has FFTs
    cfg = GalacsiConfig()
    assert resolve_fft_mode(cfg) is cfg


@pytest.mark.parametrize("backend,has_fft", [
    ("cpu", True), ("gpu", True), ("neuron", False), ("metal", False)])
def test_fft_mode_decided_from_backend_alone(monkeypatch, caplog, backend,
                                             has_fft):
    """The decision reads the backend's name and nothing else: no probe
    program, no second process; a downgrade is logged, never silent."""
    import logging
    import subprocess
    from muse_psfr_tpu.parallel import batch as B

    def no_subprocess(*a, **k):
        raise AssertionError("the FFT decision must not start a process")

    monkeypatch.setattr(subprocess, "run", no_subprocess)
    monkeypatch.setattr(subprocess, "Popen", no_subprocess)
    monkeypatch.setattr(B.jax, "default_backend", lambda: backend)
    assert B.fft_available() is has_fft
    cfg = GalacsiConfig(use_zoom_dft=False)
    with caplog.at_level(logging.WARNING):
        out = B.resolve_fft_mode(cfg)
    if has_fft:
        assert out is cfg
        assert not caplog.records
    else:
        assert out.use_fft is False and out.use_zoom_dft is True
        assert any("no FFT support" in r.getMessage()
                   for r in caplog.records)


def test_dft_convolve_matches_fft_and_direct_backends():
    """The three 'same'-convolution backends agree to rounding (the DFT
    matmul one is the production FFT-free path)."""
    import jax.numpy as jnp
    from muse_psfr_tpu.otf.convolve import (
        _fft_convolve_same, _direct_convolve_same, _dft_convolve_same)

    rng = np.random.default_rng(7)
    p = jnp.asarray(rng.standard_normal((5, 40, 40)), jnp.float64)
    for nk in (1, 5):  # broadcast single kernel and per-plane kernels
        k = jnp.asarray(rng.standard_normal((nk, 41, 41)), jnp.float64)
        a = np.asarray(_fft_convolve_same(p, k, 40, 41))
        b = np.asarray(_dft_convolve_same(p, k, 40, 41))
        c = np.asarray(_direct_convolve_same(p, k, 40, 41))
        np.testing.assert_allclose(b, a, atol=1e-11)
        np.testing.assert_allclose(b, c, atol=1e-11)


def test_dft_convolve_retrace_has_no_stale_constants():
    """The cached DFT matrices must be host arrays: caching a traced array
    would leak a tracer into the second trace (regression guard)."""
    import jax
    import jax.numpy as jnp
    from muse_psfr_tpu.otf.convolve import _dft_convolve_same

    rng = np.random.default_rng(3)
    p = jnp.asarray(rng.standard_normal((2, 8, 8)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((2, 9, 9)), jnp.float32)
    f = lambda x: _dft_convolve_same(x, k, 8, 9)  # noqa: E731
    first = np.asarray(jax.jit(f)(p))
    second = np.asarray(jax.jit(lambda x: f(x) + 0.0)(p))  # fresh trace
    np.testing.assert_allclose(first, second, rtol=1e-6)


def test_matmul_precision_knob_traces():
    """All three precision tiers must trace (the knob converts the config
    string to jax.lax.Precision at use sites)."""
    import jax
    import jax.numpy as jnp
    from muse_psfr_tpu.config import TINY_CONFIG
    from muse_psfr_tpu.otf.psf import dphi_base

    psd = jnp.ones((1, TINY_CONFIG.dim, TINY_CONFIG.dim), jnp.float32)
    for tier in ("default", "high", "highest"):
        cfg = TINY_CONFIG.with_(use_fft=False, matmul_precision=tier)
        out = jax.jit(lambda p: dphi_base(p, cfg))(psd)
        assert np.all(np.isfinite(np.asarray(out)))
