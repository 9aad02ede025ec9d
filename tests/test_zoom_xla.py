"""The XLA zoom-DFT path of the OTF -> PSF stage (``psf_cube_from_base``)
against the float64 FFT path and the float64 golden cube.

The GPU runs this path in wavelength chunks of ``cfg.lambda_chunk``
(padded when the wavelength count does not divide it); the CPU backend
runs it one wavelength at a time.  Both orders are checked here on the
CPU by forcing the chunk (``_wavelength_chunk``), over 1, 4 and 9
directions, the full and a reduced support window, and the blue split.
"""

import functools
import os

import numpy as np
import jax.numpy as jnp
import pytest

from muse_psfr_tpu.config import GalacsiConfig
from muse_psfr_tpu.otf import psf as P
from muse_psfr_tpu.otf.convolve import convolve_final
from muse_psfr_tpu.psd.model import simulate_psd, effective_wind_speed

H = (100, 10000)
# dim=512 admits a reduced window (S=128 < dim/2) and a blue sub-window;
# seeing 1.0 damps this grid's OTF below 1e-12 inside S=128 at every
# wavelength used here (tests/test_otf_support.py BLUE_CFG)
CFG = GalacsiConfig(dim=512, dim_pup=16, dimpsf=12)
LB = np.linspace(600.0, 900.0, 9)       # 9 = one chunk of 7 + 2 (padded)
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_psf_35l_s1.0_gl0.7_l025.npy")


def _psd(cfg, npsflin):
    ws = effective_wind_speed(H, cfg)
    return simulate_psd(1.0, 0.7, 25.0, jnp.ones(4, cfg.dtype), H, ws,
                        npsflin, cfg)


@functools.lru_cache(maxsize=None)
def _reference(npsflin):
    """float64 FFT resampling on the full grid (no fold, no window)."""
    cfg = CFG.with_(dtype="float64", use_zoom_dft=False)
    assert cfg.otf_window is None
    return np.asarray(P.psf_cube(_psd(cfg, npsflin), LB, cfg))


@pytest.fixture(params=["serial", "chunked"])
def chunking(request, monkeypatch):
    """Serial (the CPU order) or chunks of ``lambda_chunk`` (the GPU
    order)."""
    if request.param == "chunked":
        monkeypatch.setattr(P, "_wavelength_chunk",
                            lambda cfg, nl: max(1, min(cfg.lambda_chunk,
                                                       nl)))
    return request.param


WINDOWS = {
    "full": dict(otf_support=0, otf_blue=None),
    "reduced": dict(otf_support=128, otf_blue=None),
    "blue": dict(otf_support=0, otf_blue=(4, 128)),
}


@pytest.mark.parametrize("npsflin", [1, 2, 3], ids=["ndir1", "ndir4",
                                                     "ndir9"])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_zoom_xla_path_matches_float64_fft(npsflin, window, chunking):
    cfg = CFG.with_(**WINDOWS[window])
    assert cfg.otf_window is not None          # the folded zoom path
    base = P.dphi_base(_psd(cfg, npsflin).astype(cfg.dtype), cfg)
    assert base.shape[0] == npsflin * npsflin
    got = np.asarray(P.psf_cube_from_base(base, LB, cfg))
    ref = _reference(npsflin)
    assert got.shape == ref.shape == (LB.size, cfg.dimpsf, cfg.dimpsf)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got.sum(axis=(1, 2)), 1.0, rtol=1e-5)
    # float32 rounding plus a window truncation below 1e-9 of the DC
    assert np.abs(got - ref).max() < 5e-7, np.abs(got - ref).max()


@pytest.mark.parametrize("lambda_chunk", [7, 8], ids=["divides",
                                                      "padded"])
def test_chunked_production_cube_matches_golden(lambda_chunk, monkeypatch):
    """The GPU order at the production width (dim=1280, 35 wavelengths,
    float32) reproduces the float64 golden cube within the 1e-5 budget,
    with chunks that divide 35 and with a padded last chunk."""
    monkeypatch.setattr(P, "_wavelength_chunk",
                        lambda cfg, nl: max(1, min(cfg.lambda_chunk, nl)))
    cfg = GalacsiConfig(lambda_chunk=lambda_chunk)
    lb = np.linspace(490, 930, 35)
    psd = _psd(cfg, 1)
    cube = P.psf_cube(psd, jnp.asarray(lb, cfg.dtype), cfg)
    out = np.asarray(convolve_final(cube, jnp.asarray(lb, cfg.dtype),
                                    1.0, 0.7, 25.0, cfg))
    rms = np.sqrt(np.mean((out.astype(np.float64) - np.load(GOLDEN)) ** 2))
    assert rms < 1e-5


def test_wavelength_chunk_rule(monkeypatch):
    """lambda_chunk on an accelerator (clamped to the wavelength count),
    one wavelength at a time on the CPU backend."""
    assert P._wavelength_chunk(CFG, 35) == 1          # CPU test backend
    monkeypatch.setattr(P.jax, "default_backend", lambda: "gpu")
    assert P._wavelength_chunk(CFG, 35) == CFG.lambda_chunk
    assert P._wavelength_chunk(CFG, 3) == 3
    assert P._wavelength_chunk(CFG.with_(lambda_chunk=0), 35) == 1
