"""Unit tests pinning the reference's IDL-inherited quirks, each validated
against a literal NumPy transcription of the original expression."""

import numpy as np
import jax.numpy as jnp
from numpy.testing import assert_allclose

from muse_psfr_tpu.core.grids import fft_freq_polar, pupil_mask
from muse_psfr_tpu.core.moffat import moffat_kernel
from muse_psfr_tpu.otf.psf import lambda_crop_size
from muse_psfr_tpu.psd.model import wfs_transfer
from muse_psfr_tpu.config import GalacsiConfig


def test_arctan_polar_decomposition():
    """f_x = |fx|, f_y = sign(fx)*fy — the arctan (not arctan2) quirk."""
    n, step = 16, 0.2
    f, f_x, f_y = fft_freq_polar(n, step, jnp.float64)
    fx = np.fft.fftfreq(n, step)[:, None]
    fy = fx.T
    # literal reference expression (psfrec.py:548-554)
    with np.errstate(all="ignore"):
        arg = fy / fx
    arg[0, 0] = 0
    arg = np.arctan(arg)
    fr = np.hypot(fx, fy)
    assert_allclose(np.asarray(f_x), fr * np.cos(arg), atol=1e-15)
    assert_allclose(np.asarray(f_y), fr * np.sin(arg), atol=1e-15)


def test_wfs_mask_precedence_and_strictness():
    """Mask is ((f!=0) & (|fx| >= fc)) | (|fy| >= fc); '>' in the residual
    model vs '>=' in the reconstructor differs exactly at |f| = fc."""
    n, step = 80, 0.2
    f, f_x, f_y = fft_freq_polar(n, step, jnp.float64)
    pitch = 8.0 / 24.0
    fc = 1.0 / (2 * pitch)
    w_ge = np.asarray(wfs_transfer(f, f_x, f_y, pitch, False, jnp.complex128))
    w_gt = np.asarray(wfs_transfer(f, f_x, f_y, pitch, True, jnp.complex128))

    # literal reference expression (psfrec.py:252-257)
    fxn, fyn = np.asarray(f_x), np.asarray(f_y)
    fn = np.asarray(f)
    ref = (2 * np.pi * 1j * fn * np.sinc(pitch * fxn) * np.sinc(pitch * fyn))
    ref_ge = ref.copy()
    ref_ge[(fn != 0) & (np.abs(fxn) >= fc) | (np.abs(fyn) >= fc)] = 0
    ref_gt = ref.copy()
    ref_gt[(fn != 0) & (np.abs(fxn) > fc) | (np.abs(fyn) > fc)] = 0
    assert_allclose(w_ge, ref_ge, atol=1e-15)
    assert_allclose(w_gt, ref_gt, atol=1e-15)
    # the cutoff frequency lies exactly on the grid -> they must differ
    assert np.any(ref_ge != ref_gt)


def test_lambda_crop_uses_bankers_rounding():
    cfg = GalacsiConfig()
    lb = jnp.array([490.0, 500.0, 900.0])
    got = np.asarray(lambda_crop_size(lb, cfg))
    ref = (np.round((40 * 0.2 * 2 * 8 * 4.85 * 1000 /
                     np.array([490.0, 500.0, 900.0])) / 2) * 2).astype(int)
    assert_allclose(got, ref)


def test_lambda_crop_half_boundary_decided_in_float64():
    """The .5-boundary crop decision must be made in float64: for
    lbda = linspace(500, 900, 37), plane 19 (711.111... nm) has
    raw/2 == 436.5 EXACTLY in f64 (banker's rounding -> npixc 872),
    while the f32 quotient lands at 436.50003 and would round to 874 —
    shifting every pixel of that plane's regrid ~0.23% off the
    reference.  Concrete inputs therefore compute on the host in f64;
    the batch layer precomputes npixc there and threads it through the
    jit (parallel/batch.py::_plan_batch)."""
    cfg = GalacsiConfig()
    lbda = np.linspace(500, 900, 37)
    got = np.asarray(lambda_crop_size(lbda, cfg))
    assert got[19] == 872
    # pin that the f32 quotient really falls on the other side — the
    # hazard this test guards against
    scale = np.float32(40 * 0.2 * 2 * 8 * 4.85 * 1000)
    raw32 = scale / np.float32(lbda[19])
    assert int(np.round(np.float32(raw32) / np.float32(2.0))) * 2 == 874
    # and that the production batch plan carries the f64 values
    from muse_psfr_tpu.parallel.batch import _plan_batch
    npixc = _plan_batch(np.array([1.0]), np.array([0.7]),
                        np.array([25.0]), np.ones((1, 4)), lbda,
                        (100, 10000), 1, cfg, 1, None)[8]
    assert_allclose(np.asarray(npixc), got)


def test_standalone_transforms_decide_crop_on_host(monkeypatch):
    """``psf_cube`` / ``psf_cube_from_base`` with concrete wavelengths
    must decide the crop sizes on the HOST (float64) — they used to be
    fully jitted, so wavelengths were always traced inside and the f32
    fallback silently took over (invisible on CPU where x64 is on, but
    the .5-boundary bug on a float32 accelerator; see
    test_lambda_crop_half_boundary_decided_in_float64)."""
    import jax
    import muse_psfr_tpu.otf.psf as P
    from muse_psfr_tpu.config import TINY_CONFIG

    traced_calls = []
    orig = P.lambda_crop_size

    def spy(lb, cfg):
        traced_calls.append(isinstance(lb, jax.core.Tracer))
        return orig(lb, cfg)

    monkeypatch.setattr(P, "lambda_crop_size", spy)
    psd = np.zeros((TINY_CONFIG.dim, TINY_CONFIG.dim), np.float32)
    P.psf_cube(psd, np.array([700.0, 800.0]), TINY_CONFIG)
    assert traced_calls == [False]   # exactly one call, on the host


def test_pupil_mask_against_reference_expression():
    for radius, width, oc, inv in [(320, 640, 0.14, False), (5, 80, 0, True)]:
        got = np.asarray(pupil_mask(radius, width, oc, inv, jnp.float64))
        c = (width - 1) / 2
        x, y = np.ogrid[:width, :width]
        rho = np.hypot(x - c, y - c) / radius
        m = (rho < 1) & (rho >= oc)
        if inv:
            m = ~m
        assert_allclose(got, m.astype(int))


def test_moffat_kernel_is_unnormalised_analytic():
    k = np.asarray(moffat_kernel(3.0, 2.0, 41, jnp.float64))
    c = 20
    assert_allclose(k[c, c], (2 - 1) / (np.pi * 9.0), rtol=1e-12)
    assert k.sum() < 1.0  # truncated tails, no renormalisation
    assert_allclose(k, k.T)
