"""Tip-tilt and instrument-PSF convolutions (JAX, batched over wavelength).

Replaces reference ``convolve_final_psf`` (psfrec.py:874-930): the AO PSF
cube is convolved with (a) a beta=2 Moffat modelling residual tip-tilt from
the uncorrected high layer, its width set by the outer-scale attenuation
table (coeffL0), and (b) the per-wavelength MUSE-intrinsic Moffat.

Both are 'same'-mode linear convolutions of a (dimpsf, dimpsf) plane with
an odd (dimpsf+1, dimpsf+1) kernel, done as circular transforms at the
minimal alias-free size (:func:`_same_fft_size`): the circular wrap lands
entirely outside the kept 'same' window, so the crop is EXACTLY the
linear-convolution result — identical numbers to the reference's
``scipy.signal.fftconvolve(mode='same')`` at 0.75x the transform size
(64 instead of 80 at production dimpsf=40).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import GalacsiConfig
from ..core.moffat import moffat_kernel, moffat_fwhm_to_alpha, \
    muse_intrinsic_psf
from ..core.coeff_l0 import tt_attenuation


def _same_fft_size(n_img: int, n_ker: int) -> int:
    """Smallest alias-free circular-transform size for the 'same' window.

    The full linear convolution has support [0, n_img + n_ker - 2] and
    the 'same' crop keeps [off, off + n_img - 1], off = (n_ker - 1)//2.
    A circular convolution at size L folds f[j + L] into y[j]; on the
    kept window that alias vanishes as soon as off + L > n_img + n_ker
    - 2, i.e. L >= n_img + n_ker - 1 - off — EXACT, not approximate
    (verified to 6e-14 vs the full-size transform).  Rounded up to a
    multiple of 8, never above the classical full size.  Production
    dimpsf=40: L=64 instead of 80 -> 0.51x the transform FLOPs on both
    the FFT and the DFT-matmul path.
    """
    full = n_img + n_ker - 1
    lmin = full - (n_ker - 1) // 2
    return min(full, -(-lmin // 8) * 8)


def _fft_convolve_same(planes, kernels, n_img: int, n_ker: int):
    """Batched 'same' linear convolution via circular FFT.

    planes: (nl, n_img, n_img); kernels: (nl, n_ker, n_ker) with
    n_ker = n_img + 1 (odd).  Returns (nl, n_img, n_img).
    """
    nfft = _same_fft_size(n_img, n_ker)
    fp = jnp.fft.rfft2(planes, s=(nfft, nfft))
    fk = jnp.fft.rfft2(kernels, s=(nfft, nfft))
    full = jnp.fft.irfft2(fp * fk, s=(nfft, nfft))
    off = (n_ker - 1) // 2
    return full[..., off:off + n_img, off:off + n_img]


_DFT_MATS = {}


def _dft_mats(n: int, dtype):
    """Symmetric real/imag DFT matrices W = C - iS, W[a,b]=exp(-2i pi ab/n).

    Phases are reduced mod n in integers before the trig so the float32
    matrices are accurate for any n (same trick as the zoom-DFT matrices,
    otf/psf.py).  Host-computed constants, cached per (n, dtype).
    """
    key = (n, str(jnp.dtype(dtype)))
    if key not in _DFT_MATS:
        a = np.arange(n)
        ang = np.mod(np.outer(a, a), n) * (2.0 * np.pi / n)
        # cache HOST arrays: caching a jnp array created inside a trace
        # would leak a tracer into later traces
        _DFT_MATS[key] = (np.cos(ang).astype(dtype), np.sin(ang).astype(dtype))
    c, s = _DFT_MATS[key]
    return jnp.asarray(c), jnp.asarray(s)


def _dft_spectra(x, nfft: int, precision="highest"):
    """(re, im) of the symmetric circular DFT ``W x W`` of zero-padded
    ``x`` (nl, h, w) at size ``nfft`` — the forward half of
    :func:`_dft_convolve_same`."""
    dt = x.dtype
    c, s = _dft_mats(nfft, dt)
    mm = partial(jnp.matmul, precision=jax.lax.Precision(precision))
    xp = jnp.pad(x, ((0, 0), (0, nfft - x.shape[1]),
                     (0, nfft - x.shape[2])))
    a = mm(c, xp)
    b = mm(s, xp)
    return mm(a, c) - mm(b, s), -(mm(a, s) + mm(b, c))


def _dft_convolve_same(planes, kernels, n_img: int, n_ker: int,
                       precision="highest"):
    """'same' linear convolution via circular DFTs as real matmuls.

    The FFT-free path (``use_fft=False``): identical maths to
    :func:`_fft_convolve_same` (circular product at the minimal
    alias-free size, exact on the 'same' window) with every transform
    expressed as dense (nfft, nfft) matmuls.

    With W symmetric, F = W X W splits into 6 real matmuls per transform;
    the inverse needs only the real part of the output, 6 more.
    ``precision`` follows ``cfg.conv_precision``.  The transform runs
    at the minimal alias-free size (:func:`_same_fft_size`; 64 not 80
    at production dimpsf) — exact, 0.51x the FLOPs.
    """
    nfft = _same_fft_size(n_img, n_ker)
    dt = planes.dtype
    c, s = _dft_mats(nfft, dt)
    mm = partial(jnp.matmul, precision=jax.lax.Precision(precision))

    # forward transforms: the pad + 6-matmul W x W scheme
    fr, fi = _dft_spectra(planes, nfft, precision)
    gr, gi = _dft_spectra(kernels, nfft, precision)
    hr = fr * gr - fi * gi
    hi = fr * gi + fi * gr
    # real part of conj(W) H conj(W) / nfft^2
    a = mm(c, hr) - mm(s, hi)
    b = mm(c, hi) + mm(s, hr)
    full = (mm(a, c) - mm(b, s)) / (nfft * nfft)
    off = (n_ker - 1) // 2
    return full[..., off:off + n_img, off:off + n_img]


def _direct_convolve_same(planes, kernels, n_img: int, n_ker: int):
    """'same' linear convolution as a grouped direct convolution.

    Same numbers as :func:`_fft_convolve_same` to rounding.  Kept as a
    reference backend for tests (:func:`_dft_convolve_same` is the
    FFT-free pipeline path).
    Each wavelength plane gets its own kernel via ``feature_group_count``.
    True convolution (kernel flipped) to match scipy.signal.fftconvolve
    semantics.
    """
    nl = planes.shape[0]
    if kernels.shape[0] == 1:
        kernels = jnp.broadcast_to(kernels, (nl,) + kernels.shape[1:])
    lhs = planes[None]                               # (1, nl, H, W)
    rhs = kernels[:, None, ::-1, ::-1]               # (nl, 1, kh, kw)
    pad = (n_ker - 1) // 2
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1),
        padding=((pad, pad), (pad, pad)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=nl,
        precision=jax.lax.Precision.HIGHEST)
    return out[0]


def tip_tilt_fwhm(seeing, GL, L0, cfg: GalacsiConfig):
    """Residual tip-tilt FWHM [px] from the high-layer seeing and the
    outer-scale attenuation coefficient (reference psfrec.py:881-903)."""
    seeing_hl = seeing * (1.0 - GL) ** 0.6
    r0_hl = 0.976 * 0.5 / seeing_hl / 4.85
    c_hl = tt_attenuation(L0)
    return (jnp.sqrt(c_hl * 0.97 * 6.88 * (0.5e-6 / (2.0 * np.pi)) ** 2 *
                     8.0 ** (-1.0 / 3.0) * r0_hl ** (-5.0 / 3.0)) /
            4.85e-6 * 2.35 / cfg.pixscale)


def convolve_final(psf, lbda_nm, seeing, GL, L0, cfg: GalacsiConfig):
    """AO PSF cube -> final PSF cube (tip-tilt then MUSE-intrinsic Moffat).

    All arguments may be traced; output matches reference
    ``convolve_final_psf`` to float precision (validated vs the oracle).
    """
    dtype = jnp.dtype(cfg.dtype)
    psf = psf.astype(dtype)
    nl, n_img = psf.shape[0], psf.shape[1]
    n_ker = n_img + (n_img % 2 == 0)  # force odd (psfrec.py:911-915)

    if cfg.use_fft:
        conv = _fft_convolve_same
    else:
        conv = partial(_dft_convolve_same, precision=cfg.conv_precision)

    beta_tt = 2.0
    alpha_tt = moffat_fwhm_to_alpha(tip_tilt_fwhm(seeing, GL, L0, cfg),
                                    beta_tt)
    k_tt = moffat_kernel(alpha_tt, beta_tt, n_ker, dtype)

    fwhm_i, beta_i, _, _ = muse_intrinsic_psf(lbda_nm.astype(dtype))
    alpha_i = moffat_fwhm_to_alpha(fwhm_i / cfg.pixscale, beta_i)
    k_i = _batched_kernels(alpha_i, beta_i, n_ker, dtype)

    psf = conv(psf, k_tt[None], n_img, n_ker)
    return conv(psf, k_i, n_img, n_ker)


def _batched_kernels(alphas, betas, size: int, dtype):
    """(nl,) Moffat parameters -> (nl, size, size) kernels, vectorised.

    Delegates to :func:`core.moffat.moffat_kernel` so the
    parity-critical amplitude/centring/no-renormalisation convention
    (documented there) lives in exactly one place."""
    return jax.vmap(lambda a, b: moffat_kernel(a, b, size, dtype)
                    )(alphas.astype(dtype), betas.astype(dtype))
