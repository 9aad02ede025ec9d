"""Reference-compatible API: every public name of ``muse_psfr.psfrec``.

The reference package exports its whole module namespace
(``from .psfrec import *``, reference __init__.py:16); code written
against it can ``import muse_psfr`` and keep working — the ``muse_psfr``
package shipped with this framework re-exports this module.  Each function
keeps the reference's signature and output conventions (NumPy float64
arrays, int pupil masks) while executing on the JAX core.

Reference citations are per function; reference source is
``muse_psfr/psfrec.py`` unless stated.
"""

import functools
import logging
from contextlib import nullcontext

import jax
import numpy as np
import jax.numpy as jnp

from .api import (MIN_L0, MAX_L0, compute_psf, compute_psf_from_sparta,  # noqa: F401
                  fit_table_from_arrays)
from .config import DEFAULT_CONFIG
from .core.grids import (fft_freq_polar, direction_grid, lgs_positions,
                         pupil_mask as _pupil_mask_f)
from .core.moffat import muse_intrinsic_psf as _intrinsic
from .core.vonkarman import fitting_psd
from .fit.moffat_fit import fit_moffat_cube
from .fit.polynom import fit_psf_with_polynom  # noqa: F401
from .io.sparta import create_sparta_table  # noqa: F401
from .otf.convolve import convolve_final
from .otf.psf import psf_cube, psd_to_psf as _psd_to_psf_impl
from .plotting import plot_psf, radial_profile, plot_directions  # noqa: F401
from .psd import model as _m

logger = logging.getLogger("muse_psfr.compat")


def _x64_context():
    """Locally enable 64-bit JAX types where the backend supports them.

    The reference runs float64 end-to-end; this shim's parity contract is
    float64, but a fresh interpreter has ``jax_enable_x64`` off and JAX
    silently truncates requested float64 arrays to float32.  On the CPU
    and GPU backends (both have native float64) every compat computation
    runs under an x64 scope; any other backend uses the float32 pipeline
    as-is (documented precision: ~2e-6 rms, budget 1e-5).
    """
    if jax.default_backend() not in ("cpu", "gpu"):
        return nullcontext()
    try:
        return jax.enable_x64(True)  # public scoped-x64 API (jax >= 0.4.26)
    except Exception:  # fallback for a jax without scoped x64
        logger.warning(
            "scoped x64 unavailable in this jax (%s): enabling "
            "jax_enable_x64 GLOBALLY to preserve the float64 parity "
            "contract", jax.__version__)
        jax.config.update("jax_enable_x64", True)
        return nullcontext()


def reference_precision(fn):
    """Run a compat function under the reference's float64 precision."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _x64_context():
            return fn(*args, **kwargs)
    return wrapper


@reference_precision
def psd_to_psf(*args, **kwargs):
    """General PSD->PSF forward model at reference (float64) precision
    where the backend allows (see muse_psfr_tpu.otf.psf.psd_to_psf)."""
    return _psd_to_psf_impl(*args, **kwargs)


@reference_precision
def seeing2r01(seeing, lbda, zenith):
    """Fried parameter from seeing (reference psfrec.py:183-187)."""
    return np.asarray(_m.seeing_to_r0(seeing, lbda, zenith), float)


@reference_precision
def pupil_mask(radius, width, oc=0, inverse=False):
    """Annular pupil mask, int array (reference psfrec.py:190-203)."""
    return np.asarray(_pupil_mask_f(radius, int(width), oc, inverse,
                                    jnp.float64)).astype(int)


def direction_perf(npts, field_size=60, plot=False, lgs=None, ngs=None,
                   ax=None):
    """Field evaluation grid [arcsec] (reference psfrec.py:154-180)."""
    if plot:
        plot_directions(npts, lgs=lgs, ngs=ngs, ax=ax)
    return direction_grid(npts, field_size)


@reference_precision
def calc_var_from_psd(psd, pixsize, Dpup):
    """Residual variance excluding the 1/D box (psfrec.py:206-215)."""
    return float(_m.residual_variance(jnp.asarray(psd, jnp.float64),
                                      pixsize, Dpup))


@reference_precision
def psd_fit(dim, L, r0, L0, fc):
    """Fitting-error PSD, FFT-ordered (reference psfrec.py:616-626)."""
    from .core.grids import centered_freq_radius
    out = fitting_psd(jnp.asarray(centered_freq_radius(int(dim), L)),
                      r0, L0, fc)
    # the reference returns the fftshifted-grid (= FFT-ordered) variant
    return np.fft.fftshift(np.asarray(out, float))


def crop(arr, center, size):
    """Central square crop (reference psfrec.py:629-632)."""
    center, size = int(center), int(size)
    sl = slice(center - size, center + size)
    return arr[sl, sl]


def interpolate(arr, xout, method="linear"):
    """IDL-``interpolate`` shim on index coordinates (psfrec.py:635-641)."""
    if method == "cubic":
        raise NotImplementedError("cubic interpolation is unimplemented in "
                                  "the reference as well")
    from scipy.interpolate import interpn
    xin = np.arange(arr.shape[0])
    return interpn((xin, xin), np.asarray(arr), np.asarray(xout).T,
                   method="linear").T


def _grids_from_ref(f, arg_f):
    """Reference-style (f, arg_f) -> (f, f_x, f_y) arrays."""
    f = jnp.asarray(f, jnp.float64)
    arg_f = jnp.asarray(arg_f, jnp.float64)
    return f, f * jnp.cos(arg_f), f * jnp.sin(arg_f)


@reference_precision
def calc_mat_rec_glao_finale(f, arg_f, pitchs_wfs, pitchs_dm, poslgs, sigr,
                             DSP_tab_recons, h_recons, LSE=False):
    """GLAO/tomographic reconstructor (reference psfrec.py:218-364).

    Output shape (nb_gs, nb_h_recons, s, s); only one reconstructed layer
    is supported (the reference raises NotImplementedError for more,
    psfrec.py:341).
    """
    h_recons = np.atleast_1d(h_recons)
    if h_recons.size > 1:
        raise NotImplementedError("multi-layer tomographic inversion is "
                                  "unimplemented in the reference as well")
    f, f_x, f_y = _grids_from_ref(f, arg_f)
    poslgs = jnp.asarray(poslgs, jnp.float64)
    nb_gs = poslgs.shape[1]
    dsp_recons = None
    if not LSE:
        dsp_recons = jnp.asarray(np.atleast_3d(DSP_tab_recons)
                                 .reshape(-1, f.shape[0], f.shape[1])[0],
                                 jnp.float64)
    W = _m.glao_reconstructor(f, f_x, f_y, poslgs,
                              jnp.ones(nb_gs, jnp.float64),
                              jnp.asarray(sigr, jnp.float64),
                              jnp.asarray(pitchs_wfs, jnp.float64),
                              float(h_recons[0]), jnp.complex128,
                              dsp_recons=dsp_recons)
    return np.asarray(W)[:, None]


@reference_precision
def calc_dsp_res_glao_finale(f, arg_f, pitchs_wfs, poslgs, beta, sigv,
                             DSP_tab_vrai, h_vrai, h_dm, Wmap, td, ti, wind,
                             tempo=False, fitting=False, err_recons=None,
                             err_noise=None):
    """Residual phase PSD for one direction (reference psfrec.py:367-528)."""
    f, f_x, f_y = _grids_from_ref(f, arg_f)
    poslgs = jnp.asarray(poslgs, jnp.float64)
    nb_gs = poslgs.shape[1]
    h_vrai = np.atleast_1d(np.asarray(h_vrai, float))
    if not tempo:
        wind = np.zeros((2, h_vrai.size))
        ti = np.zeros(nb_gs)
        td = 0.0
    W = np.asarray(Wmap, complex)
    if W.ndim == 3:
        W = W[:, None]                        # (nb_gs, 1, s, s)
    h_dm_arr = np.atleast_1d(np.asarray(h_dm, float))
    if h_dm_arr.size > 1 or W.shape[1] > 1:
        # multiple DM layers: the reference sums the per-DM phasor
        # against Wmap (psfrec.py:460-471, 'sum on nb_h_dm', with numpy
        # broadcasting when the axes mismatch).  Fold that sum into an
        # effective per-GS reconstructor and hand the single-DM core
        # h_dm=0 — its own phasor is then exactly 1, reproducing the
        # reference computation bit-for-bit in host float64.
        bx, by = float(np.asarray(beta)[0]), float(np.asarray(beta)[1])
        fxn, fyn = np.asarray(f_x, float), np.asarray(f_y, float)
        proj_dm = np.exp(1j * 2 * np.pi * h_dm_arr[:, None, None]
                         * 60 / 206265 * (bx * fxn + by * fyn))
        W_eff = np.sum(proj_dm[None] * W, axis=1)
        h_dm_eff = 0.0
    else:
        W_eff, h_dm_eff = W[:, 0], float(h_dm_arr[0])
    res = _m.residual_psd_one_dir(
        f, f_x, f_y, poslgs, jnp.ones(nb_gs, jnp.float64),
        jnp.asarray(beta, jnp.float64), jnp.asarray(sigv, jnp.float64),
        jnp.asarray(DSP_tab_vrai, jnp.float64), jnp.asarray(h_vrai),
        h_dm_eff, jnp.asarray(W_eff, jnp.complex128), float(td),
        jnp.asarray(ti, jnp.float64), jnp.asarray(wind, jnp.float64),
        jnp.asarray(pitchs_wfs, jnp.float64), jnp.complex128)
    res = np.asarray(res, float)
    if fitting:
        return res
    fc = np.max(1.0 / (2.0 * np.asarray(pitchs_wfs)))
    fn, fxn, fyn = (np.asarray(a) for a in (f, f_x, f_y))
    return np.where((fn != 0) & (abs(fxn) <= fc) & (abs(fyn) <= fc), res, 0)


@reference_precision
def dsp4muse(Dpup, pupdim, dimall, Cn2, hh, L0, r0ref, recons_cn2, h_recons,
             vent, arg_v, law, nsspup, nact, Fsamp, delay, bruitLGS2,
             lambdaref, poslgs, dirperf):
    """Correction-zone PSD driver (reference psfrec.py:531-613): von Karman
    layer PSDs, one reconstructor, one residual PSD per direction, IDL
    row/column transpose."""
    poslgs1 = np.asarray(poslgs, float) / 60.0
    dirperf1 = np.atleast_2d(np.asarray(dirperf, float)) / 60.0
    dimall = int(dimall)
    f, f_x, f_y = fft_freq_polar(dimall, Dpup / pupdim, jnp.float64)

    cst = 0.0229
    recons_cn2 = np.atleast_1d(recons_cn2)
    dsp_recons = (cst * (recons_cn2[0] ** (-3 / 5) * r0ref) ** (-5 / 3)
                  * (np.asarray(f) ** 2 + 1.0 / L0 ** 2) ** (-11 / 6))
    hh = np.atleast_1d(np.asarray(hh, float))
    Cn2 = np.atleast_1d(np.asarray(Cn2, float))
    dsp_vrai = (cst * (Cn2[:, None, None] ** (-3 / 5) * r0ref) ** (-5 / 3)
                * (np.asarray(f)[None] ** 2 + 1.0 / L0 ** 2) ** (-11 / 6))

    nb_gs = poslgs1.shape[1]
    sig2 = np.repeat(bruitLGS2, nb_gs)
    ti = np.repeat(1.0 / Fsamp, nb_gs)
    td = delay * 1e-3
    pitchs_wfs = np.repeat(Dpup / nsspup, nb_gs)
    h_dm = 1.0
    wind = np.stack([vent * np.cos(arg_v), vent * np.sin(arg_v)])

    W = _m.glao_reconstructor(
        f, f_x, f_y, jnp.asarray(poslgs1), jnp.ones(nb_gs, jnp.float64),
        jnp.asarray(sig2), jnp.asarray(pitchs_wfs),
        float(np.atleast_1d(h_recons)[0]), jnp.complex128,
        dsp_recons=(None if law == "LSE" else jnp.asarray(dsp_recons)))

    L = Dpup * dimall / pupdim
    pixsize = 1.0 / L
    out = np.empty((dirperf1.shape[1], dimall, dimall))
    for b in range(dirperf1.shape[1]):
        res = _m.residual_psd_one_dir(
            f, f_x, f_y, jnp.asarray(poslgs1), jnp.ones(nb_gs, jnp.float64),
            jnp.asarray(dirperf1[:, b]), jnp.asarray(sig2),
            jnp.asarray(dsp_vrai), jnp.asarray(hh), h_dm, W, td,
            jnp.asarray(ti), jnp.asarray(wind), jnp.asarray(pitchs_wfs),
            jnp.complex128)
        out[b] = np.asarray(res)
        resval = calc_var_from_psd(out[b], pixsize, Dpup)
        logger.debug("dirperf=%d, %.2f", b,
                     np.sqrt(resval) * lambdaref * 1e3 / (2 * np.pi))
    # QUIRK: IDL row/column convention (psfrec.py:611-613)
    return np.swapaxes(out, -1, -2)


@reference_precision
def simul_psd_wfm(Cn2, h, seeing, L0, zenith=0., plot=False, npsflin=1,
                  dim=1280, three_lgs_mode=False, verbose=True):
    """Full-grid residual PSD per direction [nm^2] (psfrec.py:36-151)."""
    if three_lgs_mode and verbose:
        logger.info("Using three lasers mode")
    cfg = DEFAULT_CONFIG.with_(dtype="float64", dim=int(dim))
    Cn2 = np.asarray(Cn2, float)
    if Cn2.size != 2 or np.asarray(h).size != 2:
        # the reference has the same limitation: its wind-direction array
        # is pinned to two IDL values (psfrec.py:66), so any profile with
        # != 2 layers crashes there with a broadcast error (verified)
        raise NotImplementedError(
            "only two-layer (ground + high) Cn2/h profiles are supported, "
            "as in the reference implementation")
    GL = Cn2[0] / Cn2.sum()
    gs_mask = jnp.array([1.0, 1.0, 1.0, 0.0 if three_lgs_mode else 1.0],
                        jnp.float64)
    ws = _m.effective_wind_speed(h, cfg)
    out = _m.simulate_psd(float(seeing), float(GL), float(L0), gs_mask,
                          jnp.asarray(np.asarray(h, float)), ws,
                          int(npsflin), cfg, zenith=float(zenith))
    if plot:
        plot_directions(npsflin, lgs=lgs_positions(cfg.sep_lgs))
    return np.asarray(out, float)


@reference_precision
def psf_muse(psd, lambdamuse):
    """PSD cube -> PSF cube at the MUSE sampling (psfrec.py:644-686)."""
    lam = np.atleast_1d(np.asarray(lambdamuse, float))
    cfg = DEFAULT_CONFIG.with_(dtype="float64",
                               dim=int(np.asarray(psd).shape[-1]))
    out = psf_cube(jnp.asarray(psd, jnp.float64), jnp.asarray(lam), cfg)
    return np.asarray(out, float)


@reference_precision
def muse_intrinsic_psf(lbda):
    """MUSE intrinsic Moffat polynomials (psfrec.py:1144-1171)."""
    fwhm, beta, fwhm_std, beta_std = _intrinsic(jnp.asarray(lbda, jnp.float64))
    return (np.asarray(fwhm, float), np.asarray(beta, float),
            np.asarray(fwhm_std, float), np.asarray(beta_std, float))


@reference_precision
def convolve_final_psf(lbda, seeing, GL, L0, psf):
    """Tip-tilt + instrument convolutions (psfrec.py:874-930)."""
    lam = np.atleast_1d(np.asarray(lbda, float))
    cfg = DEFAULT_CONFIG.with_(dtype="float64")
    out = convolve_final(jnp.asarray(psf, jnp.float64), jnp.asarray(lam),
                         float(seeing), float(GL), float(L0), cfg)
    return np.asarray(out, float)


@reference_precision
def fit_psf_cube(lbda, psfcube):
    """Circular Moffat fit of every wavelength plane (psfrec.py:861-871).

    ``psfcube`` may be an ndarray or any iterable of 2-D planes (the
    reference passes an mpdaf Cube).  Returns a FitTable with the
    reference's columns, FWHM in arcsec.
    """
    cube = np.asarray([np.asarray(p, float) for p in psfcube])
    fit = fit_moffat_cube(jnp.asarray(cube), dtype="float64")
    return fit_table_from_arrays(np.asarray(lbda, float), fit)
