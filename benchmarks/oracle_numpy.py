"""Pure-NumPy float64 oracle for the GLAO PSF-reconstruction pipeline.

This module is an *independent* re-derivation of the algorithm implemented by
the reference package (musevlt/muse-psfr, see /root/reference/muse_psfr/
psfrec.py).  It exists for two purposes:

1. Golden data: the JAX framework (``muse_psfr_tpu``) is validated
   stage-by-stage against this oracle, and the oracle itself is validated
   against the reference's published golden values
   (test_psfrec.py:121-128: FWHM 0.85/0.73/0.62, BETA 2.73/2.55/2.23 at
   seeing=1", GL=0.7, L0=25 m).

2. Baseline cost model: ``bench.py`` times this oracle (same FFT count and
   dtype as the reference: four complex 1280^2 FFTs per wavelength and
   direction, float64, single thread of NumPy) to compute ``vs_baseline``.

The reference's IDL-inherited quirks are reproduced deliberately; each one is
flagged with a ``QUIRK`` comment and a pointer into the reference source.

No code is copied from the reference; the algorithm is Fusco et al. (2020),
A&A 635, A208.
"""

import numpy as np
from math import gamma as _gamma
from numpy.fft import fft2, ifft2, fftshift

from scipy.optimize import least_squares
from scipy.signal import fftconvolve

# ---------------------------------------------------------------------------
# constants of the GALACSI WFM system (reference psfrec.py:70-104)
# ---------------------------------------------------------------------------
DPUP = 8.0            # telescope diameter [m]
OCC = 0.14            # central obscuration (linear fraction)
ALT_DM = 1.0          # DM conjugation altitude [m]
LAMBDA_REF = 0.5      # reference wavelength [um]
NACT = 24.0           # linear number of actuators
FSAMP = 1000.0        # WFS sampling frequency [Hz]
DELAY_MS = 2.5        # loop delay [ms]
SEP_LGS = 63.0        # LGS radial separation [arcsec]
NOISE_LGS2 = 1.0      # WFS noise [rad^2]
WIND_SPEED = 12.5     # all layers [m/s]
WIND_DIR = np.array([0.628163, -0.326497])  # [rad], pinned IDL values
DIM_PUP = 40          # correction-zone pupil size [px]
ARCMIN_TO_RAD = 60.0 / 206265.0
CST_VK = 0.0229       # von-Karman prefactor used in the PSD driver

# LGS positions on the unit square; 3-LGS mode keeps the first three
# (reference psfrec.py:86-91: geometry does NOT depend on which laser failed)
POSLGS4 = np.array([[1.0, -1.0, -1.0, 1.0],
                    [1.0, -1.0, 1.0, -1.0]]) * SEP_LGS


def seeing_to_r0(seeing, lbda_um=0.5, zenith_deg=0.0):
    """Fried parameter [m] from seeing [arcsec @ 0.5um] at wavelength/zenith."""
    r0_half_um = 0.976 * 0.5 / seeing / 4.85
    return (r0_half_um * (2.0 * lbda_um) ** 1.2
            * np.cos(np.deg2rad(zenith_deg)) ** 0.6)


def pupil(radius, width, oc=0.0, inverse=False):
    """Annular pupil mask: 1 inside [oc, 1) * radius, else 0."""
    c = (width - 1) / 2.0
    y = np.arange(width)[:, None] - c
    x = np.arange(width)[None, :] - c
    rho = np.hypot(y, x) / radius
    m = (rho < 1.0) & (rho >= oc)
    return (~m if inverse else m).astype(float)


def freq_grids(n, df_inv):
    """FFT-ordered frequency grids + the IDL-arctan polar decomposition.

    QUIRK (psfrec.py:548-554): the polar angle is arctan(fy/fx), *not*
    arctan2, so f_x = |fx| and f_y = sign(fx)*fy.  Harmless for the output
    PSD (it conjugates every phasor consistently) but kept for parity.
    """
    fx = np.fft.fftfreq(n, df_inv)[:, None]
    fy = fx.T
    f = np.hypot(fx, fy)
    with np.errstate(all="ignore"):
        t = fy / fx
    t = np.where((fx == 0) & (fy == 0), 0.0, t)  # QUIRK: arg_f[0,0] = 0
    arg = np.arctan(t)
    return f, f * np.cos(arg), f * np.sin(arg)


def vk_psd(f, r0, L0, cst=CST_VK):
    """von-Karman phase PSD [rad^2 m^2]."""
    return cst * r0 ** (-5.0 / 3.0) * (f ** 2 + 1.0 / L0 ** 2) ** (-11.0 / 6.0)


def wfs_tf(f, f_x, f_y, pitch, strict):
    """Shack-Hartmann WFS transfer function, zeroed past the cutoff.

    QUIRK (psfrec.py:251-257 and 429-435): the zeroing mask is
    ``((f != 0) & (|f_x| >= fc)) | (|f_y| >= fc)`` -- '&' binds before '|'
    (missing parentheses in the original).  The reconstructor uses '>=' and
    the residual-PSD model uses '>'; both land exactly on grid frequencies.
    """
    w = 2j * np.pi * f * np.sinc(pitch * f_x) * np.sinc(pitch * f_y)
    fc = 1.0 / (2.0 * pitch)
    if strict:
        kill = ((f != 0) & (np.abs(f_x) > fc)) | (np.abs(f_y) > fc)
    else:
        kill = ((f != 0) & (np.abs(f_x) >= fc)) | (np.abs(f_y) >= fc)
    return np.where(kill, 0.0, w)


def glao_reconstructor(f, f_x, f_y, poslgs_amin, sigr, pitch,
                       dsp_recons=None):
    """Per-frequency GLAO reconstructor W1 for one reconstructed layer.

    Closed form of the reference's per-pixel scalar inversion
    (psfrec.py:218-364, always nb_h_recons == 1):

        W1_g = conj(M_g)/sigma_g / (sum_k |M_k|^2/sigma_k [+ 1/DSP_recons])

    with the DC term zeroed.  ``dsp_recons`` enables the MAP prior (law
    != 'LSE'); the shipped pipeline always uses LSE (dsp_recons=None).
    """
    nb_gs = poslgs_amin.shape[1]
    w = wfs_tf(f, f_x, f_y, pitch, strict=False)
    phase = (f_x[None] * poslgs_amin[0, :, None, None] +
             f_y[None] * poslgs_amin[1, :, None, None]) * ALT_DM * ARCMIN_TO_RAD
    M = w[None] * np.exp(2j * np.pi * phase)          # (nb_gs, s, s)
    num = M.conj() / sigr[:, None, None]
    den = np.sum(M * num, axis=0)                      # = sum |M|^2 / sigma
    if dsp_recons is not None:
        prior = 1.0 / dsp_recons
        prior_flat = prior.copy()
        prior_flat[0, 0] = 0.0                         # piston filtered
        den = den + prior_flat
    inv = np.where(den != 0, 1.0 / np.where(den == 0, 1.0, den), 0.0)
    inv[0, 0] = 0.0                                    # QUIRK: DC zeroed
    return num * inv[None]


def residual_psd(f, f_x, f_y, poslgs_amin, beta_amin, sigv, dsp_layers,
                 h_layers, h_dm, W, td, ti, wind):
    """Residual phase PSD for one field direction (servo-lag included).

    Implements reconstruction error + noise propagation
    (reference psfrec.py:367-525 with tempo=True, fitting=True).
    """
    nb_layers = len(h_layers)
    w = wfs_tf(f, f_x, f_y, pitch=DPUP / NACT, strict=True)

    # model matrix for the true profile, with servo-lag sinc
    ph_gs = (f_x[None] * poslgs_amin[0, :, None, None] +
             f_y[None] * poslgs_amin[1, :, None, None]) * ARCMIN_TO_RAD
    Mv = np.empty((nb_layers, len(sigv)) + f.shape, dtype=complex)
    for i in range(nb_layers):
        for j in range(len(sigv)):
            lag = np.sinc(wind[0, i] * ti[j] * f_x + wind[1, i] * ti[j] * f_y)
            Mv[i, j] = lag * w * np.exp(2j * np.pi * ph_gs[j] * h_layers[i])

    # projection onto the evaluation direction, with frozen-flow back-shift
    dT = ti.max() + td
    bdot = beta_amin[0] * f_x + beta_amin[1] * f_y
    p_beta = np.stack([
        np.exp(2j * np.pi * (h * ARCMIN_TO_RAD * bdot -
                             dT * (wind[0, i] * f_x + wind[1, i] * f_y)))
        for i, h in enumerate(h_layers)])
    p_dm = np.exp(2j * np.pi * h_dm * ARCMIN_TO_RAD * bdot)

    p_w = p_dm[None] * W                               # (nb_gs, s, s)
    p_model = np.einsum('gxy,lgxy->lxy', p_w, Mv)
    proj = p_beta - p_model

    err_recons = np.sum(np.abs(proj) ** 2 * dsp_layers, axis=0)
    err_recons[0, 0] = 0.0
    err_noise = np.sum(np.abs(p_w) ** 2 * sigv[:, None, None], axis=0)
    err_noise[0, 0] = 0.0
    return err_recons + err_noise


def psd_fitting_error(dim, L, r0, L0, fc):
    """Fitting-error PSD (f >= fc) on the full grid, image-centred order.

    Uses the exact gamma-function prefactor (reference psfrec.py:616-626);
    the grid is centred on (dim-1)/2, a half pixel off the FFT convention.
    """
    assert dim % 2 == 0
    c = (dim - 1) / 2.0
    fx = (np.arange(dim) - c)[:, None] / L
    fy = fx.T
    f = np.hypot(fx, fy)
    cst = ((_gamma(11 / 6) ** 2 / (2 * np.pi ** (11 / 3))) *
           (24 * _gamma(6 / 5) / 5) ** (5 / 6))
    out = np.where(f >= fc,
                   cst * r0 ** (-5 / 3) * (f ** 2 + 1.0 / L0 ** 2) ** (-11 / 6),
                   0.0)
    return out


def direction_grid(npts, field_size=60.0):
    """npts^2 field positions (arcsec), +-field_size/2 at the corners."""
    g = (np.mgrid[:npts, :npts] - npts // 2) * field_size / 2.0
    return g.reshape(2, -1)


def simulate_psd(cn2, h, seeing, L0, npsflin=1, dim=1280,
                 three_lgs_mode=False):
    """Residual-phase PSD cube (ndir, dim, dim) in nm^2 per freq^2.

    Mirrors reference simul_psd_wfm (psfrec.py:36-151) + dsp4muse (531-613).
    """
    cn2 = np.asarray(cn2, dtype=float)
    cn2 = cn2 / cn2.sum()
    h = np.asarray(h)
    # QUIRK (psfrec.py:61): wind speed is ``np.full_like(h, 12.5)``; with the
    # default integer altitudes h=(100, 10000) the 12.5 m/s silently
    # truncates to 12 m/s.  Reproduced dtype-faithfully.
    wind_speed = np.full_like(h, WIND_SPEED).astype(float)
    h = h.astype(float)

    poslgs = POSLGS4[:, :3] if three_lgs_mode else POSLGS4
    nb_gs = poslgs.shape[1]
    r0ref = seeing_to_r0(seeing)
    dirperf = direction_grid(npsflin)

    # --- correction-zone PSD on the (2*DIM_PUP)^2 grid -------------------
    dimall = 2 * DIM_PUP
    f, f_x, f_y = freq_grids(dimall, DPUP / DIM_PUP)
    poslgs_amin = poslgs / 60.0
    dirperf_amin = dirperf / 60.0

    dsp_layers = vk_psd(f, cn2[:, None, None] ** (-3 / 5) * r0ref, L0)

    sigr = np.full(nb_gs, NOISE_LGS2)
    ti = np.full(nb_gs, 1.0 / FSAMP)
    td = DELAY_MS * 1e-3
    pitch = DPUP / NACT
    wind = np.stack([wind_speed * np.cos(WIND_DIR),
                     wind_speed * np.sin(WIND_DIR)])

    W = glao_reconstructor(f, f_x, f_y, poslgs_amin, sigr, pitch)

    ndir = dirperf_amin.shape[1]
    dsp = np.empty((ndir, dimall, dimall))
    for b in range(ndir):
        dsp[b] = residual_psd(f, f_x, f_y, poslgs_amin, dirperf_amin[:, b],
                              sigr, dsp_layers, h, ALT_DM, W, td, ti, wind)
    # QUIRK (psfrec.py:611-613): IDL row/column convention -> transpose
    dsp = np.swapaxes(dsp, -1, -2)

    # --- merge with the fitting-error PSD on the full grid ---------------
    fc = 1.0 / (2.0 * pitch)
    full = psd_fitting_error(dim, 2 * DPUP, r0ref, L0, fc)
    out = np.broadcast_to(full, (ndir, dim, dim)).copy()
    sl = slice(dim // 2 - DIM_PUP, dim // 2 + DIM_PUP)
    out[:, sl, sl] = np.maximum(full[sl, sl], fftshift(dsp, axes=(1, 2)))
    return out * (LAMBDA_REF * 1000.0 / (2 * np.pi)) ** 2


def psd_to_psf(psd, pup, lbda_m):
    """Long-exposure PSF from residual PSD (nm^2) + pupil.

    The live branch of reference psd_to_psf (psfrec.py:689-807): samp = 2 =
    dim/npup and FoV == FoVnum (the oversampling/extrapolation branches are
    unreachable there and crash if forced).
    """
    dim = psd.shape[0]
    npup = pup.shape[0]
    sampnum = dim / npup
    L = DPUP * sampnum

    convnm = 2 * np.pi / (lbda_m * 1e9)
    bg = ifft2(fftshift(psd * convnm ** 2)) * (psd.size / L ** 2)
    Dphi = fftshift(2 * (bg[0, 0].real - bg.real))

    tab = np.zeros((dim, dim), dtype=complex)
    tab[:npup, :npup] = pup
    dl_otf = fftshift(np.abs(fft2(np.abs(ifft2(tab)) ** 2)) / pup.sum())

    sys_otf = fftshift(np.exp(-Dphi / 2) * dl_otf)
    psf = np.real(fftshift(ifft2(sys_otf)))
    return psf / psf.sum()


def bilinear_regrid(arr, scale, nout):
    """out[i, j] = bilinear(arr, (scale*i, scale*j)) on index coordinates."""
    pos = np.arange(nout) * scale
    i0 = np.floor(pos).astype(int)
    i0 = np.minimum(i0, arr.shape[0] - 2)
    t = pos - i0
    rows = arr[i0] * (1 - t)[:, None] + arr[i0 + 1] * t[:, None]
    return rows[:, i0] * (1 - t)[None, :] + rows[:, i0 + 1] * t[None, :]


def psf_cube_from_psd(psd, lbda_nm, dimpsf=40, pixscale=0.2):
    """Per-wavelength PSF cube at the MUSE sampling (reference psf_muse)."""
    if psd.ndim == 2:
        psd = psd[None]
    ndir, dim = psd.shape[0], psd.shape[1]
    pup = pupil(dim / 4, dim // 2, oc=OCC)
    nl = len(lbda_nm)
    # QUIRK: np.round is banker's rounding; the reference relies on it.
    npixc = (np.round((dimpsf * pixscale * 2 * DPUP * 4.85 * 1000 /
                       np.asarray(lbda_nm)) / 2) * 2).astype(int)
    out = np.empty((nl, dimpsf, dimpsf))
    for i in range(nl):
        acc = np.zeros((npixc[i], npixc[i]))
        for j in range(ndir):
            p = psd_to_psf(psd[j], pup, lbda_nm[i] * 1e-9)
            c = dim // 2
            acc += p[c - npixc[i] // 2:c + npixc[i] // 2,
                     c - npixc[i] // 2:c + npixc[i] // 2]
        acc /= ndir
        acc /= acc.sum()
        np.maximum(acc, 0, out=acc)
        out[i] = bilinear_regrid(acc, npixc[i] / dimpsf, dimpsf)
    return out / out.sum(axis=(1, 2))[:, None, None]


# ---------------------------------------------------------------------------
# final convolutions (tip-tilt + instrument PSF)
# ---------------------------------------------------------------------------

def moffat_kernel(alpha, beta, size):
    """Discrete Moffat kernel, analytic amplitude (beta-1)/(pi alpha^2).

    Equivalent to astropy's Moffat2DKernel(gamma=alpha, alpha=beta) sampled
    at pixel centres, *not* renormalised (reference psfrec.py:916, 927).
    """
    c = (size - 1) / 2.0
    y = np.arange(size)[:, None] - c
    x = np.arange(size)[None, :] - c
    rr = (x ** 2 + y ** 2) / alpha ** 2
    return (beta - 1) / (np.pi * alpha ** 2) * (1 + rr) ** (-beta)


def muse_intrinsic_psf(lbda_nm):
    """MUSE intrinsic Moffat(lambda) polynomial model (psfrec.py:1144-1171)."""
    pol_beta = [-0.83704697, 1.1337153, 0.0609222, -1.35581762,
                1.15237178, 2.2106042]
    pol_fwhm = [0.60467385, -1.58905792, 1.75293264, -1.0368302,
                0.21487023, 0.34851139]
    lb = (10 * np.asarray(lbda_nm) - 4750) / (9350 - 4750)
    return np.polyval(pol_fwhm, lb), np.polyval(pol_beta, lb)


def load_tt_coeff_table():
    from muse_psfr_tpu.core.coeff_l0 import COEFF_L0_GRID, COEFF_L0_VALUES
    return np.asarray(COEFF_L0_GRID), np.asarray(COEFF_L0_VALUES)


def convolve_tt_and_instrument(psf, lbda_nm, seeing, GL, L0,
                               pixscale=0.2):
    """Convolve the AO PSF cube with the tip-tilt and MUSE-intrinsic Moffats
    (reference convolve_final_psf, psfrec.py:874-930)."""
    seeing_hl = seeing * (1 - GL) ** 0.6
    r0_hl = 0.976 * 0.5 / seeing_hl / 4.85
    grid, coeff = load_tt_coeff_table()
    c_hl = np.interp(L0, grid, coeff)
    fwhm_tt = (np.sqrt(c_hl * 0.97 * 6.88 * (0.5e-6 / (2 * np.pi)) ** 2 *
                       8.0 ** (-1 / 3) * r0_hl ** (-5 / 3)) /
               4.85e-6 * 2.35 / pixscale)
    alpha_tt = fwhm_tt / (2 * np.sqrt(2 ** (1 / 2.0) - 1))

    n = psf.shape[1] + (psf.shape[1] % 2 == 0)         # force odd kernel
    k_tt = moffat_kernel(alpha_tt, 2.0, n)
    psf = fftconvolve(psf, k_tt[None], mode="same")

    fwhm_i, beta_i = muse_intrinsic_psf(lbda_nm)
    alpha_i = (fwhm_i / pixscale) / (2 * np.sqrt(2 ** (1 / beta_i) - 1))
    out = np.empty_like(psf)
    for k in range(psf.shape[0]):
        out[k] = fftconvolve(psf[k], moffat_kernel(alpha_i[k], beta_i[k], n),
                             mode="same")
    return out


# ---------------------------------------------------------------------------
# Moffat fit (replaces mpdaf Image.moffat_fit, circular, no background)
# ---------------------------------------------------------------------------

def fit_moffat_circular(img):
    """LM fit of I*(1+(r/alpha)^2)^(-n); returns dict of params + errors."""
    ny, nx = img.shape
    y, x = np.mgrid[:ny, :nx].astype(float)
    peak0 = img.max()
    cy0, cx0 = np.unravel_index(np.argmax(img), img.shape)
    tot = img.sum()
    var = (img * ((y - cy0) ** 2 + (x - cx0) ** 2)).sum() / tot
    fwhm0 = max(2.355 * np.sqrt(max(var, 0.25) / 2), 1.0)
    a0 = fwhm0 / (2 * np.sqrt(2 ** 0.5 - 1))

    def resid(p):
        cy, cx, peak, a, n = p
        rr = ((y - cy) ** 2 + (x - cx) ** 2) / a ** 2
        return (peak * (1 + rr) ** (-n) - img).ravel()

    sol = least_squares(resid, [cy0, cx0, peak0, a0, 2.0], method="lm",
                        xtol=1e-14, ftol=1e-14)
    cy, cx, peak, a, n = sol.x
    dof = img.size - 5
    j = sol.jac
    cov = np.linalg.inv(j.T @ j) * (sol.fun @ sol.fun) / dof
    err = np.sqrt(np.diag(cov))

    k_f = 2 * np.sqrt(2 ** (1 / n) - 1)
    fwhm = a * k_f
    dk_dn = -np.log(2) * 2 ** (1 / n) / (n ** 2 * np.sqrt(2 ** (1 / n) - 1))
    err_fwhm = np.sqrt((k_f * err[3]) ** 2 + (a * dk_dn * err[4]) ** 2)
    flux = peak * np.pi * a ** 2 / (n - 1)
    err_flux = abs(flux) * np.sqrt(
        (err[2] / peak) ** 2 + (2 * err[3] / a) ** 2 + (err[4] / (n - 1)) ** 2)
    return dict(center=np.array([cy, cx]), err_center=err[:2].copy(),
                flux=flux, err_flux=err_flux, peak=peak, err_peak=err[2],
                fwhm=np.array([fwhm, fwhm]),
                err_fwhm=np.array([err_fwhm, err_fwhm]), n=n, err_n=err[4])


# ---------------------------------------------------------------------------
# end-to-end single condition
# ---------------------------------------------------------------------------

def compute_psf_oracle(lbda_nm, seeing, GL, L0, npsflin=1, h=(100, 10000),
                       three_lgs_mode=False):
    """seeing/GL/L0 -> (list of moffat-fit dicts, final PSF cube)."""
    lbda_nm = np.asarray(lbda_nm, dtype=float)
    psd = simulate_psd([GL, 1 - GL], h, seeing, L0, npsflin=npsflin,
                       three_lgs_mode=three_lgs_mode)
    if npsflin == 1:
        psd = psd[0]
    psf = psf_cube_from_psd(psd, lbda_nm)
    psf = convolve_tt_and_instrument(psf, lbda_nm, seeing, GL, L0)
    fits = [fit_moffat_circular(plane) for plane in psf]
    for f, lb in zip(fits, lbda_nm):
        f["lbda"] = lb
        f["fwhm"] = f["fwhm"] * 0.2
        f["err_fwhm"] = f["err_fwhm"] * 0.2
    return fits, psf
