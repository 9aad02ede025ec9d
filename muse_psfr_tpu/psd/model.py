"""GLAO residual-phase PSD model (JAX).

Batched JAX reformulation of the reference's PSD layer
(``calc_mat_rec_glao_finale`` psfrec.py:218-364, ``calc_dsp_res_glao_finale``
367-528, ``dsp4muse`` 531-613, ``simul_psd_wfm`` 36-151):

* the reference's per-pixel Python inversion loop (psfrec.py:332-355)
  collapses to a closed form — with a single reconstructed layer the
  per-frequency system is scalar, so
  ``W_g = conj(M_g)/sigma_g / (sum_k |M_k|^2/sigma_k [+ prior])``;
* all guide-star / layer / direction loops are batch axes (vmap/einsum);
* the 3-laser mode is a per-row guide-star validity *mask* over the fixed
  4-star geometry (masked star => M_g = 0 => exact 3-star algebra), so one
  traced program serves both geometries;
* everything is static-shape and jit/vmap/shard_map friendly.

Verified against the float64 oracle (benchmarks/oracle_numpy.py), itself
verified to <1e-8 absolute against the reference stages.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import GalacsiConfig
from ..core.grids import (fft_freq_polar, centered_freq_radius,
                          direction_grid, lgs_positions)
from ..core.vonkarman import vk_psd, fitting_psd

ARCMIN_TO_RAD = 60.0 / 206265.0


def seeing_to_r0(seeing, lbda_um=0.5, zenith_deg=0.0):
    """Fried parameter [m] from seeing [arcsec @0.5um] (psfrec.py:183-187)."""
    r0_half = 0.976 * 0.5 / seeing / 4.85
    z = jnp.cos(jnp.deg2rad(zenith_deg)) ** 0.6
    return r0_half * (2.0 * lbda_um) ** 1.2 * z


def wfs_transfer(f, f_x, f_y, pitch, strict, cdtype):
    """Shack-Hartmann transfer function ``2*pi*i*f*sinc(p fx)*sinc(p fy)``,
    zeroed past the cutoff.

    ``pitch`` may be a scalar (one transfer function shared by all guide
    stars — the GALACSI case) or a (nb_gs,) array (per-WFS pitches, giving
    a (nb_gs, s, s) result as in the reference's general code path).

    QUIRK (psfrec.py:251-257, 429-435): the zeroing mask is
    ``((f != 0) & (|f_x| >= fc)) | (|f_y| >= fc)`` — '&' binds before '|'
    in the original's un-parenthesised expression.  The reconstructor uses
    '>=', the residual model '>' (``strict``); the cutoff lands exactly on
    grid frequencies so the two differ.
    """
    pitch = jnp.asarray(pitch)
    if pitch.ndim == 1:
        pitch = pitch[:, None, None]
    amp = 2.0 * np.pi * f * jnp.sinc(pitch * f_x) * jnp.sinc(pitch * f_y)
    fc = 1.0 / (2.0 * pitch)
    if strict:
        kill = ((f != 0) & (jnp.abs(f_x) > fc)) | (jnp.abs(f_y) > fc)
    else:
        kill = ((f != 0) & (jnp.abs(f_x) >= fc)) | (jnp.abs(f_y) >= fc)
    return jnp.where(kill, 0.0, amp).astype(cdtype) * 1j


def gs_phasors(f_x, f_y, poslgs_amin, cdtype):
    """Per-guide-star pupil-plane phase slopes (nb_gs, s, s) [rad/m alt].

    Guide-star masking is applied once, on the model matrices M/Mv (the
    load-bearing site): a masked star's M row is exactly zero, which
    reproduces the true 3-star algebra.
    """
    return (f_x[None] * poslgs_amin[0, :, None, None] +
            f_y[None] * poslgs_amin[1, :, None, None]) * ARCMIN_TO_RAD


def glao_reconstructor(f, f_x, f_y, poslgs_amin, gs_mask, sigr, pitch,
                       h_recons, cdtype, dsp_recons=None):
    """Closed-form GLAO reconstructor ``W`` of shape (nb_gs, s, s).

    Replaces reference ``calc_mat_rec_glao_finale`` (psfrec.py:218-364) —
    the per-frequency scalar inversion done in a Python double loop there is
    algebraic here.  ``dsp_recons`` enables the MAP prior (law != LSE);
    the shipped GALACSI pipeline is LSE.  The DC term is zeroed
    (psfrec.py:351-352).
    """
    w = wfs_transfer(f, f_x, f_y, pitch, strict=False, cdtype=cdtype)
    if w.ndim == 2:
        w = w[None]                      # shared transfer fn -> (1, s, s)
    ph = gs_phasors(f_x, f_y, poslgs_amin, cdtype)
    M = (w * jnp.exp(2j * np.pi * h_recons * ph)
         * gs_mask[:, None, None])
    num = M.conj() / sigr[:, None, None]
    den = jnp.sum((M * num).real, axis=0)
    if dsp_recons is not None:
        prior = 1.0 / dsp_recons
        prior = prior.at[0, 0].set(0.0)   # piston filtered (psfrec.py:305)
        den = den + prior
    inv = jnp.where(den != 0, 1.0 / jnp.where(den == 0, 1.0, den), 0.0)
    inv = inv.at[0, 0].set(0.0)
    return num * inv[None]


def residual_psd_one_dir(f, f_x, f_y, poslgs_amin, gs_mask, beta_amin, sigv,
                         dsp_layers, h_layers, h_dm, W, td, ti, wind, pitch,
                         cdtype):
    """Residual phase PSD (s, s) for one evaluation direction.

    Reconstruction error + propagated WFS noise with servo-lag phasors
    (reference ``calc_dsp_res_glao_finale`` psfrec.py:367-525 with
    tempo=True, fitting=True — the shipped path; the final band-cut branch
    there is dead).
    """
    w = wfs_transfer(f, f_x, f_y, pitch, strict=True, cdtype=cdtype)
    if w.ndim == 2:
        w = w[None]                      # shared transfer fn -> (1, s, s)
    ph = gs_phasors(f_x, f_y, poslgs_amin, cdtype)    # (g, s, s)

    # model matrix for the true profile, with the servo-lag sinc
    # (l = true layer, g = guide star)
    lag = jnp.sinc(wind[0, :, None, None, None] * ti[None, :, None, None] * f_x
                   + wind[1, :, None, None, None] * ti[None, :, None, None] * f_y)
    Mv = (lag * w[None] *
          jnp.exp(2j * np.pi * h_layers[:, None, None, None] * ph[None]) *
          gs_mask[None, :, None, None])                         # (l, g, s, s)

    # projector onto the evaluation direction, with frozen-flow back-shift
    dT = jnp.max(ti) + td
    bdot = beta_amin[0] * f_x + beta_amin[1] * f_y
    p_beta = jnp.exp(2j * np.pi * (
        h_layers[:, None, None] * ARCMIN_TO_RAD * bdot[None]
        - dT * (wind[0, :, None, None] * f_x + wind[1, :, None, None] * f_y)))
    p_dm = jnp.exp(2j * np.pi * h_dm * ARCMIN_TO_RAD * bdot)

    p_w = p_dm[None] * W                                        # (g, s, s)
    # guide-star sum as elementwise adds (a dot over 3-4 guide stars
    # could run at reduced matmul precision on an accelerator)
    p_model = jnp.sum(p_w[None] * Mv, axis=1)
    proj = p_beta - p_model

    err_recons = jnp.sum(jnp.abs(proj) ** 2 * dsp_layers, axis=0)
    err_recons = err_recons.at[0, 0].set(0.0)
    err_noise = jnp.sum(jnp.abs(p_w) ** 2 * sigv[:, None, None], axis=0)
    err_noise = err_noise.at[0, 0].set(0.0)
    return err_recons + err_noise


def residual_variance(psd, pixsize, dpup):
    """Residual variance [rad^2] from an FFT-ordered PSD, excluding the
    central 1/D box (reference ``calc_var_from_psd``, psfrec.py:206-215).
    Debug metric reported per direction at DEBUG level."""
    from ..core.grids import pupil_mask
    box = (1.0 / dpup) / pixsize
    mask = pupil_mask(box / 2.0, psd.shape[-1], inverse=True,
                      dtype=psd.dtype)
    shifted = jnp.fft.fftshift(psd, axes=(-2, -1)) * pixsize ** 2
    return jnp.sum(shifted * mask, axis=(-2, -1))


def effective_wind_speed(h, cfg: GalacsiConfig) -> float:
    """Wind speed actually used for the altitude array ``h``.

    QUIRK (psfrec.py:61): the reference builds the wind-speed array with
    ``np.full_like(h, 12.5)``, which inherits ``h``'s dtype — the default
    integer altitudes (100, 10000) silently truncate 12.5 -> 12 m/s.
    """
    return float(np.full(2, cfg.wind_speed, dtype=np.asarray(h).dtype)[0])


_STATIC_TRANSFER_CACHE = {}


def _glao_static_transfer(h, wind_speed, npsflin, cfg: GalacsiConfig):
    """Trace-time float64 GLAO transfer functions (NumPy, cached).

    With the system geometry, altitudes, wind, noise, and loop timing all
    fixed per configuration, the *entire* reconstruction machinery —
    Shack-Hartmann transfer functions, the closed-form reconstructor, the
    servo-lag model matrices and the direction projectors — is independent
    of the telemetry (seeing, GL, L0).  The residual PSD then collapses to

        PSD_d(f) = sum_l |proj_{l,d}(f)|^2 * VK_l(f)  +  noise_d(f)

    where ``|proj|^2`` and ``noise`` are precomputed here in float64 for
    both the 4- and 3-laser geometries (the reference's two cases,
    psfrec.py:86-91), post IDL transpose and fftshift.  This removes the
    float32 near-DC cancellation error of the projector algebra entirely —
    the traced math is two multiply-adds of constants with the von Karman
    spectra — and makes the correction-zone stage nearly free.
    """
    key = (h, wind_speed, npsflin, cfg.dimall, cfg.dpup, cfg.dim_pup,
           cfg.sep_lgs, cfg.noise_lgs2, cfg.fsamp, cfg.delay_ms,
           cfg.alt_dm, cfg.wfs_pitch, cfg.wind_dir_0, cfg.wind_dir_1)
    if key in _STATIC_TRANSFER_CACHE:
        return _STATIC_TRANSFER_CACHE[key]

    s = cfg.dimall
    c = 60.0 / 206265.0
    fx = np.fft.fftfreq(s, cfg.dpup / cfg.dim_pup)[:, None]
    fy = fx.T
    f = np.hypot(fx, fy)
    with np.errstate(all="ignore"):
        t = np.where((fx == 0.0) & (fy == 0.0), 0.0, fy / fx)
    arg = np.arctan(t)
    f_x = f * np.cos(arg)
    f_y = f * np.sin(arg)

    h_arr = np.asarray(h, np.float64)
    wind_dir = np.array([cfg.wind_dir_0, cfg.wind_dir_1])
    wind = wind_speed * np.stack([np.cos(wind_dir), np.sin(wind_dir)])
    dirs = direction_grid(npsflin) / 60.0                # (2, ndir)
    ndir = dirs.shape[1]
    nl = h_arr.size
    td = cfg.delay_ms * 1e-3

    def wfs_np(pitch, strict):
        w = 2j * np.pi * f * np.sinc(pitch * f_x) * np.sinc(pitch * f_y)
        fc = 1.0 / (2.0 * pitch)
        if strict:
            kill = ((f != 0) & (np.abs(f_x) > fc)) | (np.abs(f_y) > fc)
        else:
            kill = ((f != 0) & (np.abs(f_x) >= fc)) | (np.abs(f_y) >= fc)
        return np.where(kill, 0.0, w)

    out = {}
    for tag, nb_gs in (("4", 4), ("3", 3)):
        pos = lgs_positions(cfg.sep_lgs)[:, :nb_gs] / 60.0
        sig = np.full(nb_gs, cfg.noise_lgs2)
        ti = np.full(nb_gs, 1.0 / cfg.fsamp)

        ph = (f_x[None] * pos[0, :, None, None] +
              f_y[None] * pos[1, :, None, None]) * c      # (g, s, s)
        # WFS pitch (dpup/nsspup, psfrec.py:578) — NOT the DM pitch:
        # the two differ when nsspup != nact
        w_rec = wfs_np(cfg.wfs_pitch, strict=False)
        M = w_rec[None] * np.exp(2j * np.pi * cfg.alt_dm * ph)
        num = M.conj() / sig[:, None, None]
        den = np.sum((M * num).real, axis=0)
        inv = np.where(den != 0, 1.0 / np.where(den == 0, 1.0, den), 0.0)
        inv[0, 0] = 0.0
        W = num * inv[None]                               # (g, s, s)

        w_res = wfs_np(cfg.wfs_pitch, strict=True)
        lag = np.sinc(wind[0, :, None, None, None] * ti[None, :, None, None]
                      * f_x +
                      wind[1, :, None, None, None] * ti[None, :, None, None]
                      * f_y)
        Mv = (lag * w_res[None, None] *
              np.exp(2j * np.pi * h_arr[:, None, None, None] * ph[None]))

        # telemetry-independent reconstructor pieces for the MAP law:
        # S_l = sum_g conj(M_g)/sig_g * Mv_{l,g} and D0 = sum_g |M_g|^2
        # /sig_g, so that W(prior) = conj(M)/sig / (D0 + prior) and the
        # residual projector is proj = p_beta - p_dm S_l/(D0 + prior) —
        # only the scalar field 1/(D0 + prior(r0, L0)) is telemetry
        # -dependent (reference psfrec.py:297-324 with its per-pixel
        # inversion made algebraic)
        S = np.einsum("gxy,lgxy->lxy", num, Mv)          # (l, s, s)

        dT = ti.max() + td
        proj2 = np.empty((nl, ndir, s, s))
        noise = np.empty((ndir, s, s))
        p_re = np.empty((nl, ndir, s, s))
        p_im = np.empty((nl, ndir, s, s))
        for d in range(ndir):
            bdot = dirs[0, d] * f_x + dirs[1, d] * f_y
            p_beta = np.exp(2j * np.pi * (
                h_arr[:, None, None] * c * bdot[None]
                - dT * (wind[0, :, None, None] * f_x
                        + wind[1, :, None, None] * f_y)))
            p_dm = np.exp(2j * np.pi * cfg.alt_dm * c * bdot)
            p_w = p_dm[None] * W
            p_model = np.einsum("gxy,lgxy->lxy", p_w, Mv)
            proj2[:, d] = np.abs(p_beta - p_model) ** 2
            noise[d] = np.sum(np.abs(p_w) ** 2 * sig[:, None, None], axis=0)
            P = p_beta.conj() * p_dm[None] * S           # (l, s, s)
            p_re[:, d] = P.real
            p_im[:, d] = P.imag
        # DC zeroing (psfrec.py:490, 516): the [0,0] frequency of both terms
        proj2[:, :, 0, 0] = 0.0
        noise[:, 0, 0] = 0.0
        # QUIRK: IDL row/column transpose, then DC to centre for the merge
        shift = lambda a: np.fft.fftshift(np.swapaxes(a, -1, -2),  # noqa
                                          axes=(-2, -1))
        out["proj2_" + tag] = shift(proj2)
        out["noise_" + tag] = shift(noise)
        out["p_re_" + tag] = shift(p_re)
        out["p_im_" + tag] = shift(p_im)
        out["d0_" + tag] = shift(den)

    # |f|^2 on the (transposed, shifted) grid — |f| is symmetric under both
    out["f2"] = np.fft.fftshift(f * f)
    dc = np.ones((s, s))
    dc[s // 2, s // 2] = 0.0        # original [0, 0] after the fftshift
    out["dc_mask"] = dc
    _STATIC_TRANSFER_CACHE[key] = out
    return out


def _layer_sum(x, cn2):
    """``sum_l cn2[l] * x[l]`` over the two turbulent layers, as
    elementwise adds: exact float32 on every backend, where a dot over
    the layer axis could run at reduced matmul precision."""
    return jnp.sum(cn2[:, None, None, None] * x, axis=0)


def _glao_block_psd(seeing, GL, L0, gs_mask, h, wind_speed,
                    npsflin: int, cfg: GalacsiConfig, zenith=0.0):
    """Correction-zone GLAO residual PSD (ndir, s, s) [rad^2] and r0."""
    dtype = jnp.dtype(cfg.dtype)
    cn2 = jnp.stack([GL, 1.0 - GL]).astype(dtype)
    cn2 = cn2 / jnp.sum(cn2)
    r0ref = seeing_to_r0(seeing, cfg.lambda_ref, zenith).astype(dtype)

    const = _glao_static_transfer(h, wind_speed, npsflin, cfg)
    f2 = jnp.asarray(const["f2"], dtype)
    # von Karman per layer: cst * cn2_l * r0^(-5/3) * (f^2 + L0^-2)^(-11/6)
    # ((cn2^(-3/5) r0)^(-5/3) == cn2 * r0^(-5/3))
    radial = 0.0229 * r0ref ** (-5.0 / 3.0) * \
        (f2 + 1.0 / (L0 * L0)) ** (-11.0 / 6.0)          # (s, s)

    def variant(tag):
        if cfg.lse:
            # LSE: the projector is telemetry-independent — |proj|^2 and
            # the noise term are float64 precomputed constants
            proj2 = jnp.asarray(const["proj2_" + tag], dtype)
            noise = jnp.asarray(const["noise_" + tag], dtype)
            return _layer_sum(proj2 * radial[None, None], cn2) + noise
        # MAP: the prior enters the per-frequency inversion through the
        # telemetry (r0, L0), so the scalar field inv = 1/(D0 + Cphi^-1)
        # is traced; |proj|^2 = |1 - P*inv|^2 with P precomputed
        # (reference psfrec.py:300-324 prior, recons_cn2 = 1, err_R0 = 1)
        d0 = jnp.asarray(const["d0_" + tag], dtype)         # (s, s)
        dc = jnp.asarray(const["dc_mask"], dtype)
        prior_inv = ((f2 + 1.0 / (L0 * L0)) ** (11.0 / 6.0)
                     * r0ref ** (5.0 / 3.0) / 0.0229)
        den = d0 + prior_inv
        inv = jnp.where(den != 0, 1.0 / jnp.where(den == 0, 1.0, den), 0.0)
        inv = inv * dc                  # piston filtered (psfrec.py:305,352)
        re = 1.0 - jnp.asarray(const["p_re_" + tag], dtype) * inv
        im = jnp.asarray(const["p_im_" + tag], dtype) * inv
        proj2 = re * re + im * im                           # (l, ndir, s, s)
        err = _layer_sum(proj2 * radial[None, None], cn2)
        return (err + d0 * inv * inv) * dc

    # the two reference geometries (psfrec.py:86-91); the mask's 4th entry
    # selects between them exactly as in the reference's 3-laser mode
    psd_dir = jnp.where(gs_mask[3] > 0.5, variant("4"), variant("3"))
    return psd_dir, r0ref


#: central-block slice of the image-centred |f| grid, cached per config key
_F_BLOCK_CACHE = {}


def _f_block(cfg: GalacsiConfig):
    key = (cfg.dim, cfg.dpup, cfg.dim_pup)
    if key not in _F_BLOCK_CACHE:
        lo = cfg.dim // 2 - cfg.dim_pup
        s = cfg.dimall
        f = centered_freq_radius(cfg.dim, 2.0 * cfg.dpup)
        _F_BLOCK_CACHE[key] = f[lo:lo + s, lo:lo + s]
    return _F_BLOCK_CACHE[key]


@partial(jax.jit, static_argnames=("h", "wind_speed", "npsflin", "cfg"))
def _simulate_psd_static(seeing, GL, L0, gs_mask, h, wind_speed,
                         npsflin: int, cfg: GalacsiConfig, zenith=0.0):
    dtype = jnp.dtype(cfg.dtype)
    psd_dir, r0ref = _glao_block_psd(seeing, GL, L0, gs_mask, h, wind_speed,
                                     npsflin, cfg, zenith)

    f_full = jnp.asarray(centered_freq_radius(cfg.dim, 2.0 * cfg.dpup), dtype)
    full = fitting_psd(f_full, r0ref, L0, cfg.fc)

    s = cfg.dimall
    lo = cfg.dim // 2 - cfg.dim_pup
    block = jnp.maximum(full[lo:lo + s, lo:lo + s][None], psd_dir)
    ndir = npsflin * npsflin
    out = jnp.broadcast_to(full, (ndir, cfg.dim, cfg.dim))
    out = jax.lax.dynamic_update_slice(out, block, (0, lo, lo))
    return out * (cfg.lambda_ref * 1000.0 / (2 * np.pi)) ** 2


@partial(jax.jit, static_argnames=("h", "wind_speed", "npsflin", "cfg"))
def _simulate_psd_split_static(seeing, GL, L0, gs_mask, h, wind_speed,
                               npsflin: int, cfg: GalacsiConfig, zenith=0.0):
    """Split form of :func:`_simulate_psd_static`: ``(w, delta)``.

    The full-grid PSD decomposes linearly (the structure-function
    transform is linear, see ``otf/psf.py:dphi_base_split``) as

        PSD = sum_k w_k * B_k  +  embed_central(delta)

    where the ``B_k`` are telemetry-independent fitting-PSD basis grids
    (Taylor in ``u = 1/L0^2``, :func:`fitting_expansion_spec`) and
    ``delta = max(PSD_glao - PSD_fit, 0)`` is the (ndir, s, s) correction
    -zone excess (the reference's max-merge, psfrec.py:148-149, minus the
    fitting floor).  Both are in nm^2 (psfrec.py:151 scaling applied).
    """
    from ..core.vonkarman import (fitting_expansion_spec, fitting_psd as
                                  _fit_psd, CST_VK_EXACT)
    dtype = jnp.dtype(cfg.dtype)
    psd_dir, r0ref = _glao_block_psd(seeing, GL, L0, gs_mask, h, wind_speed,
                                     npsflin, cfg, zenith)

    nm2 = (cfg.lambda_ref * 1000.0 / (2 * np.pi)) ** 2
    fit_blk = _fit_psd(jnp.asarray(_f_block(cfg), dtype), r0ref, L0, cfg.fc)
    delta = jnp.maximum(psd_dir - fit_blk[None], 0.0) * nm2

    u0, binoms = fitting_expansion_spec(cfg.dphi_split_l0_min,
                                        cfg.dphi_split_degree)
    u = 1.0 / (L0 * L0)
    du = (u - u0).astype(dtype)
    # du^k via cumprod (jnp.power NaNs on negative base w/ float exponent)
    powers = jnp.concatenate([jnp.ones((1,), dtype),
                              jnp.cumprod(jnp.full(len(binoms) - 1, du,
                                                   dtype))])
    amp = nm2 * CST_VK_EXACT * r0ref ** (-5.0 / 3.0)
    w = amp * jnp.asarray(binoms, dtype) * powers
    return w, delta


def simulate_psd(seeing, GL, L0, gs_mask, h, wind_speed, npsflin: int,
                 cfg: GalacsiConfig, zenith=0.0):
    """Residual-phase PSD cube (ndir, dim, dim), image-centred, nm^2/freq^2.

    JAX equivalent of reference ``simul_psd_wfm`` (psfrec.py:36-151):
    correction-zone GLAO PSD merged (max) with the fitting-error PSD on the
    full grid, scaled to nm^2.  ``gs_mask`` is the float (4,) guide-star
    validity mask replacing the reference's 3-LGS geometry switch (its 4th
    entry selects the 4- vs 3-laser geometry); ``wind_speed`` comes from
    :func:`effective_wind_speed`; ``h`` must be concrete (it becomes part
    of the float64 static transfer functions).  ``zenith`` [deg] only
    rescales the Fried parameter (the line-of-sight altitudes are computed
    but unused in the reference, psfrec.py:109-112).  ``cfg.lse=False``
    uses the MAP prior (reference psfrec.py:300-324; the shipped reference
    pipeline hardcodes LSE at psfrec.py:96 but its MAP path is callable).
    """
    h_t = tuple(float(x) for x in np.asarray(h).ravel())
    return _simulate_psd_static(seeing, GL, L0, gs_mask, h_t,
                                float(wind_speed), npsflin, cfg,
                                zenith=zenith)


def simulate_psd_split(seeing, GL, L0, gs_mask, h, wind_speed, npsflin: int,
                       cfg: GalacsiConfig, zenith=0.0):
    """Split-form residual PSD: ``(w, delta)`` such that

        simulate_psd(...) == sum_k w_k * B_k(cfg) + embed_central(delta)

    with ``B_k`` the fitting-PSD Taylor basis (telemetry-independent; see
    ``otf/psf.py:fitting_dphi_basis`` for its structure-function
    transforms).  Exact to the certified expansion error (<=1e-7 relative
    on the fitting PSD for ``L0 >= cfg.dphi_split_l0_min``); callers must
    check the L0 range on the host (``parallel/batch.py`` does) and fall
    back to :func:`simulate_psd` outside it.
    """
    h_t = tuple(float(x) for x in np.asarray(h).ravel())
    return _simulate_psd_split_static(seeing, GL, L0, gs_mask, h_t,
                                      float(wind_speed), npsflin, cfg,
                                      zenith=zenith)
