"""PSD -> structure function -> OTF -> PSF chain (JAX, batched).

Batched JAX reformulation of reference ``psd_to_psf`` (psfrec.py:689-807) and
``psf_muse`` (644-686).  Three structural optimisations over the reference,
each provably exact (validated against the float64 oracle):

1. **lambda-factored structure function**: the phase covariance is
   ``ifft2(fftshift(psd)) * convnm(lbda)^2`` — the FFT does not depend on
   the wavelength, so one base transform per direction replaces the
   reference's per-(lambda, direction) FFT (psfrec.py:718).

2. **hoisted pupil OTF**: the diffraction OTF (pupil autocorrelation,
   psfrec.py:783-790) is wavelength-independent; the reference recomputes it
   per lambda.

3. **fused direction average**: each direction's PSF is its OTF's inverse
   FFT normalised by the OTF's DC coefficient (``sum(ifft2(X)) = X[0,0]``),
   so the *average over directions of normalised PSFs* is the inverse FFT of
   the average of normalised OTFs — one inverse transform per wavelength
   regardless of the number of directions (psfrec.py:667-674 does
   ndir FFTs).

The lambda-dependent crop-and-regrid (psfrec.py:663-683) is fused into a
single bilinear gather from the full-resolution PSF with traced (dynamic)
coordinates, keeping every shape static under ``jit``.

Only the live branch of the reference is implemented: ``samp == 2 ==
dim/npup`` and ``FoV == FoVnum``.  The reference's oversampling /
extrapolation branches are unreachable in its shipped pipeline and crash if
forced (psfrec.py:738 passes a shape tuple to ``np.zeros`` incorrectly;
psfrec.py:640 raises ``NotImplementedError`` for cubic interpolation); we
reject them explicitly.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import GalacsiConfig
from ..core.grids import pupil_mask
from ..utils.log import get_logger

logger = get_logger("otf")


_PUPIL_OTF_CACHE = {}


def pupil_otf(cfg: GalacsiConfig):
    """Diffraction-limited OTF: normalised pupil autocorrelation (dim, dim).

    Image-centred, real.  Matches reference psfrec.py:783-790 (computed
    there per wavelength; hoisted here — it is wavelength-independent).
    A pure function of the static configuration, so it is computed once on
    the host in float64 and becomes a program constant (also keeping the
    device path FFT-free).
    """
    key = (cfg.dim, cfg.npup, cfg.occ, cfg.dtype)
    if key not in _PUPIL_OTF_CACHE:
        c = (cfg.npup - 1) / 2.0
        y = np.arange(cfg.npup)[:, None] - c
        x = np.arange(cfg.npup)[None, :] - c
        rho = np.hypot(y, x) / (cfg.dim / 4.0)
        pup = ((rho < 1.0) & (rho >= cfg.occ)).astype(np.float64)
        tab = np.zeros((cfg.dim, cfg.dim), np.complex128)
        tab[:cfg.npup, :cfg.npup] = pup
        amp = np.abs(np.fft.ifft2(tab)) ** 2
        otf = np.abs(np.fft.fft2(amp)) / pup.sum()
        _PUPIL_OTF_CACHE[key] = np.fft.fftshift(otf).astype(cfg.dtype)
    return jnp.asarray(_PUPIL_OTF_CACHE[key])


def _centered_idft_np(dim: int, cols=None):
    """Real/imag matrices of the shifted inverse DFT, centred in and out.

    For a real image-centred array X, ``fftshift(ifft2(fftshift(X))).real
    = C X C^T - S X S^T`` where ``C[p, g] = (-1)^(p - N/2 mod N) *
    cos(2 pi ((p - N/2) mod N) g / N) / N`` and similarly for S — the
    (-1)^k factor absorbs the inner fftshift and the row reindexing the
    outer one.  Phases are reduced mod N in int32 for float32 accuracy.

    ``cols=(lo, n)`` restricts to input columns ``lo:lo+n`` — for inputs
    supported on a central block, the transform only needs those columns
    (the block-term optimisation of :func:`dphi_base_split`).
    """
    k = np.mod(np.arange(dim) - dim // 2, dim)
    g = np.arange(dim) if cols is None else np.arange(cols[0],
                                                      cols[0] + cols[1])
    ph = np.mod(np.outer(k, g), dim).astype(np.float64)
    ang = ph * (2.0 * np.pi / dim)
    sign = np.where(k % 2 == 0, 1.0, -1.0)[:, None]
    c = sign * np.cos(ang) / dim
    s = sign * np.sin(ang) / dim
    return c, s


def _centered_idft_matrices(dim: int, dtype, cols=None):
    c, s = _centered_idft_np(dim, cols)
    return jnp.asarray(c, dtype), jnp.asarray(s, dtype)


def _mm(cfg: GalacsiConfig):
    """Matmul at the configured precision (``cfg.matmul_precision``)."""
    return partial(jnp.matmul,
                   precision=jax.lax.Precision(cfg.matmul_precision))


def _fold_weights(dim: int, S: int, ncw: int, dtype):
    """Column weights of the point-symmetry fold (``cfg.use_sym_fold``).

    Every OTF-side array here is the transform of a real field (PSD,
    structure function, pupil autocorrelation), hence point-symmetric:
    ``G[i, j] = G[(N-i) % N, (N-j) % N]``.  The zoom/dphi contractions'
    per-column terms are then equal in mirrored pairs ``(j, N-j)`` —
    proven from the parity of the DFT row matrices (cos rows even, sin
    rows odd under ``g -> (N-g) % N``) — so summing columns up to N/2
    with mirror weight 2 (columns 0 and N/2 are self-paired; anything
    beyond N/2 is dead tile padding) reproduces the full sum exactly up
    to float-noise asymmetry of the inputs.

    Weights for the ``ncw`` computed columns, global ``[c-S, c+128)``
    with ``c = dim//2`` (``cfg.otf_window``): local ``[0, S)`` -> 2,
    ``S`` (the self-paired centre) -> 1, the tile-pad tail -> 0; when
    the window reaches the grid edge, global column 0 is the self-paired
    Nyquist column -> 1.  Columns outside the window are dropped: under
    ``otf_support`` they hold only |G| below the support threshold.
    """
    v = np.zeros(ncw)
    v[:S] = 2.0
    v[S] = 1.0
    if dim // 2 - S == 0:
        v[0] = 1.0
    return jnp.asarray(v, dtype)


def dphi_base(psd, cfg: GalacsiConfig):
    """Wavelength-free structure function (ndir, dim, dim), image-centred
    ((ndir, dim, cfg.fold_ncols) under the point-symmetry fold — the zoom
    path reconstructs the mirrored columns' contribution exactly).

    ``Dphi(lbda) = convnm(lbda)^2 * dphi_base`` where ``convnm = 2 pi /
    lbda_nm``.  Follows reference psfrec.py:716-722 with the ``convnm``
    factor pulled out of the transform.  With ``cfg.use_fft`` unset, the
    (wavelength-free, per-row) transform runs as two dense matmuls
    instead of an FFT — exact to rounding.
    """
    dim = cfg.dim
    sampnum = dim / cfg.npup
    L = cfg.dpup * sampnum
    scale = dim * dim / (L * L)
    win = cfg.otf_window
    if cfg.use_fft:
        cdtype = jnp.dtype(cfg.cdtype)
        bg = jnp.fft.ifft2(
            jnp.fft.fftshift(psd, axes=(-2, -1)).astype(cdtype)) * scale
        d = 2.0 * (bg[..., :1, :1].real - bg.real)
        d = jnp.fft.fftshift(d, axes=(-2, -1)).astype(cfg.dtype)
        if win is None:
            return d
        r_lo, S = win
        return d[..., r_lo:r_lo + 2 * S, r_lo:dim // 2 + 128]

    dtype = jnp.dtype(cfg.dtype)
    c, s = _centered_idft_matrices(dim, dtype)
    x = psd.astype(dtype)
    mm = _mm(cfg)
    if win is None:
        # centred Re(bg): C X C^T - S X S^T, batched over the directions
        re_bg = mm(mm(c, x), c.T) - mm(mm(s, x), s.T)
    else:
        # point-symmetry fold (see _fold_weights).  The raw GLAO PSD is
        # NOT f -> -f symmetric (the temporal transfer functions depend
        # on f.v, and the wind direction breaks the parity) — but the
        # real part of its inverse transform equals the transform of the
        # symmetrised PSD, so symmetrising first (elementwise, O(N^2))
        # is exact; (C X_sym) is then even / (S X_sym) odd in the column
        # index and the contraction folds onto columns 0..N/2.  Output
        # restricted to the consumed window rows/cols: >=2.5x fewer
        # matmul FLOPs at dim=1280, more under otf_support
        r_lo, S = win
        r_hi, col_hi = r_lo + 2 * S, dim // 2 + 128
        nh = dim // 2 + 1
        vh = np.full(nh, 2.0)
        vh[0] = vh[-1] = 1.0
        vh = jnp.asarray(vh, dtype)
        xs = 0.5 * (x + jnp.roll(x[..., ::-1, ::-1], (1, 1),
                                 axis=(-2, -1)))
        xh = xs[..., :nh]
        re_bg = (mm(mm(c[r_lo:r_hi], xh) * vh, c[r_lo:col_hi, :nh].T)
                 - mm(mm(s[r_lo:r_hi], xh) * vh, s[r_lo:col_hi, :nh].T))
    bg00 = jnp.sum(x, axis=(-2, -1))[..., None, None] / (L * L)
    return (2.0 * (bg00 - re_bg * scale)).astype(dtype)


_DPHI_BASIS_CACHE = {}
# disk-format version of the host-cached basis tables (bump on any
# change to the formulas below; the full parameter key rides alongside)
_HOST_CACHE_FMT = 1


def _fitting_dphi_basis_np(cfg: GalacsiConfig):
    """Full-grid numpy basis in ``cfg.dtype`` (host cache fill only —
    no device transfer; see :func:`fitting_dphi_basis`)."""
    fitting_dphi_basis(cfg, _fill_only=True)
    key = (cfg.dim, cfg.npup, cfg.dpup, cfg.fc, cfg.dphi_split_degree,
           cfg.dphi_split_l0_min, cfg.dtype)
    return _DPHI_BASIS_CACHE[key]


def fitting_dphi_basis(cfg: GalacsiConfig, _fill_only=False):
    """Structure-function transforms of the fitting-PSD Taylor basis.

    The PSD decomposes as ``sum_k w_k B_k + embed(delta)`` (see
    ``psd/model.py:simulate_psd_split``); since the structure-function
    transform is linear, ``dphi_base(PSD) = sum_k w_k T_k +
    block_transform(delta)`` with ``T_k = dphi_base(B_k)`` precomputed
    here ONCE per configuration — in float64 on the host, becoming
    program constants.  This removes the reference's dominant per-row
    cost (the full-grid transform of the fitting PSD, psfrec.py:144 +
    716-722): the per-row device work drops from a (dim, dim) transform
    to a (dimall, dimall)-supported block transform (~16x fewer FLOPs at
    the production shape).

    Returns a (degree+1, dim, dim) array in the compute dtype.
    """
    from ..core.grids import centered_freq_radius
    from ..core.vonkarman import (fitting_expansion_spec,
                                  fitting_expansion_max_rel_error)
    key = (cfg.dim, cfg.npup, cfg.dpup, cfg.fc, cfg.dphi_split_degree,
           cfg.dphi_split_l0_min, cfg.dtype)
    if key not in _DPHI_BASIS_CACHE:
        err = fitting_expansion_max_rel_error(
            cfg.dphi_split_l0_min, cfg.dphi_split_degree, cfg.fc)
        if err > 1e-7:
            raise ValueError(
                f"fitting-PSD expansion error {err:.2e} exceeds the 1e-7 "
                f"budget for L0 >= {cfg.dphi_split_l0_min}; raise "
                f"dphi_split_degree or dphi_split_l0_min")
        from ..utils.compile_cache import (host_cache_load,
                                           host_cache_store)
        dkey = (_HOST_CACHE_FMT,) + key
        hit = host_cache_load("dphi_basis", dkey)
        if hit is not None:
            _DPHI_BASIS_CACHE[key] = hit["basis"]
        else:
            dim = cfg.dim
            sampnum = dim / cfg.npup
            L = cfg.dpup * sampnum
            scale = dim * dim / (L * L)
            f = centered_freq_radius(dim, 2.0 * cfg.dpup)
            mask = (f >= cfg.fc).astype(np.float64)
            u0, binoms = fitting_expansion_spec(cfg.dphi_split_l0_min,
                                                cfg.dphi_split_degree)
            f2u = f * f + u0
            ts = []
            for k in range(len(binoms)):
                b = mask * f2u ** (-11.0 / 6.0 - k)
                bg = np.fft.ifft2(np.fft.fftshift(b)).real * scale
                t = 2.0 * (bg[0, 0] - bg)
                ts.append(np.fft.fftshift(t))
            _DPHI_BASIS_CACHE[key] = np.stack(ts).astype(cfg.dtype)
            host_cache_store("dphi_basis", dkey,
                             {"basis": _DPHI_BASIS_CACHE[key]})
    if _fill_only:
        return None
    arr = _DPHI_BASIS_CACHE[key]
    win = cfg.otf_window
    if win is None:
        return jnp.asarray(arr)
    r_lo, S = win
    return jnp.asarray(arr[..., r_lo:r_lo + 2 * S,
                           r_lo:cfg.dim // 2 + 128])


_BASIS_RING_CACHE = {}


def fitting_dphi_ring_envelopes(cfg: GalacsiConfig):
    """Ring-wise min/max of the fitting structure-function basis (host).

    For each basis transform ``T_k`` (see :func:`fitting_dphi_basis`) and
    each inf-norm radius ``r = max(|i-c|, |j-c|)`` in ``0..dim/2``,
    returns float64 ``(tmin, tmax)`` of shape (degree+1, dim/2+1): the
    minimum/maximum of ``T_k`` over the ring.  Used by the host-side OTF
    support estimator (``parallel/batch.py:estimate_otf_support``) to
    lower-bound ``D_fit = sum_k w_k T_k`` over each ring regardless of
    the signs of the telemetry-dependent weights.
    """
    key = (cfg.dim, cfg.npup, cfg.dpup, cfg.fc, cfg.dphi_split_degree,
           cfg.dphi_split_l0_min)
    if key not in _BASIS_RING_CACHE:
        from ..utils.compile_cache import (host_cache_load,
                                           host_cache_store)
        dkey = (_HOST_CACHE_FMT,) + key
        hit = host_cache_load("dphi_rings", dkey)
        if hit is not None:
            _BASIS_RING_CACHE[key] = (hit["tmin"], hit["tmax"])
            return _BASIS_RING_CACHE[key]
        arr = _fitting_dphi_basis_np(cfg.with_(dtype="float64"))
        c = cfg.dim // 2
        ii = np.abs(np.arange(cfg.dim) - c)
        ring = np.maximum(ii[:, None], ii[None, :]).ravel()
        flat = arr.reshape(arr.shape[0], -1)
        # segment reductions via sort + reduceat (ufunc.at is ~100x
        # slower at these sizes); every ring 0..c is non-empty
        order = np.argsort(ring, kind="stable")
        bounds = np.searchsorted(ring[order], np.arange(c + 1))
        tmin = np.stack([np.minimum.reduceat(flat[k][order], bounds)
                         for k in range(arr.shape[0])])
        tmax = np.stack([np.maximum.reduceat(flat[k][order], bounds)
                         for k in range(arr.shape[0])])
        _BASIS_RING_CACHE[key] = (tmin, tmax)
        host_cache_store("dphi_rings", dkey, {"tmin": tmin, "tmax": tmax})
    return _BASIS_RING_CACHE[key]


def dphi_base_split(w, delta, cfg: GalacsiConfig):
    """Wavelength-free structure function from the split PSD form.

    ``w``: (degree+1,) traced fitting-basis weights; ``delta``: (ndir,
    dimall, dimall) correction-zone excess [nm^2].  Exactly equivalent
    (to the certified <=1e-7 expansion error) to
    ``dphi_base(simulate_psd(...))`` — the full-grid transform is folded
    into precomputed constants and only the centrally-supported block
    term is transformed on device, using just the relevant columns of
    the inverse-DFT matrices.
    """
    dtype = jnp.dtype(cfg.dtype)
    dim = cfg.dim
    sampnum = dim / cfg.npup
    L = cfg.dpup * sampnum
    scale = dim * dim / (L * L)

    T = fitting_dphi_basis(cfg)                 # (K+1, dim, dim or ncols)
    shared = jnp.sum(w.astype(dtype)[:, None, None] * T, axis=0)

    lo = dim // 2 - cfg.dim_pup
    s = delta.shape[-1]
    mm = _mm(cfg)
    x = delta.astype(dtype)                              # (ndir, s, s)
    bg00 = jnp.sum(x, axis=(-2, -1))[..., None, None] / (L * L)
    win = cfg.otf_window
    if win is None:
        c_blk, s_blk = _centered_idft_matrices(dim, dtype, cols=(lo, s))
        re_blk = (mm(mm(c_blk, x), c_blk.T)
                  - mm(mm(s_blk, x), s_blk.T))           # (ndir, dim, dim)
    else:
        # fold (see dphi_base): symmetrise the correction block first —
        # delta is NOT f -> -f symmetric (temporal terms), and its global
        # mirror spans [lo, lo + s], one column/row wider than the block,
        # so pad by one before folding; then emit only the window
        # rows/columns the zoom path reads (the Re-transform of the
        # unfolded path symmetrises implicitly, so this is exact)
        r_lo, S = win
        r_hi, col_hi = r_lo + 2 * S, dim // 2 + 128
        xp = jnp.pad(x, ((0, 0), (0, 1), (0, 1)))
        xs = 0.5 * (xp + xp[..., ::-1, ::-1])            # (ndir, s+1, s+1)
        c_blk, s_blk = _centered_idft_matrices(dim, dtype,
                                               cols=(lo, s + 1))
        re_blk = (mm(mm(c_blk[r_lo:r_hi], xs), c_blk[r_lo:col_hi].T)
                  - mm(mm(s_blk[r_lo:r_hi], xs), s_blk[r_lo:col_hi].T))
    return (shared[None] + 2.0 * (bg00 - re_blk * scale)).astype(dtype)


def lambda_crop_size(lbda_nm, cfg: GalacsiConfig):
    """Even crop size ``npixc(lbda)`` in px (reference psfrec.py:663-664).

    QUIRK: ``np.round`` is round-half-to-even (banker's rounding); the grid
    of MUSE wavelengths lands on .5 boundaries for some ``nl``.  Parity
    therefore requires the quotient AND the rounding in float64 — a
    float32 quotient can land on the wrong side of an exact-in-f64 .5
    boundary, shifting ``npixc`` by 2 and every pixel of that plane's
    regrid.  Concrete inputs compute on the host in float64; traced
    inputs (inside jit, usually float32) keep the in-graph form —
    the production entry points precompute ``npixc`` on the host and
    pass it through (``parallel/batch.py::_plan_batch`` ->
    ``psf_cube_from_base(npixc=...)``).
    """
    scale = cfg.dimpsf * cfg.pixscale * 2.0 * cfg.dpup * 4.85 * 1000.0
    if not isinstance(lbda_nm, jax.core.Tracer):
        # stay on the HOST (numpy): wrapping in jnp here pushes to the
        # device and the planner's np.asarray pulls straight back
        raw = scale / np.asarray(lbda_nm, np.float64)
        return (np.round(raw / 2.0) * 2.0).astype(np.int32)
    raw = scale / lbda_nm
    return (jnp.round(raw / 2.0) * 2.0).astype(jnp.int32)


def _bilinear_regrid(img, start, step, nout: int):
    """out[i,j] = bilinear(img, (start + i*step, start + j*step)).

    ``start``/``step`` may be traced scalars; shapes are static.  Replaces
    the reference's crop + ``scipy.interpn`` regrid (psfrec.py:672-683) with
    one gather, exactly (the reference's in/out transposes cancel).
    """
    pos = start + jnp.arange(nout, dtype=img.dtype) * step
    i0 = jnp.floor(pos)
    t = (pos - i0).astype(img.dtype)
    i0 = jnp.clip(i0.astype(jnp.int32), 0, img.shape[0] - 2)
    rows = (jnp.take(img, i0, axis=0) * (1.0 - t)[:, None]
            + jnp.take(img, i0 + 1, axis=0) * t[:, None])
    return (jnp.take(rows, i0, axis=1) * (1.0 - t)[None, :]
            + jnp.take(rows, i0 + 1, axis=1) * t[None, :])


def _psf_plane_fft(mean_otf_centered, cfg):
    """Full-resolution PSF plane from the direction-averaged OTF (centred)."""
    sys_otf = jnp.fft.fftshift(mean_otf_centered).astype(cfg.cdtype)
    psf = jnp.fft.ifft2(sys_otf).real.astype(cfg.dtype)
    return jnp.fft.fftshift(psf)


def _zoom_dft_matrices(idx, dim: int, dtype):
    """Real/imag inverse-DFT row matrices for a set of PSF pixel indices.

    For centred PSF index p and centred OTF index g, the double-fftshifted
    inverse FFT gives  psf[p, q] = Re sum_g G[g1, g2] A[p, g1] A[q, g2]
    with A[p, g] = exp(2i pi (p - N/2)(g + N/2) / N) / N.  With G real this
    is two real matmuls:  P = Ar G Ar^T - Ai G Ai^T  — dense matmul work
    instead of a full N^2 inverse FFT per wavelength, exact to rounding.

    The phase is reduced mod N in int32 before the trig for full float32
    accuracy.  ``idx`` may be traced (the crop grid is wavelength-dependent).
    """
    kk = (idx.astype(jnp.int32) - dim // 2)[:, None]            # (npts, 1)
    gg = (jnp.arange(dim, dtype=jnp.int32) + dim // 2)[None, :]  # (1, N)
    ph = jnp.mod(kk * gg, dim).astype(dtype)
    ang = ph * (2.0 * np.pi / dim)
    return jnp.cos(ang) / dim, jnp.sin(ang) / dim


def _combine_bilinear(p, t, nout: int):
    """(2*nout, 2*nout) PSF node values -> (nout, nout) bilinear samples."""
    w0 = (1.0 - t)
    return (w0[:, None] * w0[None, :] * p[:nout, :nout]
            + w0[:, None] * t[None, :] * p[:nout, nout:]
            + t[:, None] * w0[None, :] * p[nout:, :nout]
            + t[:, None] * t[None, :] * p[nout:, nout:])


def _psf_samples_zoom(mean_otf_centered, i0, t, nout: int, cfg):
    """PSF bilinear samples out[i,j] = bilinear(psf, (pos_i, pos_j)) with
    pos = i0 + t, computed by zoom DFT without materialising the PSF.

    ``mean_otf_centered``: (N, N) real; ``i0``: (nout,) int32 floor indices;
    ``t``: (nout,) fractional parts.  Exactly equivalent (to rounding) to
    the FFT path followed by :func:`_bilinear_regrid`, including the
    clip-at-zero before interpolation.
    """
    dtype = jnp.dtype(cfg.dtype)
    dim = cfg.dim
    idx = jnp.concatenate([i0, i0 + 1])                 # (2*nout,)
    ar, ai = _zoom_dft_matrices(idx, dim, dtype)
    g = mean_otf_centered.astype(dtype)
    # never 'default' precision here: a float32 matmul at default
    # precision may run in TF32 on a GPU (10-bit mantissa), which costs
    # ~1e-5 absolute on the PSF — the whole budget
    mm = _mm(cfg)
    win = cfg.otf_window
    if win is not None:
        # windowed OTF (rows [r_lo, r_lo+2S), cols [r_lo, c+128)):
        # mirrored column pairs contribute equally (weight 2)
        r_lo, S = win
        r_hi, col_hi = r_lo + 2 * S, dim // 2 + 128
        u_r = mm(ar[:, r_lo:r_hi], g)                   # (2*nout, ncw)
        u_i = mm(ai[:, r_lo:r_hi], g)
        v = _fold_weights(dim, S, g.shape[-1], dtype)
        p = (mm(u_r * v, ar[:, r_lo:col_hi].T)
             - mm(u_i * v, ai[:, r_lo:col_hi].T))
    else:
        u_r = mm(ar, g)                                 # (2*nout, N)
        u_i = mm(ai, g)
        p = mm(u_r, ar.T) - mm(u_i, ai.T)               # (2*nout, 2*nout)
    return _combine_bilinear(jnp.maximum(p, 0.0), t, nout)


def psd_to_psf(psd, pup, D, lbda, phase_static=None, samp=None, FoV=None,
               return_all=False, dtype=jnp.float64):
    """General long-exposure PSF from one residual PSD [nm^2] and a pupil.

    Standalone equivalent of the reference ``psd_to_psf``
    (psfrec.py:689-807) for single transforms (the batched pipeline uses
    :func:`psf_cube`): supports sub-Nyquist output sampling (central crop
    of the structure function), an optional static pupil phase [nm], and
    ``return_all`` -> (psf, sampout, FoV).  ``lbda`` in metres.

    The reference's oversampling branches are unreachable in its shipped
    pipeline and *crash* when forced (``np.zeros(dimnum, dimnum)`` at
    psfrec.py:738 is a TypeError; cubic ``interpolate`` raises
    NotImplementedError at psfrec.py:640); they are rejected explicitly
    here with the matching exception.
    """
    psd = jnp.asarray(psd, dtype)
    pup = jnp.asarray(pup, dtype)
    if psd.dtype != jnp.dtype(dtype):
        # x64 disabled (the default): jnp silently resolved the
        # requested float64 to float32.  Follow the resolved precision —
        # complex128 here would only downcast again — but say so, since
        # a library user calling this standalone expects f64-grade
        # results (the batched pipeline passes float32 explicitly)
        logger.warning(
            "psd_to_psf: requested dtype %s resolved to %s (jax x64 is "
            "disabled); results carry float32 accuracy (~1e-5)",
            jnp.dtype(dtype).name, psd.dtype.name)
    cdtype = (jnp.complex128 if psd.dtype == jnp.float64 else
              jnp.complex64)
    dim = psd.shape[0]
    npup = pup.shape[0]
    sampnum = dim / npup
    L = D * sampnum
    if dim < 2 * npup:
        logger.info("the PSD horizon must be at least two time larger than "
                    "the pupil diameter")

    convnm = 2 * np.pi / (lbda * 1e9)
    bg = jnp.fft.ifft2(jnp.fft.fftshift(psd * convnm ** 2).astype(cdtype))
    bg = bg * (psd.size / L ** 2)
    dphi = jnp.fft.fftshift(2.0 * (bg[0, 0].real - bg.real))

    sampin = samp if samp is not None else sampnum
    if sampin < 2:
        logger.info("PSF should be at least nyquist sampled")
    dimnum = int(np.fix(dim * (sampin / sampnum) / 2)) * 2
    sampout = dimnum / npup
    if sampin <= sampnum:
        ns = int(sampout * npup / 2)
        lo = dim // 2 - ns
        dphi2 = dphi[lo:lo + 2 * ns, lo:lo + 2 * ns]
    else:
        raise NotImplementedError(
            "samp > dim/npup requires structure-function extrapolation, "
            "which crashes in the reference (psfrec.py:738-744)")

    fov_num = (lbda / (sampnum * D)) * dim / 4.85e-6
    if FoV is not None and not np.allclose(float(FoV), fov_num):
        raise NotImplementedError(
            "FoV oversampling needs cubic interpolation, unimplemented in "
            "the reference (psfrec.py:640)")
    dimover, npupover = dimnum, npup

    tab = jnp.zeros((dimover, dimover), cdtype)
    pup_sum = jnp.sum(pup)        # normaliser uses the unmodified pupil
    if phase_static is not None:
        pup = pup * jnp.exp(1j * jnp.asarray(phase_static, dtype)
                            * 2 * np.pi / lbda)
    tab = tab.at[:npupover, :npupover].set(pup.astype(cdtype))
    dl_otf = jnp.fft.fftshift(
        jnp.abs(jnp.fft.fft2(jnp.abs(jnp.fft.ifft2(tab)) ** 2)) / pup_sum)

    sys_otf = jnp.fft.fftshift(jnp.exp(-dphi2 / 2.0) * dl_otf)
    psf = jnp.fft.fftshift(jnp.fft.ifft2(sys_otf.astype(cdtype)).real)
    psf = psf / jnp.sum(psf)
    if return_all:
        return psf, sampout, fov_num * dimover / dim
    return psf


def psf_cube(psd, lbda_nm, cfg: GalacsiConfig):
    """PSF cube (nl, dimpsf, dimpsf) at the MUSE sampling from the PSD cube.

    ``psd``: (ndir, dim, dim) image-centred residual PSD [nm^2/freq^2]
    (or (dim, dim) for a single direction).
    ``lbda_nm``: (nl,) wavelengths [nm].  Host wrapper: concrete
    wavelengths get their crop sizes decided in float64 BEFORE the jit
    boundary (lambda_crop_size's .5-boundary QUIRK), then the jitted
    body runs.
    """
    npixc = (None if isinstance(lbda_nm, jax.core.Tracer)
             else lambda_crop_size(lbda_nm, cfg))
    return _psf_cube_jit(psd, lbda_nm, npixc, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _psf_cube_jit(psd, lbda_nm, npixc, cfg: GalacsiConfig):
    if psd.ndim == 2:
        psd = psd[None]
    base = dphi_base(psd.astype(cfg.dtype), cfg)    # (ndir, dim, dim)
    return psf_cube_from_base(base, lbda_nm, cfg, npixc=npixc)


def psf_cube_from_base(base, lbda_nm, cfg: GalacsiConfig, npixc=None):
    """Host wrapper over the jitted body: concrete wavelengths compute
    ``npixc`` in float64 on the host before tracing (the in-graph f32
    quotient can round .5-boundary crops the other way — see
    :func:`lambda_crop_size`); traced callers pass a precomputed
    ``npixc`` or accept the f32 fallback.  Full contract in
    :func:`_psf_cube_from_base_jit`."""
    if npixc is None and not isinstance(lbda_nm, jax.core.Tracer):
        npixc = lambda_crop_size(lbda_nm, cfg)
    return _psf_cube_from_base_jit(base, lbda_nm, npixc, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _psf_cube_from_base_jit(base, lbda_nm, npixc, cfg: GalacsiConfig):
    """PSF cube from the wavelength-free structure function ``base``
    (from :func:`dphi_base` or :func:`dphi_base_split` under the SAME
    config).  Its shape is the config's fold/support window: ``(ndir,
    2*S, S + 128)`` with ``S = cfg.otf_window[1]`` — rows ``[c-S, c+S)``
    and columns ``[c-S, c+128)`` of the full grid (the point-symmetry
    fold keeps only 128 columns past the centre ``c = dim//2``) — or
    ``(ndir, dim, dim)`` when ``cfg.otf_window is None``; a mismatch
    raises ``ValueError``.

    ``npixc``: optional precomputed per-wavelength crop sizes (int32,
    same length as ``lbda_nm``).  Pass the host-side float64 result of
    :func:`lambda_crop_size` when ``lbda_nm`` is traced — the in-graph
    f32 fallback can round a .5-boundary crop the other way (see the
    QUIRK note there).
    """
    if npixc is None:
        npixc = lambda_crop_size(lbda_nm, cfg)      # (nl,) int32
    return _psf_cube_from_base_body(base, lbda_nm, npixc, cfg)


def _blue_split_cfgs(cfg: GalacsiConfig, nl: int):
    """Validate ``cfg.otf_blue`` and return ``(nb, cfg_blue, cfg_red)``.

    ``cfg_blue`` is the SAME pipeline config re-rooted on the smaller
    centred window (``otf_support=S_blue``) — every downstream stage
    (DFT-row slicing, fold weights, pupil-OTF slice) then sizes itself
    off that window through the ordinary code paths.  ``cfg_red`` is
    the bucket config with the split cleared.
    """
    nb, Sb = cfg.otf_blue
    nb, Sb = int(nb), int(Sb)
    win = cfg.otf_window
    if win is None:
        raise ValueError("otf_blue requires the fold/window machinery "
                         "(cfg.otf_window is None)")
    S = win[1]
    if Sb % 128 != 0 or not 0 < Sb < S:
        raise ValueError(
            f"otf_blue window {Sb} must be a positive multiple of 128 "
            f"smaller than the bucket window {S}")
    if not 0 < nb < nl:
        raise ValueError(
            f"otf_blue segment length {nb} must satisfy 0 < nb < nl={nl}")
    cfg_red = cfg.with_(otf_blue=None)
    cfg_blue = cfg_red.with_(otf_support=Sb)
    return nb, cfg_blue, cfg_red


def _wavelength_chunk(cfg: GalacsiConfig, nl: int) -> int:
    """Wavelengths per OTF step: ``cfg.lambda_chunk`` (clamped to ``nl``)
    on an accelerator, 1 on the CPU backend, where a batched step has no
    parallel gain on one host core and only adds memory."""
    if jax.default_backend() == "cpu":
        return 1
    return max(1, min(cfg.lambda_chunk, nl))


def _psf_cube_from_base_body(base, lbda_nm, npixc, cfg: GalacsiConfig):
    if cfg.otf_blue is not None:
        # blue-segment window split (cfg.otf_blue = (nb, S_blue)): the
        # damping exponent scales as (2pi/lambda)^2, so the bluest nb
        # wavelengths run on the smaller centred sub-window S_blue —
        # a static slice of the SAME wavelength-free structure function
        # — through this very body re-rooted on that window; admission
        # is certified by the batch planner's host model and backstopped
        # by the device window guard (parallel/batch.py:_window_guard).
        nb, cfg_blue, cfg_red = _blue_split_cfgs(cfg, int(lbda_nm.shape[0]))
        S, Sb = cfg.otf_window[1], cfg_blue.otf_window[1]
        lo = S - Sb
        out_b = _psf_cube_from_base_body(
            base[..., lo:S + Sb, lo:], lbda_nm[:nb], npixc[:nb], cfg_blue)
        out_r = _psf_cube_from_base_body(
            base, lbda_nm[nb:], npixc[nb:], cfg_red)
        return jnp.concatenate([out_b, out_r], axis=0)

    dtype = jnp.dtype(cfg.dtype)
    dim = cfg.dim
    dl = pupil_otf(cfg)                             # (dim, dim)
    if npixc is None:
        npixc = lambda_crop_size(lbda_nm, cfg)      # (nl,) int32

    win = cfg.otf_window
    expect = (dim, dim) if win is None else (2 * win[1], win[1] + 128)
    if base.shape[-2:] != expect:
        raise ValueError(
            f"structure-function block {base.shape[-2:]} does not match "
            f"the config's fold/support window {expect}; produce `base` "
            "with dphi_base/dphi_base_split under the same config")
    if not cfg.use_fft and not cfg.use_zoom_dft:
        raise ValueError("the FFT-free mode (use_fft=False) requires the "
                         "zoom-DFT resampling path (use_zoom_dft=True)")

    def one_lambda(args):
        lb, npix = args
        convnm2 = (2.0 * np.pi / lb) ** 2
        start = (dim // 2 - npix // 2).astype(dtype)
        step = npix.astype(dtype) / cfg.dimpsf
        pos = start + jnp.arange(cfg.dimpsf, dtype=dtype) * step
        i0f = jnp.floor(pos)
        t = (pos - i0f).astype(dtype)
        i0 = jnp.clip(i0f.astype(jnp.int32), 0, dim - 2)

        ao = jnp.exp(-0.5 * convnm2 * base)
        if win is not None:
            r_lo = win[0]
            dlw = dl[r_lo:r_lo + base.shape[-2],
                     r_lo:r_lo + base.shape[-1]]
            cc = dim // 2 - r_lo                    # local centre index
        else:
            dlw, cc = dl, dim // 2
        prod = ao * dlw[None]                       # (ndir, rows, cols)
        norm = prod[:, cc, cc]                      # per-direction DC
        mean_otf = jnp.mean(prod / norm[:, None, None], axis=0)
        if cfg.use_zoom_dft:
            out = _psf_samples_zoom(mean_otf, i0, t, cfg.dimpsf, cfg)
        else:
            psf = _psf_plane_fft(mean_otf, cfg)
            psf = jnp.maximum(psf, 0.0)
            out = _bilinear_regrid(psf, start, step, cfg.dimpsf)
        return out / jnp.sum(out)

    nl = lbda_nm.shape[0]
    k = _wavelength_chunk(cfg, nl)
    if k == 1:
        return jax.lax.map(one_lambda, (lbda_nm.astype(dtype), npixc))

    # chunked wavelengths: process K lambdas per step — a serial
    # per-lambda scan leaves the device underused at production sizes
    pad = (-nl) % k
    lb = jnp.concatenate([lbda_nm.astype(dtype),
                          jnp.broadcast_to(lbda_nm[-1].astype(dtype), (pad,))])
    npx = jnp.concatenate([npixc, jnp.broadcast_to(npixc[-1], (pad,))])
    f = jax.vmap(lambda a, b: one_lambda((a, b)))
    res = jax.lax.map(lambda args: f(*args),
                      (lb.reshape(-1, k), npx.reshape(-1, k)))
    return res.reshape(-1, cfg.dimpsf, cfg.dimpsf)[:nl]
