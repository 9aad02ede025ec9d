"""Batched circular Moffat fitting (JAX Levenberg-Marquardt).

Replaces the reference's per-plane ``mpdaf.obj.Image.moffat_fit`` calls
(reference psfrec.py:861-871), which wrap ``scipy.optimize.leastsq`` — a
sequential host loop over wavelength planes.  Here a fixed-iteration
Levenberg-Marquardt solver with analytic Jacobian fits *all* planes of all
rows in parallel under ``vmap``/``jit`` (the normal equations are 5x5, so
each iteration is a fused batch of tiny elementwise ops).

Model (circular, no background — the reference pipeline always uses
``circular=True, fit_back=False``):

    m(y, x) = peak * (1 + ((y-cy)^2 + (x-cx)^2)/alpha^2)^(-n)

Derived quantities and 1-sigma errors follow the standard least-squares
covariance ``cov = SSR/(N-5) * (J^T J)^{-1}`` with delta-method propagation
for fwhm (= 2 alpha sqrt(2^(1/n)-1)) and flux (= peak pi alpha^2 / (n-1)),
matching the float64 oracle (benchmarks/oracle_numpy.py).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

N_PARAMS = 5
# 20 is certified, not generous: stress planes (broad/low-beta/off-centre)
# still move ~1e-2 at 14 iterations and ~1e-6 (= the fit-contract atol) at
# 16, while 20 reproduces 40 bit-identically in f64 — ladder in
# benchmarks/measure_lm_iters.py, guarded by
# tests/test_oracle_parity.py::test_lm_iteration_count_certified.
LM_ITERS = 20

#: layout of the packed per-plane fit result (one device->host transfer).
#: ``ok`` is the fit-quality flag (1.0 = converged: finite final
#: parameters, improving LM steps were accepted, and the final Gram
#: matrix was SPD so the error bars are meaningful) — the analog of the
#: scipy ``leastsq``/mpdaf ``ier`` status the reference surfaces
#: (psfrec.py:861-871).
PACKED_FIELDS = ("cy", "cx", "err_cy", "err_cx", "flux", "err_flux",
                 "peak", "err_peak", "fwhm", "err_fwhm", "n", "err_n",
                 "ok")
N_PACKED = len(PACKED_FIELDS)


def _model_and_jac(p, yy, xx):
    cy, cx, peak, alpha, n = p
    dy = yy - cy
    dx = xx - cx
    rr = (dy * dy + dx * dx) / (alpha * alpha)
    u = 1.0 + rr
    lu = jnp.log(u)
    un = jnp.exp(-n * lu)        # u ** (-n): one log + one exp for the
    m = peak * un                # whole Jacobian (the fit is
    common = peak * n * un / u   # transcendental-bound)
    j_cy = common * 2.0 * dy / (alpha * alpha)
    j_cx = common * 2.0 * dx / (alpha * alpha)
    j_peak = un
    j_alpha = common * 2.0 * rr / alpha
    j_n = -m * lu
    return m, (j_cy, j_cx, j_peak, j_alpha, j_n)


def _init_params(img, yy, xx):
    peak0 = jnp.max(img)
    flat = jnp.argmax(img)
    cy0 = (flat // img.shape[1]).astype(img.dtype)
    cx0 = (flat % img.shape[1]).astype(img.dtype)
    tot = jnp.sum(img)
    var = jnp.sum(img * ((yy - cy0) ** 2 + (xx - cx0) ** 2)) / tot
    fwhm0 = jnp.maximum(2.355 * jnp.sqrt(jnp.maximum(var, 0.25) / 2.0), 1.0)
    a0 = fwhm0 / (2.0 * jnp.sqrt(2.0 ** 0.5 - 1.0))
    return jnp.stack([cy0, cx0, peak0, a0, jnp.asarray(2.0, img.dtype)])


def _gram(jac_cols, r):
    """Normal-equation pieces from per-pixel jacobian columns.

    ``jtj[i][j] = sum(J_i * J_j)`` and ``jtr[i] = sum(J_i * r)`` as
    explicit reductions: a (5, npix) x (npix, 5) matmul has a 5-wide
    output that fills no matrix unit and, under vmap over hundreds of
    planes, becomes hundreds of tiny dots; 15 scalar reductions are
    elementwise work that vectorises over the plane batch (and stay
    exact float32 adds whatever the backend's matmul precision).
    """
    n = len(jac_cols)
    jtj = [[jnp.sum(jac_cols[i] * jac_cols[j]) for j in range(i + 1)]
           for i in range(n)]
    jtr = [jnp.sum(jac_cols[i] * r) for i in range(n)]
    return jtj, jtr


def _chol_factor(a_lower):
    """Unrolled Cholesky of a tiny SPD matrix given as a lower-triangular
    list-of-lists of batched scalars.  Unrolling makes every operation
    an elementwise op over the plane batch, where ``jnp.linalg`` would
    run one tiny (5, 5) factorisation per plane.  A non-SPD input
    (degenerate plane) yields NaN, which the LM step then *rejects*
    (NaN compares false), instead of silently stepping on garbage."""
    n = len(a_lower)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a_lower[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve(L, b):
    """Solve ``L L^T x = b`` (lists of batched scalars)."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _chol_inverse(a_lower):
    """Inverse of a tiny SPD matrix via n unrolled Cholesky solves."""
    n = len(a_lower)
    L = _chol_factor(a_lower)
    one = jnp.ones_like(a_lower[0][0])
    zero = jnp.zeros_like(one)
    cols = [_chol_solve(L, [one if i == j else zero for i in range(n)])
            for j in range(n)]
    return cols  # cols[j][i] = inv[i, j] (= inv[j, i] by symmetry)


def _lm_solve(img, yy, xx):
    """Fixed-iteration LM on one plane.

    Returns ``(params, cov diag, ok)``: ``ok`` is 1.0 when the solve is
    trustworthy — final parameters finite, at least one improving LM
    step accepted (a degenerate plane yields NaN steps which are all
    *rejected*, leaving the initial guess), and the final Gram matrix
    SPD (finite covariance) — and 0.0 otherwise.
    """
    dtype = img.dtype
    data = img.ravel()

    def model_cols(p):
        m, jac = _model_and_jac(p, yy, xx)
        r = m.ravel() - data
        return r, [c.ravel() for c in jac]

    def cost_of(p):
        m, _ = _model_and_jac(p, yy, xx)
        r = m.ravel() - data
        return jnp.sum(r * r)

    p0 = _init_params(img, yy, xx)
    lam0 = jnp.asarray(1e-3, dtype)

    def step(carry, _):
        p, lam, c, acc = carry
        r, cols = model_cols(p)
        jtj, jtr = _gram(cols, r)
        a = [[jtj[i][j] * ((1.0 + lam) if i == j else 1.0)
              for j in range(i + 1)] for i in range(N_PARAMS)]
        delta = _chol_solve(_chol_factor(a), [-g for g in jtr])
        p_new = p + jnp.stack(delta)
        c_new = cost_of(p_new)
        better = c_new < c
        p = jnp.where(better, p_new, p)
        c = jnp.where(better, c_new, c)
        acc = acc | better
        lam = jnp.where(better, lam / 3.0, lam * 2.0)
        lam = jnp.clip(lam, 1e-12, 1e8)
        return (p, lam, c, acc), None

    (p, _, c, acc), _ = jax.lax.scan(
        step, (p0, lam0, cost_of(p0), jnp.asarray(False)),
        None, length=LM_ITERS)

    r, cols = model_cols(p)
    jtj, _ = _gram(cols, r)
    inv_cols = _chol_inverse(jtj)
    dof = data.shape[0] - N_PARAMS
    var = jnp.stack([inv_cols[k][k] for k in range(N_PARAMS)]) * (c / dof)
    # converged = finite solution with meaningful error bars AND either
    # an accepted improving step or an already-(numerically-)optimal
    # initial guess (relative SSR below rounding) — a degenerate plane
    # fails all of these (NaN steps are rejected, its Gram is non-SPD)
    solved = acc | (c < 1e-12 * jnp.sum(data * data))
    ok = (solved & jnp.all(jnp.isfinite(p)) & jnp.all(jnp.isfinite(var)))
    return p, var, ok.astype(dtype)


@partial(jax.jit, static_argnames=("dtype",))
def fit_moffat_cube_packed(cube, dtype: str = "float32"):
    """Fit every (ny, nx) plane of ``cube`` (..., ny, nx) with a circular
    Moffat.  Returns one array of shape ``cube.shape[:-2] + (N_PACKED,)``
    laid out per :data:`PACKED_FIELDS` — a single small array so batch
    consumers pay one device->host transfer instead of ten.
    """
    dt = jnp.dtype(dtype)
    lead = cube.shape[:-2]
    ny, nx = cube.shape[-2:]
    planes = cube.reshape((-1, ny, nx)).astype(dt)
    yy, xx = jnp.mgrid[:ny, :nx]
    yy = yy.astype(dt)
    xx = xx.astype(dt)

    p, var, ok = jax.vmap(lambda im: _lm_solve(im, yy, xx))(planes)
    err = jnp.sqrt(jnp.maximum(var, 0.0))

    cy, cx, peak, alpha, n = (p[:, k] for k in range(N_PARAMS))
    e_cy, e_cx, e_peak, e_alpha, e_n = (err[:, k] for k in range(N_PARAMS))

    k_f = 2.0 * jnp.sqrt(2.0 ** (1.0 / n) - 1.0)
    fwhm = alpha * k_f
    dk_dn = (-jnp.log(2.0) * 2.0 ** (1.0 / n)
             / (n * n * jnp.sqrt(2.0 ** (1.0 / n) - 1.0)))
    err_fwhm = jnp.sqrt((k_f * e_alpha) ** 2 + (alpha * dk_dn * e_n) ** 2)
    flux = peak * np.pi * alpha * alpha / (n - 1.0)
    err_flux = jnp.abs(flux) * jnp.sqrt((e_peak / peak) ** 2 +
                                        (2.0 * e_alpha / alpha) ** 2 +
                                        (e_n / (n - 1.0)) ** 2)

    packed = jnp.stack([cy, cx, e_cy, e_cx, flux, err_flux, peak, e_peak,
                        fwhm, err_fwhm, n, e_n, ok], axis=-1)
    return packed.reshape(lead + (N_PACKED,))


def unpack_fit(packed):
    """Packed fit array (host or device) -> dict of numpy arrays with the
    reference's column shapes (center/fwhm as 2-vectors).

    Accepts both the current ``N_PACKED``-wide layout and the pre-1.5
    12-field layout without the ``ok`` flag (e.g. ``condition_sweep``
    checkpoint ``.npy`` files written by older versions) — the ``ok``
    key is then reported all-True."""
    packed = np.asarray(packed)
    width = packed.shape[-1]
    if width == N_PACKED:
        fields = PACKED_FIELDS
    elif width == N_PACKED - 1:          # pre-1.5 checkpoint without 'ok'
        fields = PACKED_FIELDS[:-1]
    else:
        raise ValueError(
            f"packed fit array has {width} fields; expected {N_PACKED} "
            f"(or {N_PACKED - 1} for pre-1.5 data) laid out per "
            "muse_psfr_tpu.fit.moffat_fit.PACKED_FIELDS")
    f = {name: packed[..., k] for k, name in enumerate(fields)}
    if "ok" not in f:
        f["ok"] = np.ones(packed.shape[:-1], packed.dtype)
    dup = lambda a, b: np.stack([a, b], axis=-1)  # noqa: E731
    return {
        "center": dup(f["cy"], f["cx"]),
        "err_center": dup(f["err_cy"], f["err_cx"]),
        "flux": f["flux"], "err_flux": f["err_flux"],
        "peak": f["peak"], "err_peak": f["err_peak"],
        "fwhm": dup(f["fwhm"], f["fwhm"]),
        "err_fwhm": dup(f["err_fwhm"], f["err_fwhm"]),
        "n": f["n"], "err_n": f["err_n"],
        "ok": f["ok"] > 0.5,
    }


def fit_moffat_cube(cube, dtype: str = "float32"):
    """Fit every plane of ``cube`` with a circular Moffat; returns a dict of
    numpy arrays (center (.., 2), flux, peak, fwhm (.., 2) [px], n, and
    their 1-sigma errors).  One device->host transfer."""
    return unpack_fit(fit_moffat_cube_packed(cube, dtype=dtype))


def fit_moffat_cube_host64(cube):
    """Float64 Moffat fit executed on the host CPU backend.

    The reference is float64 end-to-end; the float32 LM solve of the
    device pipeline leaves ~1e-3-level noise on the fitted parameters,
    which a downstream polynomial fit amplifies ~3x against
    the reference's 1e-2 coefficient contract (docs/precision.md).  For
    *small* contract-critical cubes (the mean PSF, single conditions)
    this helper runs the same solver in float64 on the host CPU device —
    measured to cut the polynomial-coefficient error ~8x (beta_pol[0]:
    7.3e-4 -> 9.3e-5 vs the float64 truth).  The x64 scope is local: the
    global ``jax_enable_x64`` setting is untouched.
    """
    cube = np.asarray(cube, np.float64)
    from ..utils.devices import host_cpu_device
    cpu = host_cpu_device()
    try:
        ctx = jax.enable_x64(True)  # public scoped-x64 API (jax >= 0.4.26)
    except Exception:  # fallback for a jax without scoped x64
        from ..utils.log import get_logger
        get_logger("fit").warning(
            "scoped x64 unavailable in this jax (%s): the FIT_MEAN refit "
            "runs in float32, degrading the polynomial-coefficient "
            "contract ~8x (docs/precision.md)", jax.__version__)
        return fit_moffat_cube(jnp.asarray(cube), dtype="float32")
    with ctx, jax.default_device(cpu):
        return unpack_fit(np.asarray(
            fit_moffat_cube_packed(jnp.asarray(cube), dtype="float64")))
