"""LM iteration-count certification ladder for the Moffat fit stage.

Question: can ``fit.moffat_fit.LM_ITERS`` (fixed scan length, 20) be
lowered to shave the fit stage?

Method: run ``_lm_solve`` with a patched iteration count on
(a) the committed golden 35-lambda PSF cube and (b) a synthetic stress
grid spanning the realistic circular-Moffat range the pipeline fits
(fwhm 1.5-9 px x beta 1.6-3.5, centred and off-centre, clean and with
1% noise, 131 planes total), and report the max parameter deviation
against the converged (40-iteration) solution, per dtype.

Measured answer (CPU, x64 + f32 — committed so that it is not
re-explored): NOT converged by 10 — the stress planes
(broad/low-beta/off-centre) still move up to ~3.4 in beta at 6 iters,
~0.01 at 14, and ~1.4e-6 at 16, right at the fit contract's atol 1e-6
(tests/test_oracle_parity.py).  20 reproduces 40 BIT-IDENTICALLY in
f64 (f32 differences ~2e-5 are LM dithering at the f32 noise floor,
not convergence).  Lowering to 16 would save at most a fifth of the fit stage while
consuming the whole certification margin; a vmapped ``while_loop``
early exit is no better because a night-scale batch almost surely
contains a ~18-iteration plane and vmap runs the max lane count.
CLOSED: the fixed 20 stands.  Regression guard:
tests/test_oracle_parity.py::test_lm_iteration_count_certified.
"""
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

import muse_psfr_tpu.fit.moffat_fit as mf

PARAM_NAMES = ("cy", "cx", "peak", "alpha", "n")


def stress_planes(ny=40, nx=40, seed=0):
    """Golden cube + a circular-Moffat grid over the realistic range."""
    cube = np.load(__file__.rsplit("/", 2)[0]
                   + "/tests/data/golden_psf_35l_s1.0_gl0.7_l025.npy")
    yy, xx = np.mgrid[:ny, :nx].astype(np.float64)
    rng = np.random.default_rng(seed)
    planes = [cube.astype(np.float64)]
    for fwhm_px in (1.5, 2.0, 3.0, 4.5, 6.5, 9.0):
        for beta in (1.6, 2.2, 2.8, 3.5):
            for cy, cx in ((ny / 2 - 0.5, nx / 2 - 0.5),
                           (ny / 2 + 1.3, nx / 2 - 2.1)):
                alpha = fwhm_px / (2 * np.sqrt(2 ** (1 / beta) - 1))
                r2 = (yy - cy) ** 2 + (xx - cx) ** 2
                m = (1 + r2 / alpha ** 2) ** (-beta)
                planes.append(m[None])
                planes.append(
                    (m * (1 + 0.01 * rng.standard_normal(m.shape)))[None])
    return np.concatenate(planes, axis=0), yy, xx


def fit_at(iters, planes, yy, xx, dtype):
    old = mf.LM_ITERS
    mf.LM_ITERS = iters
    try:
        f = jax.jit(jax.vmap(
            lambda p: mf._lm_solve(p, jnp.asarray(yy, dtype),
                                   jnp.asarray(xx, dtype))))
        p, var, ok = f(jnp.asarray(planes, dtype))
        return np.asarray(p), np.asarray(var), np.asarray(ok)
    finally:
        mf.LM_ITERS = old


def main():
    planes, yy, xx = stress_planes()
    print(f"planes: {planes.shape[0]} (35 golden + {planes.shape[0] - 35} "
          "stress)")
    for dtype, name in ((jnp.float64, "f64"), (jnp.float32, "f32")):
        ref_p, ref_v, ref_ok = fit_at(40, planes, yy, xx, dtype)
        assert ref_ok.all()
        print(f"--- {name} (reference: 40 iterations)")
        for it in (6, 8, 10, 12, 14, 16, 20):
            p, v, ok = fit_at(it, planes, yy, xx, dtype)
            dp = np.abs(p - ref_p).max(axis=0)
            print(f"{name} iters={it:2d} ok={int(ok.sum())}/{len(ok)} "
                  f"max|dp| {dict(zip(PARAM_NAMES, np.round(dp, 10)))}")


if __name__ == "__main__":
    main()
