"""Stage-by-stage parity of the JAX pipeline vs the float64 NumPy oracle.

The oracle (benchmarks/oracle_numpy.py) was itself validated to <1e-8
absolute against the reference implementation's PSD/PSF stages and
reproduces the reference's golden CLI values; these tests pin the JAX
pipeline to it stage by stage in float64 and bound the float32 drift.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from muse_psfr_tpu import GalacsiConfig
from muse_psfr_tpu.psd.model import simulate_psd, effective_wind_speed
from muse_psfr_tpu.otf.psf import psf_cube
from muse_psfr_tpu.otf.convolve import convolve_final
from muse_psfr_tpu.fit.moffat_fit import fit_moffat_cube

from benchmarks import oracle_numpy as orc

CFG64 = GalacsiConfig(dtype="float64", fit_dtype="float64")
LB3 = np.array([500.0, 700.0, 900.0])


def test_effective_wind_speed_quirk():
    cfg = CFG64
    assert effective_wind_speed((100, 10000), cfg) == 12.0
    assert effective_wind_speed((100.0, 10000.0), cfg) == 12.5


@pytest.mark.parametrize("npsflin,mask", [(1, [1, 1, 1, 1]),
                                          (3, [1, 1, 1, 0])])
def test_psd_vs_oracle(npsflin, mask):
    out = simulate_psd(1.0, 0.7, 25.0, jnp.array(mask, jnp.float64),
                       jnp.array([100.0, 10000.0]), 12.0, npsflin, CFG64)
    ref = orc.simulate_psd([0.7, 0.3], (100, 10000), 1.0, 25.0,
                           npsflin=npsflin, three_lgs_mode=(mask[3] == 0))
    assert np.abs(np.asarray(out) - ref).max() / ref.max() < 1e-12


def test_psf_and_convolve_vs_oracle():
    psd = simulate_psd(1.0, 0.7, 25.0, jnp.ones(4), jnp.array([100.0, 10000.0]),
                       12.0, 1, CFG64)
    ref_psd = orc.simulate_psd([0.7, 0.3], (100, 10000), 1.0, 25.0)
    cube = np.asarray(psf_cube(psd[0], jnp.array(LB3), CFG64))
    ref_cube = orc.psf_cube_from_psd(ref_psd[0], LB3)
    assert np.abs(cube - ref_cube).max() < 1e-13

    fin = np.asarray(convolve_final(jnp.asarray(cube), jnp.array(LB3),
                                    1.0, 0.7, 25.0, CFG64))
    ref_fin = orc.convolve_tt_and_instrument(ref_cube, LB3, 1.0, 0.7, 25.0)
    assert np.abs(fin - ref_fin).max() < 1e-13

    fit = fit_moffat_cube(jnp.asarray(fin), dtype="float64")
    ref_fits = [orc.fit_moffat_circular(ref_fin[k]) for k in range(3)]
    for k in range(3):
        assert np.allclose(np.asarray(fit["fwhm"])[k, 0],
                           ref_fits[k]["fwhm"][0], atol=1e-6)
        assert np.allclose(np.asarray(fit["n"])[k], ref_fits[k]["n"],
                           atol=1e-6)
        assert np.allclose(np.asarray(fit["err_fwhm"])[k, 0],
                           ref_fits[k]["err_fwhm"][0], rtol=1e-4)


def test_float32_psf_close_to_float64():
    """Bound the float32 (production default) drift of the final PSF
    cube."""
    cfg32 = GalacsiConfig(dtype="float32", fit_dtype="float32")
    psd64 = simulate_psd(1.0, 0.7, 25.0, jnp.ones(4),
                         jnp.array([100.0, 10000.0]), 12.0, 1, CFG64)
    cube64 = np.asarray(psf_cube(psd64[0], jnp.array(LB3), CFG64))
    fin64 = np.asarray(convolve_final(jnp.asarray(cube64), jnp.array(LB3),
                                      1.0, 0.7, 25.0, CFG64))

    psd32 = simulate_psd(jnp.float32(1.0), jnp.float32(0.7), jnp.float32(25.0),
                         jnp.ones(4, jnp.float32),
                         jnp.array([100.0, 10000.0], jnp.float32),
                         12.0, 1, cfg32)
    cube32 = psf_cube(psd32[0], jnp.array(LB3, jnp.float32), cfg32)
    fin32 = np.asarray(convolve_final(cube32, jnp.array(LB3, jnp.float32),
                                      jnp.float32(1.0), jnp.float32(0.7),
                                      jnp.float32(25.0), cfg32))
    rms = np.sqrt(np.mean((fin32.astype(np.float64) - fin64) ** 2))
    assert rms < 1e-5, f"float32 PSF rms drift {rms:.2e} exceeds 1e-5"


def test_float32_worst_corner_accuracy():
    """Cross-condition float32 accuracy guard: the excellent-seeing corner
    (sharp PSF, small L0) is the hardest condition — it measured 1.45e-5
    rms before the GLAO transfer functions became trace-time float64
    constants, and must stay well inside the 1e-5 budget now."""
    import os
    from benchmarks.oracle_numpy import compute_psf_oracle
    lb = np.linspace(490, 930, 35)
    seeing, GL, L0 = 0.6, 0.3, 9.1
    _, ref = compute_psf_oracle(lb, seeing, GL, L0)
    cfg = GalacsiConfig(dtype="float32")
    psd = simulate_psd(jnp.float32(seeing), jnp.float32(GL), jnp.float32(L0),
                       jnp.ones(4, jnp.float32), (100.0, 10000.0), 12.0,
                       1, cfg)
    out = np.asarray(convolve_final(
        psf_cube(psd, jnp.asarray(lb, jnp.float32), cfg),
        jnp.asarray(lb, jnp.float32), seeing, GL, L0, cfg), np.float64)
    rms = np.sqrt(np.mean((out - ref) ** 2))
    assert rms < 2e-6, f"worst-corner float32 rms {rms:.2e}"


def test_lm_iteration_count_certified():
    """LM_ITERS=20 is converged, and the margin is real.

    Certification ladder in benchmarks/measure_lm_iters.py: on the
    golden 35-lambda cube plus a 96-plane stress grid spanning the
    realistic circular-Moffat range, 20 iterations reproduce the
    40-iteration solution bit-identically in float64, while 14 still
    moves parameters by ~1e-2 (and 16 sits at ~1.4e-6, the whole
    fit-contract atol).  Guards against lowering LM_ITERS without
    re-running the ladder — the saving would be ~2-3% of a night,
    inside the chip's run-to-run spread.
    """
    from benchmarks.measure_lm_iters import stress_planes, fit_at
    planes, yy, xx = stress_planes()
    ref_p, _, ref_ok = fit_at(40, planes, yy, xx, jnp.float64)
    p20, _, ok20 = fit_at(20, planes, yy, xx, jnp.float64)
    p14, _, _ = fit_at(14, planes, yy, xx, jnp.float64)
    assert ref_ok.all() and ok20.all()
    assert np.abs(p20 - ref_p).max() < 1e-9
    # the stress set must stay hard enough to justify the 20-iter margin
    assert np.abs(p14 - ref_p).max() > 1e-3
