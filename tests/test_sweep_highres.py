"""Condition-sweep API and the high-resolution (2048^2) grid mode."""

import numpy as np
from numpy.testing import assert_allclose

from muse_psfr_tpu import GalacsiConfig, TINY_CONFIG, compute_psf
from muse_psfr_tpu.api import condition_sweep


def test_condition_sweep_grid_shape_and_consistency():
    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64")
    res = condition_sweep([0.8, 1.2], [0.5, 0.7, 0.9], [25.0],
                          lbda=[700.0, 900.0], cfg=cfg, chunk=6)
    assert res["fwhm"].shape == (2, 3, 1, 2)
    assert res["beta"].shape == (2, 3, 1, 2)
    # physics sanity: worse seeing -> wider PSF at every condition
    assert np.all(res["fwhm"][1] > res["fwhm"][0])
    # more ground-layer fraction (better GLAO correction) -> narrower PSF
    assert np.all(np.diff(res["fwhm"][:, :, 0, 0], axis=1) < 0)


def test_sweep_matches_single_compute():
    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64")
    res = condition_sweep([1.0], [0.7], [25.0], lbda=[700.0], cfg=cfg)
    tbl, _ = compute_psf([700.0], 1.0, 0.7, 25.0, cfg=cfg, verbose=False)
    assert_allclose(res["fwhm"][0, 0, 0, 0], tbl["fwhm"][0, 0], atol=1e-10)


def test_highres_2048_mode():
    """The 2048^2 PSD/OTF grid is the same code path at a larger static
    shape; the correction zone and output sampling are unchanged, so the
    Moffat parameters must be close to the 1280^2 result (the fitting-error
    spectrum just extends to higher frequencies)."""
    lbda = [700.0]
    lo = GalacsiConfig(dtype="float64", fit_dtype="float64")
    hi = lo.with_(dim=2048)
    t_lo, _ = compute_psf(lbda, 1.0, 0.7, 25.0, cfg=lo, verbose=False)
    t_hi, _ = compute_psf(lbda, 1.0, 0.7, 25.0, cfg=hi, verbose=False)
    assert abs(t_hi["fwhm"][0, 0] - t_lo["fwhm"][0, 0]) < 0.02
    assert abs(t_hi["n"][0] - t_lo["n"][0]) < 0.1


def test_highres_2048_night_plan():
    """The full planner stack drives dim=2048 at night scale (VERDICT
    r4 item 4): support buckets at S=512, blue sub-windows at 256/512,
    and the tail menu all engage, and every row lands exactly once."""
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import build_rows
    from muse_psfr_tpu.parallel.batch import plan_batch
    seeing, GL, L0, mask = build_rows(100)
    lb = np.linspace(490, 930, 35)
    plan = plan_batch(seeing, GL, L0, mask, lb, npsflin=1,
                      cfg=GalacsiConfig(dim=2048), chunk=25)
    covered = np.sort(np.concatenate([g.rows for g in plan.groups]))
    assert np.array_equal(covered, np.arange(100))
    sups = {g.cfg.otf_support for g in plan.groups}
    assert sups == {0, 512}, sups          # the dim/4 bucket engaged
    blues = {g.cfg.otf_blue for g in plan.groups if g.cfg.otf_blue}
    assert blues, "blue split did not engage at dim=2048"
    for nb, sb in blues:
        assert sb in (256, 512) and nb % plan.cfg.lambda_chunk == 0
    # tail menu engaged on a reduced-window group (sizes below chunk)
    assert any(s < plan.chunk for g in plan.groups
               if g.cfg.otf_support for s in g.sizes)
