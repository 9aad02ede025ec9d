"""Utility-layer tests: logging, profiling, tables."""

import logging

import numpy as np
import pytest
from numpy.testing import assert_allclose

from muse_psfr_tpu.io.table import FitTable
from muse_psfr_tpu.utils.log import setup_logging, get_logger, LOGGER_NAME
from muse_psfr_tpu.utils.profiling import stage_timer, maybe_trace


def test_setup_logging_idempotent():
    lg = setup_logging()
    n = len(lg.handlers)
    lg2 = setup_logging()
    assert lg2 is lg and len(lg2.handlers) == n == 1
    assert get_logger("x").name == LOGGER_NAME + ".x"


def test_stage_timer_logs_at_debug(caplog):
    with caplog.at_level(logging.DEBUG, logger=LOGGER_NAME):
        with stage_timer("unit-test-stage"):
            pass
    assert any("unit-test-stage" in r.message for r in caplog.records)


def test_maybe_trace_noop_without_env(monkeypatch):
    monkeypatch.delenv("MUSE_PSFR_PROFILE_DIR", raising=False)
    with maybe_trace("x"):
        pass  # must not require a profiler session


def test_fit_table_row_access_and_scalar_broadcast():
    t = FitTable()
    t["a"] = np.array([1.0, 2.0, 3.0])
    t["b"] = 7.5                      # scalar broadcast to column length
    assert len(t) == 3
    assert_allclose(t["b"], [7.5, 7.5, 7.5])
    row = t[1]
    assert row["a"] == 2.0 and row["b"] == 7.5
    with pytest.raises(ValueError):
        t["c"] = np.array([1.0, 2.0])  # wrong length


def test_fit_table_vstack_preserves_order():
    t1 = FitTable({"x": np.array([1.0]), "y": np.array([[1.0, 2.0]])})
    t2 = FitTable({"x": np.array([3.0]), "y": np.array([[3.0, 4.0]])})
    out = FitTable.vstack([t1, t2])
    assert out.colnames == ["x", "y"]
    assert_allclose(out["y"], [[1.0, 2.0], [3.0, 4.0]])


def test_pull_packed_restores_shapes_and_values():
    import jax.numpy as jnp
    from muse_psfr_tpu.parallel.batch import pull_packed

    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal((7,)).astype(np.float32)
    c = np.float32(4.25)  # 0-d
    out_a, out_b, out_c = pull_packed(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(c))
    assert_allclose(out_a, a)
    assert_allclose(out_b, b)
    assert out_c.shape == () and out_c == c


def test_pull_packed_sync_knob_is_equivalent():
    """MUSE_PSFR_NO_ASYNC_FINAL=1 (skip the copy_to_host_async pre-issue)
    must be bit-identical to the default async path — the knob only
    changes WHEN the D2H copy command is enqueued, never the bytes."""
    import os

    import jax.numpy as jnp
    from muse_psfr_tpu.parallel.batch import pull_packed

    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal((4, 6)).astype(np.float32),
              rng.standard_normal((11,)).astype(np.float32)]
    dev = [jnp.asarray(a) for a in arrays]
    default = pull_packed(*dev)
    old = os.environ.get("MUSE_PSFR_NO_ASYNC_FINAL")
    os.environ["MUSE_PSFR_NO_ASYNC_FINAL"] = "1"
    try:
        sync = pull_packed(*dev)
    finally:
        if old is None:
            os.environ.pop("MUSE_PSFR_NO_ASYNC_FINAL", None)
        else:
            os.environ["MUSE_PSFR_NO_ASYNC_FINAL"] = old
    for d, s, a in zip(default, sync, arrays):
        assert d.shape == s.shape == a.shape
        assert np.array_equal(d, s)
        assert_allclose(d, a)


def test_moffat_fit_pathological_planes_flagged():
    """Degenerate planes (all-NaN telemetry, empty frames) must come back
    flagged as NaN — the Cholesky LM rejects non-SPD steps instead of
    silently stepping on garbage — and must not perturb the finite planes
    batched alongside them (vmap isolation)."""
    import numpy as np
    from muse_psfr_tpu.fit.moffat_fit import fit_moffat_cube

    yy, xx = np.mgrid[:40, :40]
    good = 3.0 * (1 + ((yy - 20.3) ** 2 + (xx - 19.6) ** 2) / 16.0) ** -2.4
    cube = np.stack([good, np.full((40, 40), np.nan),
                     np.zeros((40, 40)), good])
    f = fit_moffat_cube(cube, dtype="float32")
    assert np.all(np.isnan(f["fwhm"][1:3]))       # flagged, not garbage
    assert np.all(np.isnan(f["err_fwhm"][1:3]))
    assert np.isfinite(f["fwhm"][0]).all()
    np.testing.assert_array_equal(f["fwhm"][0], f["fwhm"][3])
    np.testing.assert_allclose(f["n"][0], 2.4, atol=1e-4)
    # the packed convergence flag mirrors the NaN flagging explicitly
    # (the analog of the reference's scipy-leastsq status)
    np.testing.assert_array_equal(f["ok"], [True, False, False, True])


def test_host64_refit_warns_and_degrades_without_scoped_x64(monkeypatch,
                                                            caplog):
    """If a future jax drops the scoped-x64 context manager, the FIT_MEAN
    float64 refit must fall back to float32 WITH a logged warning — never
    silently (the round-2 fallback was silent)."""
    import logging
    import jax
    from muse_psfr_tpu.fit.moffat_fit import fit_moffat_cube_host64

    yy, xx = np.mgrid[:40, :40]
    good = 3.0 * (1 + ((yy - 20.3) ** 2 + (xx - 19.6) ** 2) / 16.0) ** -2.4
    cube = good[None]

    def broken(*a, **k):
        raise AttributeError("no scoped x64 in this jax")

    monkeypatch.setattr(jax, "enable_x64", broken)
    with caplog.at_level(logging.WARNING, logger="muse_psfr.fit"):
        f = fit_moffat_cube_host64(cube)
    assert any("scoped x64" in r.message for r in caplog.records)
    np.testing.assert_allclose(f["n"][0], 2.4, atol=1e-4)  # f32 fallback


def test_radial_profile_numeric():
    """Azimuthal average of a radially symmetric field reproduces the
    generating profile (reference psfrec.py:810-823 semantics: centre at
    int(n/2 + 0.5), histogram-binned mean per radius)."""
    from muse_psfr_tpu.plotting import radial_profile
    n = 41
    c = int(n / 2 + 0.5)
    y, x = np.ogrid[:n, :n]
    r = np.hypot(y - c, x - c)
    arr = 1.0 / (1.0 + r * r)                     # exact function of r
    with np.errstate(invalid="ignore"):   # empty radius bins -> NaN,
        centers, prof = radial_profile(arr, binsize=1)  # as the reference
    assert centers.shape == prof.shape
    # bin 0 contains only the centre pixel -> exact
    np.testing.assert_allclose(prof[0], 1.0, rtol=1e-12)
    # each bin's mean must lie between the function's values at the
    # bin's radius bounds (monotone decreasing generator)
    k = np.arange(15, dtype=float)
    lo = 1.0 / (1.0 + (k + 1.0) ** 2)
    hi = 1.0 / (1.0 + np.maximum(k - 0.5, 0.0) ** 2)
    p = prof[:15]
    mask = np.isfinite(p)
    assert mask.sum() >= 10
    assert np.all((p[mask] >= lo[mask]) & (p[mask] <= hi[mask]))
    assert np.all(np.diff(p[mask]) < 0)           # monotone decay


def test_plot_directions_smoke():
    """C4's plotting half: LGS/NGS markers and the direction grid render
    (agg backend), with the axis span covering the guide stars."""
    import matplotlib
    matplotlib.use("agg")
    from muse_psfr_tpu.plotting import plot_directions
    from muse_psfr_tpu.core.grids import lgs_positions
    lgs = np.asarray(lgs_positions())
    ax = plot_directions(3, lgs=lgs, ngs=np.array([[10.0], [-20.0]]))
    labels = [t.get_text() for t in ax.get_legend().get_texts()]
    assert any("LGS" in t for t in labels)
    assert any("direction" in t.lower() for t in labels)
