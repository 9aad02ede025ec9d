"""End-to-end golden for a BLUE-ADMITTED row (VERDICT r4 item 5).

The round-4 headline optimisation runs the bluest wavelengths of
admitted rows on a half-bucket OTF sub-window (``cfg.otf_blue``).  This
test proves, via the planner itself, that the pinned bench condition
(seeing=1.0, GL=0.7, L0=25) is blue-admitted in the driver bench-night
plan, then reconstructs that row WITH the blue sub-window engaged and
pins its values against the committed float64 oracle cube — so a blue
sub-window that corrupted values would fail a golden, not just a
planner unit test.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from muse_psfr_tpu.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu.parallel.batch import (plan_batch,  # noqa: E402
                                          reconstruct_batch)

GOLDEN = os.path.join(ROOT, "tests", "data",
                      "golden_psf_35l_s1.0_gl0.7_l025.npy")


def test_bench_pinned_row_is_blue_admitted_and_golden(monkeypatch):
    for var in ("MUSE_PSFR_NO_BLUE", "MUSE_PSFR_BLUE_TIERS"):
        monkeypatch.delenv(var, raising=False)
    from bench import build_rows
    seeing, GL, L0, mask = build_rows(100)
    lb = np.linspace(490, 930, 35)
    plan = plan_batch(seeing, GL, L0, mask, lb, npsflin=1,
                      cfg=GalacsiConfig(), chunk=50)
    g0 = next(g for g in plan.groups if 0 in g.rows.tolist())
    # the planner PROVES the pinned row takes the blue sub-window path
    assert g0.cfg.otf_blue is not None, \
        "bench row 0 no longer blue-admitted; re-point this golden at " \
        "a blue-admitted row"
    nb, sb = g0.cfg.otf_blue
    assert sb < g0.cfg.otf_support or g0.cfg.otf_support == 0

    # reconstruct the row WITH that group config (float32, the
    # production dtype) and pin against the committed float64 oracle
    cube = reconstruct_batch(seeing[:1], GL[:1], L0[:1], mask[:1], lb,
                             cfg=g0.cfg, chunk=1)[0]
    golden = np.load(GOLDEN)
    rms = float(np.sqrt(np.mean((cube.astype(np.float64) - golden) ** 2)))
    assert rms < 1e-5, f"blue-path golden rms {rms:.3e} exceeds 1e-5"
    # and the blue path must agree with the plain full-window compute
    # to float32 noise level (the sub-window truncation is certified)
    plain = reconstruct_batch(seeing[:1], GL[:1], L0[:1], mask[:1], lb,
                              cfg=g0.cfg.with_(otf_blue=None), chunk=1)[0]
    drift = float(np.sqrt(np.mean(
        (cube.astype(np.float64) - plain.astype(np.float64)) ** 2)))
    assert drift < 1e-6, f"blue sub-window drift {drift:.3e}"
