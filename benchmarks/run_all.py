"""Time every production configuration (BASELINE.json) on the current
device and print one JSON object: wall seconds per configuration and
the device label.

Run from the repo root: ``python benchmarks/run_all.py``.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, warm=True, reps=3):
    """Best-of-``reps`` timed runs after a warm-up (the first call
    compiles)."""
    if warm:
        fn()
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import process_batch
    from muse_psfr_tpu.api import condition_sweep
    from bench import build_rows, measure_baseline

    from benchmarks.device_label import device_label

    cfg = GalacsiConfig()
    rows = []

    # 1. single condition, 3 lambda (the CLI config)
    lb3 = np.linspace(500, 900, 3)
    t, _ = timed(lambda: (process_batch(
        [1.0], [0.7], [25.0], np.ones((1, 4)), lb3, cfg=cfg, chunk=1)))
    rows.append(("single condition, 3 lambda (CLI)", 1, t))

    # 2. one row, full 35-lambda cube + fit
    lb35 = np.linspace(490, 930, 35)
    t, _ = timed(lambda: (process_batch(
        [1.0], [0.7], [25.0], np.ones((1, 4)), lb35, cfg=cfg, chunk=1)))
    rows.append(("one row x 35 lambda", 1, t))

    # 3. full night: 100 rows x 35 lambda
    seeing, GL, L0, mask = build_rows(100)
    t, _ = timed(lambda: (process_batch(
        seeing, GL, L0, mask, lb35, cfg=cfg, chunk=50)))
    rows.append(("full night: 100 rows x 35 lambda", 100, t))

    # 3a. full night in the 9-direction mode (npsflin=3, the reference's
    # compute_psf_from_sparta default signature)
    t, _ = timed(lambda: (process_batch(
        seeing, GL, L0, mask, lb35, npsflin=3, cfg=cfg, chunk=44)))
    rows.append(("full night, npsflin=3 (9 directions): 100 rows x 35 "
                 "lambda", 100, t))

    # 3a'. extended 9-direction night: 1000 rows at chunk 88 (= 2x44)
    seeing1k, GL1k, L01k, mask1k = build_rows(1000)
    t, _ = timed(lambda: (process_batch(
        seeing1k, GL1k, L01k, mask1k, lb35, npsflin=3, cfg=cfg,
        chunk=88)))
    rows.append(("extended 9-direction night: 1000 rows x 35 lambda "
                 "(chunk=88)", 1000, t))

    # 3b. extended steady state: 1000 rows.  warm=True: the pipeline
    # executable is shared with config 3, but the batch size still owns
    # small one-time compiles (chunk-slice, fit concatenation) that a
    # steady-state figure must exclude.
    t, _ = timed(lambda: (process_batch(
        seeing1k, GL1k, L01k, mask1k, lb35, cfg=cfg, chunk=100)))
    rows.append(("extended: 1000 rows x 35 lambda (steady state)", 1000, t))

    # 4. high-resolution 2048^2 grids, one row x 35 lambda
    cfg_hi = cfg.with_(dim=2048)
    t, _ = timed(lambda: (process_batch(
        [1.0], [0.7], [25.0], np.ones((1, 4)), lb35, cfg=cfg_hi, chunk=1)))
    rows.append(("high-res 2048^2: one row x 35 lambda", 1, t))

    # 4a. high-res NIGHT: 100 rows through the full planner at 2048^2
    # (buckets at S=512, blue splits at 256/512, tail menu)
    t, _ = timed(lambda: (process_batch(
        seeing, GL, L0, mask, lb35, cfg=cfg_hi, chunk=25)))
    rows.append(("high-res 2048^2 night: 100 rows x 35 lambda", 100, t))

    # 5. 32x32 condition sweep over (seeing, GL) at fixed L0, 35 lambda
    sv = np.linspace(0.6, 1.6, 32)
    gv = np.linspace(0.3, 0.9, 32)
    # warm=True: the first full run owns the sweep-shape one-time small
    # compiles (fit concatenation, reorder gather, psum stack) and the
    # OTF-support estimate for this grid; the second run is steady state
    # like every other row of the table
    t, _ = timed(lambda: condition_sweep(sv, gv, [25.0], lbda=lb35,
                                         cfg=cfg, chunk=64))
    rows.append(("condition sweep 32x32 (seeing, GL) x 35 lambda",
                 32 * 32, t))

    # 5a. 3-axis sweep actually varying L0 (16x16x8 = 2048 points),
    # including one L0 value below cfg.dphi_split_l0_min (2.5 m): those
    # grid points run the exact structure-function transform bucket (the
    # certified Taylor split is out of its domain), so this row
    # exercises all three executables the sweep planner can emit.  The
    # 3.5/4.5 points moved onto the split path when the default
    # certification range was extended to L0 >= 2.5 (degree 5).
    sv16 = np.linspace(0.6, 1.6, 16)
    gv16 = np.linspace(0.3, 0.9, 16)
    lv8 = np.array([2.0, 4.5, 8.0, 11.0, 14.0, 18.0, 23.0, 29.0])
    t, _ = timed(lambda: condition_sweep(sv16, gv16, lv8, lbda=lb35,
                                         cfg=cfg, chunk=64))
    rows.append(("condition sweep 16x16x8 (seeing, GL, L0) x 35 lambda",
                 16 * 16 * 8, t))

    base = measure_baseline()
    from muse_psfr_tpu.parallel.batch import fft_available
    print(json.dumps({
        "device": device_label(),
        "dtype": cfg.dtype,
        "fft": fft_available(),
        "proxy_rows_per_sec": base["rows_per_sec"],
        "rows": [{"configuration": name, "work_items": n, "wall_s": t}
                 for name, n, t in rows],
    }))


if __name__ == "__main__":
    main()
