"""Latency breakdown of the short (100-row) driver-bench night.

A short night pays fixed costs that a long night amortises; this
script decomposes them:

- ``plan``              host-side planning (rows_windowable, grouping)
- ``dispatch_enqueue``  host wall time to enqueue every chunk (async)
- ``mean_enqueue``      mean-PSF + mean-fit dispatch (async)
- ``final_pull``        everything that drains at the sync pull: the
                        outstanding device compute + packed transfer
                        bytes + the pull's round trip
- ``drained_pull``      the same packed pull with the device already
                        drained (measured separately via
                        ``_return_parts``): pure transfer + latency
- ``mean_refit``        host-side f64 refit of the mean PSF
                        (api.compute_psf_from_sparta only; measured
                        here standalone for the record)

Usage: python benchmarks/measure_short_night.py [rows] [chunk] [reps]
                                                [npsflin]
"""

import json
import logging
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = int(sys.argv[1]) if len(sys.argv) > 1 else 100
CHUNK = int(sys.argv[2]) if len(sys.argv) > 2 else 25
REPS = int(sys.argv[3]) if len(sys.argv) > 3 else 4
NPSFLIN = int(sys.argv[4]) if len(sys.argv) > 4 else 1
NL = 35


class StageGrabber(logging.Handler):
    def __init__(self):
        super().__init__()
        self.stages = {}

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("stage "):
            parts = msg.split()
            self.stages[parts[1]] = float(parts[2])


def main():
    import jax
    import jax.numpy as jnp
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import process_batch, pull_packed
    from bench import build_rows

    grab = StageGrabber()
    plog = logging.getLogger("muse_psfr.profile")
    plog.addHandler(grab)
    plog.setLevel(logging.DEBUG)

    cfg = GalacsiConfig()
    lbda = np.linspace(490, 930, NL)
    seeing, GL, L0, mask = build_rows(ROWS)

    def night():
        return process_batch(seeing, GL, L0, mask, lbda, npsflin=NPSFLIN,
                             cfg=cfg, chunk=CHUNK)

    t0 = time.perf_counter()
    night()
    print(json.dumps({"warmup_s": round(time.perf_counter() - t0, 1)}),
          flush=True)

    best, best_stages = None, None
    for _ in range(REPS):
        grab.stages.clear()
        t0 = time.perf_counter()
        night()
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best, best_stages = dt, dict(grab.stages)
    out = {"rows": ROWS, "npsflin": NPSFLIN,
           "night_best_s": round(best, 4),
           "rows_per_sec": round(ROWS / best, 1)}
    out.update({k.replace("batch.", "") + "_ms": round(v, 2)
                for k, v in best_stages.items()})

    # drained pull: compute the night with no pull, block, then time the
    # packed pull alone -> pure transfer bytes + round trip
    fit_d, psum_d, guard_d = process_batch(
        seeing, GL, L0, mask, lbda, npsflin=NPSFLIN, cfg=cfg, chunk=CHUNK,
        _return_parts=True)
    # drain the device with a tiny sync pull of a dependent scalar
    float(np.asarray(jnp.sum(fit_d) + jnp.sum(psum_d) + jnp.sum(guard_d)))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        pull_packed(fit_d, psum_d / ROWS, guard_d)
        ts.append(time.perf_counter() - t0)
    out["drained_pull_ms"] = round(1e3 * min(ts), 2)

    # host-side f64 mean refit (the compute_psf_from_sparta FIT_MEAN
    # restore step, api.py): numpy/scipy-free LM on one (nl, d, d) cube
    from muse_psfr_tpu.fit.moffat_fit import fit_moffat_cube_packed
    psf_mean = np.asarray(psum_d, np.float64) / ROWS
    with jax.default_device(jax.devices("cpu")[0]):
        fit_moffat_cube_packed(jnp.asarray(psf_mean), dtype="float64")
        t0 = time.perf_counter()
        fit_moffat_cube_packed(jnp.asarray(psf_mean), dtype="float64")
        out["mean_refit_cpu_ms"] = round(1e3 * (time.perf_counter() - t0), 2)

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
