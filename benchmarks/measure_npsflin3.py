"""Timed npsflin=3 (9-direction) night with guard-trip visibility.

Logs any window-guard warning (a trip redoes only the tripped chunks'
rows with the full window) and times the night.

Usage: python benchmarks/measure_npsflin3.py [rows] [chunk] [reps]
"""

import json
import logging
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = int(sys.argv[1]) if len(sys.argv) > 1 else 100
CHUNK = int(sys.argv[2]) if len(sys.argv) > 2 else 44  # one unpadded full-bucket chunk
REPS = int(sys.argv[3]) if len(sys.argv) > 3 else 3
NPSFLIN = int(os.environ.get("MUSE_PSFR_NPSFLIN", "3"))
NL = 35


class TripCounter(logging.Handler):
    def __init__(self):
        super().__init__()
        self.trips = []

    def emit(self, record):
        if "guard tripped" in record.getMessage():
            self.trips.append(record.getMessage())


def main():
    import jax
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import process_batch, \
        rows_windowable, default_support_bucket
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench import build_rows

    counter = TripCounter()
    logging.getLogger("muse_psfr.batch").addHandler(counter)

    cfg = GalacsiConfig()
    # A/B knob: MUSE_PSFR_LAMBDA_CHUNK overrides the wavelengths per OTF
    # step (cfg.lambda_chunk)
    if os.environ.get("MUSE_PSFR_LAMBDA_CHUNK"):
        cfg = cfg.with_(lambda_chunk=int(
            os.environ["MUSE_PSFR_LAMBDA_CHUNK"]))
    lbda = np.linspace(490, 930, NL)
    seeing, GL, L0, mask = build_rows(ROWS)
    okw = rows_windowable(seeing, GL, L0, mask, float(lbda.max()), cfg,
                          default_support_bucket(cfg), npsflin=NPSFLIN)
    print(json.dumps({"windowable_rows": int(okw.sum()), "rows": ROWS}),
          flush=True)

    def run():
        return process_batch(seeing, GL, L0, mask, lbda, npsflin=NPSFLIN,
                             cfg=cfg, chunk=CHUNK)

    t0 = time.perf_counter()
    run()
    print(json.dumps({"warmup_s": round(time.perf_counter() - t0, 1),
                      "warmup_trips": len(counter.trips)}), flush=True)

    times = []
    for rep in range(REPS):
        counter.trips.clear()
        t0 = time.perf_counter()
        run()
        dt = time.perf_counter() - t0
        times.append(dt)
        print(json.dumps({"rep": rep, "t_s": round(dt, 4),
                          "rows_per_sec": round(ROWS / dt, 1),
                          "trips": counter.trips}), flush=True)

    best = min(times)
    print(json.dumps({
        "rows": ROWS, "chunk": CHUNK, "npsflin": NPSFLIN,
        "device": str(jax.devices()[0]),
        "best_s": round(best, 4), "median_s": round(float(np.median(times)), 4),
        "best_rows_per_sec": round(ROWS / best, 1),
    }, indent=1))


if __name__ == "__main__":
    main()
