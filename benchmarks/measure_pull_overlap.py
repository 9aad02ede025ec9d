"""A/B measurement of the pull-tail overlap in ``process_batch``.

Without the overlap the packed result pull is serialized after the last
chunk.  The overlap starts the device->host copy of each completed
part's packed fits while later chunks compute, so most of the transfer
hides under tail compute at the cost of one extra pull's latency.  This
script times alternating on/off nights in one process (shared
executables, shared device state) and prints a JSON summary.

Usage: python benchmarks/measure_pull_overlap.py [rows] [chunk] [reps]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
CHUNK = int(sys.argv[2]) if len(sys.argv) > 2 else 50
REPS = int(sys.argv[3]) if len(sys.argv) > 3 else 4
NL = 35


def main():
    import jax
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import process_batch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench import build_rows  # noqa: E402 - same night as bench.py

    cfg = GalacsiConfig()
    lbda = np.linspace(490, 930, NL)
    seeing, GL, L0, mask = build_rows(ROWS)

    def run():
        return process_batch(seeing, GL, L0, mask, lbda, npsflin=1,
                             cfg=cfg, chunk=CHUNK)

    t0 = time.perf_counter()
    run()  # compile both bucket executables
    print(json.dumps({"warmup_s": round(time.perf_counter() - t0, 1)}),
          flush=True)

    times = {"overlap": [], "no_overlap": []}
    for rep in range(REPS):
        for mode in ("overlap", "no_overlap"):
            if mode == "no_overlap":
                os.environ["MUSE_PSFR_NO_OVERLAP"] = "1"
            else:
                os.environ.pop("MUSE_PSFR_NO_OVERLAP", None)
            t0 = time.perf_counter()
            run()
            dt = time.perf_counter() - t0
            times[mode].append(dt)
            print(json.dumps({"rep": rep, "mode": mode,
                              "t_s": round(dt, 4),
                              "rows_per_sec": round(ROWS / dt, 1)}),
                  flush=True)
    os.environ.pop("MUSE_PSFR_NO_OVERLAP", None)

    best = {m: min(v) for m, v in times.items()}
    med = {m: float(np.median(v)) for m, v in times.items()}
    print(json.dumps({
        "rows": ROWS, "chunk": CHUNK, "device": str(jax.devices()[0]),
        "best_s": {m: round(v, 4) for m, v in best.items()},
        "median_s": {m: round(v, 4) for m, v in med.items()},
        "best_rows_per_sec": {m: round(ROWS / v, 1)
                              for m, v in best.items()},
        "overlap_speedup_best": round(best["no_overlap"] / best["overlap"],
                                      3),
        "overlap_speedup_median": round(med["no_overlap"] / med["overlap"],
                                        3),
    }, indent=1))


if __name__ == "__main__":
    main()
