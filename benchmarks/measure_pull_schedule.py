"""A/B of the pull-part CUT SCHEDULE (MUSE_PSFR_PULL_AT).

The night's tail is the final packed pull: a fixed latency + the BYTES
of every chunk not yet covered by an async part.  The default stride schedule (first cut
at part_n//2, then every part_n chunks) leaves a multi-chunk remainder
— e.g. 4 of the 11 chunks of the 1000-row/chunk=100 night.  Cutting
the last part near the end shrinks the remainder, at the price of a
late part drain that may no longer hide under compute.  This script
times named schedules alternating in one process.

Usage: python benchmarks/measure_pull_schedule.py [rows] [chunk] [reps]
                                                  [name=cutlist ...]
Default schedules (for the 11-chunk 1000-row/chunk=100 night):
  default   (stride logic; env unset)
  rem1      2,5,8,10   last cut leaves one chunk + mean for the pull
  dense     2,4,6,8,10 more, smaller parts (more latency events)
  rem0      2,5,8,11   remainder zero (final pull = mean + guards only)
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
CHUNK = int(sys.argv[2]) if len(sys.argv) > 2 else 100
REPS = int(sys.argv[3]) if len(sys.argv) > 3 else 8
NL = 35

SCHEDULES = {"default": None, "rem1": "2,5,8,10", "dense": "2,4,6,8,10",
             "rem0": "2,5,8,11"}
if len(sys.argv) > 4:
    SCHEDULES = {"default": None}
    for spec in sys.argv[4:]:
        name, _, cuts = spec.partition("=")
        SCHEDULES[name] = cuts or None


def main():
    import jax
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import process_batch
    from bench import build_rows

    cfg = GalacsiConfig()
    lbda = np.linspace(490, 930, NL)
    seeing, GL, L0, mask = build_rows(ROWS)

    def run(cuts):
        if cuts is None:
            os.environ.pop("MUSE_PSFR_PULL_AT", None)
        else:
            os.environ["MUSE_PSFR_PULL_AT"] = cuts
        try:
            t0 = time.perf_counter()
            process_batch(seeing, GL, L0, mask, lbda, npsflin=1, cfg=cfg,
                          chunk=CHUNK)
            return time.perf_counter() - t0
        finally:
            os.environ.pop("MUSE_PSFR_PULL_AT", None)

    t0 = time.perf_counter()
    run(None)  # compile both bucket executables (schedule-independent)
    print(json.dumps({"warmup_s": round(time.perf_counter() - t0, 1)}),
          flush=True)

    times = {k: [] for k in SCHEDULES}
    for rep in range(REPS):
        for name, cuts in SCHEDULES.items():
            dt = run(cuts)
            times[name].append(dt)
            print(json.dumps({"rep": rep, "schedule": name,
                              "t_s": round(dt, 4),
                              "rows_per_sec": round(ROWS / dt, 1)}),
                  flush=True)

    print(json.dumps({
        "rows": ROWS, "chunk": CHUNK, "device": str(jax.devices()[0]),
        **{f"{k}_best": round(ROWS / min(v), 1) for k, v in times.items()},
        **{f"{k}_median": round(ROWS / float(np.median(v)), 1)
           for k, v in times.items()},
        # paired-ratio medians vs default (robust against contention
        # drift within the session)
        **{f"{k}_vs_default_paired_median": round(float(np.median(
            [d / t for d, t in zip(times["default"], v)])), 3)
           for k, v in times.items() if k != "default"},
    }, indent=1))


if __name__ == "__main__":
    main()
