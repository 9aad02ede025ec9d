"""Night-level A/B of the blue-segment OTF window split (cfg.otf_blue).

The planner (`parallel/batch.py:_blue_split_plan`) runs the bluest
wavelengths of each support bucket on a half-bucket window when the
host admission model certifies it (ceiling analysis:
benchmarks/measure_perlambda_window.py).  This
measures the end-to-end effect with alternating reps in one process —
the blue and plain group configs are distinct jit keys, so both
executable sets stay warm — toggled via the MUSE_PSFR_NO_BLUE kill
switch at plan time.

Usage: python benchmarks/measure_blue_split.py plan [rows] [npsflin] \
              [chunk]
       python benchmarks/measure_blue_split.py night [rows] [chunk] \
              [reps] [npsflin]

``plan`` prints the groups the planner forms for the bench night
(which nb/S_blue engaged, subgroup sizes) without touching the device.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _rows(n):
    from bench import build_rows
    return build_rows(n)


def plan():
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import _plan_batch
    rows = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    npsflin = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    chunk = int(sys.argv[4]) if len(sys.argv) > 4 else 100
    seeing, GL, L0, mask = _rows(rows)
    lbda = np.linspace(490, 930, 35)
    groups = _plan_batch(seeing, GL, L0, mask, lbda, (100, 10000),
                         npsflin, GalacsiConfig(), chunk, None)[1]
    for gcfg, gidx in groups:
        print(json.dumps({
            "otf_support": gcfg.otf_support,
            "otf_blue": gcfg.otf_blue,
            "rows": int(gidx.size),
            "share_pct": round(100.0 * gidx.size / rows, 1)}))


def night():
    import jax
    from muse_psfr_tpu.parallel.batch import process_batch
    rows = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else 100
    reps = int(sys.argv[4]) if len(sys.argv) > 4 else 6
    npsflin = int(sys.argv[5]) if len(sys.argv) > 5 else 1
    lbda = np.linspace(490, 930, 35)
    seeing, GL, L0, mask = _rows(rows)

    def run(blue):
        if blue:
            os.environ.pop("MUSE_PSFR_NO_BLUE", None)
        else:
            os.environ["MUSE_PSFR_NO_BLUE"] = "1"
        t0 = time.perf_counter()
        process_batch(seeing, GL, L0, mask, lbda, npsflin=npsflin,
                      chunk=chunk)
        return time.perf_counter() - t0

    times = {"blue": [], "plain": []}
    for name, blue in (("blue", True), ("plain", False)):
        print(json.dumps({"warmup": name, "s": round(run(blue), 1)}),
              flush=True)
    for rep in range(reps):
        for name, blue in (("blue", True), ("plain", False)):
            dt = run(blue)
            times[name].append(dt)
            print(json.dumps({"rep": rep, "variant": name,
                              "t_s": round(dt, 4),
                              "rows_per_sec": round(rows / dt, 1)}),
                  flush=True)
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(json.dumps({
        "rows": rows, "chunk": chunk, "reps": reps, "npsflin": npsflin,
        "device": str(jax.devices()[0]),
        "median_rows_per_sec": {k: round(rows / m, 1)
                                for k, m in med.items()},
        "best_rows_per_sec": {k: round(rows / min(v), 1)
                              for k, v in times.items()},
        "speedup_median": round(med["plain"] / med["blue"], 3),
        "paired_ratios": [round(p / b, 3) for b, p in
                          zip(times["blue"], times["plain"])],
    }, indent=1))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "plan":
        plan()
    else:
        night()
