"""Alternating A/B of the batch chunk size on the same night.

Every chunk is one command dispatch; at 1000 rows / chunk=50 the night
issues 20 chunk programs, of which only part of the enqueue cost hides
under device compute.  A larger chunk halves the dispatch count (and the pull parts) at the
price of coarser guard-redo granularity and one more executable shape.
The 1000-row bench night splits ~60/40 into the windowed/full buckets,
so chunks of 50, 100, and 200 all pad zero rows.

Usage: python benchmarks/measure_chunk.py [rows] [reps] [chunks...]
       python benchmarks/measure_chunk.py grid [reps] [chunks...]
       python benchmarks/measure_chunk.py tail [rows] [reps] [chunk] [npsflin]
Defaults: 1000 rows, 6 reps, chunks 50 100.  ``grid`` swaps the night
telemetry for the 32x32 (seeing, GL) condition-sweep grid (1024 rows,
chunk defaults 32 64) to set api.condition_sweep's chunk policy.
``tail`` A/Bs the tail-chunk policy (MUSE_PSFR_NO_TAIL) at one chunk
size; the chunk-vs-chunk default mode reads MUSE_PSFR_BENCH_NPSFLIN
for the 9-direction variant instead of a positional arg.
All variants are warmed first, then timed alternating in one process,
so that a small effect reads against the run-to-run spread.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import process_batch
    from bench import build_rows

    cfg = GalacsiConfig()
    lbda = np.linspace(490, 930, 35)
    if len(sys.argv) > 1 and sys.argv[1] == "tail":
        # A/B the tail-chunk policy (MUSE_PSFR_NO_TAIL) at one chunk size
        rows = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
        reps = int(sys.argv[3]) if len(sys.argv) > 3 else 8
        chunk = int(sys.argv[4]) if len(sys.argv) > 4 else 100
        npsflin = int(sys.argv[5]) if len(sys.argv) > 5 else 1
        seeing, GL, L0, mask = build_rows(rows)
        variants = {"tail": {}, "no_tail": {"MUSE_PSFR_NO_TAIL": "1"}}
        times = {k: [] for k in variants}

        def run(env):
            old = {k: os.environ.pop(k, None) for k in
                   ("MUSE_PSFR_NO_TAIL",)}
            os.environ.update(env)
            try:
                t0 = time.perf_counter()
                process_batch(seeing, GL, L0, mask, lbda, npsflin=npsflin,
                              cfg=cfg, chunk=chunk)
                return time.perf_counter() - t0
            finally:
                for k, v in old.items():
                    os.environ.pop(k, None)
                    if v is not None:
                        os.environ[k] = v

        for name, env in variants.items():
            print(json.dumps({"warmup": name, "s": round(run(env), 1)}),
                  flush=True)
        for rep in range(reps):
            for name, env in variants.items():
                dt = run(env)
                times[name].append(dt)
                print(json.dumps({"rep": rep, "cfg": name,
                                  "t_s": round(dt, 4),
                                  "rows_per_sec": round(rows / dt, 1)}),
                      flush=True)
        print(json.dumps({
            "rows": rows, "chunk": chunk, "npsflin": npsflin,
            "device": str(jax.devices()[0]),
            **{f"{k}_best": round(rows / min(v), 1)
               for k, v in times.items()},
            **{f"{k}_median": round(rows / float(np.median(v)), 1)
               for k, v in times.items()},
        }, indent=1))
        return
    if len(sys.argv) > 1 and sys.argv[1] == "grid":
        # the 32x32 (seeing, GL) condition-sweep telemetry (~68%
        # windowable vs the night's ~60%) — chunk policy for
        # api.condition_sweep
        reps = int(sys.argv[2]) if len(sys.argv) > 2 else 6
        chunks = [int(c) for c in sys.argv[3:]] or [32, 64]
        ss, gg = np.meshgrid(np.linspace(0.6, 1.6, 32),
                             np.linspace(0.3, 0.9, 32), indexing="ij")
        seeing, GL = ss.ravel(), gg.ravel()
        L0 = np.full(seeing.size, 25.0)
        mask = np.ones((seeing.size, 4))
        rows = seeing.size
    else:
        rows = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
        reps = int(sys.argv[2]) if len(sys.argv) > 2 else 6
        chunks = [int(c) for c in sys.argv[3:]] or [50, 100]
        seeing, GL, L0, mask = build_rows(rows)

    # chunk-vs-chunk comparisons honour MUSE_PSFR_BENCH_NPSFLIN (the
    # 9-direction night's chunk policy needs its own A/B: its full
    # bucket is device-bound, so padding does not hide under the pull)
    npsflin = int(os.environ.get("MUSE_PSFR_BENCH_NPSFLIN", "1"))

    for c in chunks:
        t0 = time.perf_counter()
        process_batch(seeing, GL, L0, mask, lbda, npsflin=npsflin, cfg=cfg,
                      chunk=c)
        print(json.dumps({"warmup_chunk": c,
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)
    times = {c: [] for c in chunks}
    for rep in range(reps):
        for c in chunks:
            t0 = time.perf_counter()
            process_batch(seeing, GL, L0, mask, lbda, npsflin=npsflin,
                          cfg=cfg, chunk=c)
            dt = time.perf_counter() - t0
            times[c].append(dt)
            print(json.dumps({"rep": rep, "chunk": c, "t_s": round(dt, 4),
                              "rows_per_sec": round(rows / dt, 1)}),
                  flush=True)
    print(json.dumps({
        "rows": rows, "npsflin": npsflin,
        "device": str(jax.devices()[0]),
        **{f"chunk{c}_best": round(rows / min(v), 1)
           for c, v in times.items()},
        **{f"chunk{c}_median": round(rows / float(np.median(v)), 1)
           for c, v in times.items()},
    }, indent=1))


if __name__ == "__main__":
    main()
