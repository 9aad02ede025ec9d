"""Headline benchmark: SPARTA rows/sec for the full-night workload.

Workload (BASELINE.json): ~100 telemetry rows x 35 MUSE wavelengths, 4 LGS,
full reconstruction (residual-PSD model -> OTF/PSF chain -> tip-tilt +
instrument convolution) plus the per-wavelength circular Moffat fit, on one
chip.  Accuracy is tracked as the rms of the pinned-condition row against
the committed float64 oracle PSF cube.

Baseline: the reference implementation cannot run here (mpdaf/astropy are
not installed), so the float64 NumPy oracle — verified to <1e-8 against the
reference and following its per-(row, lambda) FFT structure — is timed as
the reference-cost proxy, scaled by the host core count (the reference
parallelises rows across cores with joblib).  The measurement is cached in
``benchmarks/baseline_cache.json``.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_ROWS = int(os.environ.get("BENCH_ROWS", "100"))
NL = 35
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "benchmarks", "baseline_cache.json")


def measure_baseline():
    """Reference-cost proxy: float64 oracle, one row x 35 lambda."""
    if os.path.exists(CACHE):
        with open(CACHE) as fh:
            info = json.load(fh)
        # only the per-row time is cached; rescale by this host's cores
        ncpu = os.cpu_count() or 1
        info["ncpu"] = ncpu
        info["rows_per_sec"] = ncpu / info["t_row_s"]
        return info
    from benchmarks.oracle_numpy import compute_psf_oracle
    lbda = np.linspace(490, 930, NL)
    t0 = time.perf_counter()
    compute_psf_oracle(lbda, 1.0, 0.7, 25.0)
    t_row = time.perf_counter() - t0
    ncpu = os.cpu_count() or 1
    info = {"t_row_s": t_row, "ncpu": ncpu,
            "rows_per_sec": ncpu / t_row}
    os.makedirs(os.path.dirname(CACHE), exist_ok=True)
    with open(CACHE, "w") as fh:
        json.dump(info, fh)
    return info


def build_rows(n):
    """Realistic full-night telemetry: row 0 pinned to the golden
    condition, the rest spread over observed ranges, ~10% in 3-laser mode.
    """
    rng = np.random.default_rng(20260816)
    seeing = rng.uniform(0.6, 1.6, n)
    GL = rng.uniform(0.3, 0.9, n)
    L0 = rng.uniform(9.0, 29.0, n)
    mask = np.ones((n, 4))
    mask[rng.random(n) < 0.1, 3] = 0.0
    seeing[0], GL[0], L0[0] = 1.0, 0.7, 25.0
    mask[0] = 1.0
    return seeing, GL, L0, mask


def main():
    baseline = measure_baseline()

    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import process_batch
    from benchmarks.device_label import device_label

    # the batch layer buckets rows by OTF support internally (a fixed
    # reduced bucket + full window -> at most two compiled variants,
    # shared by the timed night and the accuracy sub-batch)
    cfg = GalacsiConfig()
    lbda = np.linspace(490, 930, NL)
    seeing, GL, L0, mask = build_rows(N_ROWS)
    chunk = int(os.environ.get("BENCH_CHUNK",
                               "100" if N_ROWS >= 200 else "50"))

    def run(n):
        # process_batch pulls what a user consumes (per-row fit params +
        # the mean PSF + its fit) in one packed transfer internally
        return process_batch(seeing[:n], GL[:n], L0[:n], mask[:n], lbda,
                             npsflin=1, cfg=cfg, chunk=chunk)

    # warmup / compile at the full workload shape
    t0 = time.perf_counter()
    run(N_ROWS)
    compile_s = time.perf_counter() - t0

    n_reps = int(os.environ.get("BENCH_REPS", "5"))
    times = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        run(N_ROWS)
        times.append(time.perf_counter() - t0)
    elapsed = min(times)
    rows_per_sec = N_ROWS / elapsed

    # accuracy: reconstruct the first chunk again and compare the pinned
    # row 0 to the committed float64 oracle golden cube
    from muse_psfr_tpu.parallel.batch import reconstruct_batch, plan_batch
    n0 = min(chunk, N_ROWS)
    # which plan variant the accuracy row takes (the golden row is
    # blue-admitted on the bench night: the rms covers the blue path)
    acc_plan = plan_batch(seeing[:n0], GL[:n0], L0[:n0], mask[:n0], lbda,
                          npsflin=1, cfg=cfg, chunk=chunk)
    g0 = next(g for g in acc_plan.groups if 0 in g.rows.tolist())
    row0_plan = {"otf_support": int(g0.cfg.otf_support),
                 "otf_blue": (list(map(int, g0.cfg.otf_blue))
                              if g0.cfg.otf_blue else None)}
    psf0 = reconstruct_batch(seeing[:n0], GL[:n0], L0[:n0], mask[:n0], lbda,
                             npsflin=1, cfg=cfg, chunk=chunk)[0]
    golden = np.load(os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "tests", "data", "golden_psf_35l_s1.0_gl0.7_l025.npy"))
    rms = float(np.sqrt(np.mean((psf0.astype(np.float64) - golden) ** 2)))

    print(json.dumps({
        "metric": "sparta_rows_per_sec",
        "value": rows_per_sec,
        "unit": "rows/s",
        "vs_baseline": rows_per_sec / baseline["rows_per_sec"],
        "rows": N_ROWS,
        "nl": NL,
        "elapsed_s": elapsed,
        "times_s": times,
        "compile_s": compile_s,
        "rms_vs_f64_oracle": rms,
        "row0_plan": row0_plan,
        "baseline_rows_per_sec": baseline["rows_per_sec"],
        "device": device_label(),
        "dtype": cfg.dtype,
    }))


if __name__ == "__main__":
    main()
