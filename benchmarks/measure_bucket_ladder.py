"""Host-side admission ladder for a third (mid-size) OTF-support bucket.

A third S=512 bucket could save part of the full-window rows' zoom
cost — IF the full rows fit S=512.  This script measures the actual
admission: for each bench-night row,
the smallest 128-aligned window the host-side certifier
(:func:`muse_psfr_tpu.parallel.batch.rows_windowable`) admits.

Runs entirely on the host CPU backend (the certifier is the host-side
zone model + fitting-PSD envelopes; no accelerator, no pipeline
compile).

Usage: python benchmarks/measure_bucket_ladder.py [n_rows] [npsflin]
"""

import collections
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from muse_psfr_tpu.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu.parallel.batch import (default_support_bucket,  # noqa: E402
                                          rows_windowable)


def bench_rows(n):
    """The bench.py night telemetry (same seed and ranges)."""
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
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    npsflin = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    cfg = GalacsiConfig()
    seeing, GL, L0, mask = bench_rows(n)
    lb_max = 930.0

    base = default_support_bucket(cfg)
    ladder = [S for S in range(base, cfg.dim // 2, 128)]
    assigned = np.zeros(n, int)          # 0 = full window
    for S in ladder:
        ok = rows_windowable(seeing, GL, L0, mask, lb_max, cfg, S,
                             npsflin=npsflin)
        newly = ok & (assigned == 0)
        assigned[newly] = S
        print(f"S={S:4d}: {int(ok.sum()):4d}/{n} rows windowable "
              f"(cumulative)")
    hist = dict(sorted(collections.Counter(assigned).items()))
    print(f"npsflin={npsflin} minimal-bucket histogram "
          f"(0 = full window): {hist}")
    beyond = int(((assigned != 0) & (assigned != base)).sum())
    print(f"rows a mid-size bucket would move out of the full window: "
          f"{beyond}/{n} ({100.0 * beyond / n:.1f}%)")


if __name__ == "__main__":
    main()
