"""Regenerate the golden batch-plan summaries pinned by
tests/test_batch_plan.py.

The plans are a pure function of (telemetry, wavelength grid, npsflin,
cfg, chunk) — see ``muse_psfr_tpu.parallel.batch.plan_batch`` — so they
are identical on every backend (the backend-resolved ``use_fft``
base field cancels out of the per-group config deltas).  Run from the
repo root after an INTENTIONAL planner change:

    python benchmarks/dump_plan.py

and commit the refreshed tests/data/golden_plan_*.json together with
the planner change and a CHANGELOG note.  An unintentional diff in
these files is a planner regression (VERDICT r4 item 6).
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from bench import build_rows  # noqa: E402
from muse_psfr_tpu.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu.parallel.batch import plan_batch  # noqa: E402

# the three driver workloads: bench night (100 rows, chunk 50), long
# night (1000 rows, chunk 100), 9-direction night (100 rows, chunk 44)
CASES = {
    "night100": dict(n=100, chunk=50, npsflin=1),
    "night1000": dict(n=1000, chunk=100, npsflin=1),
    "night100_npsflin3": dict(n=100, chunk=44, npsflin=3),
}


def plan_case(n, chunk, npsflin):
    for var in ("MUSE_PSFR_NO_TAIL", "MUSE_PSFR_NO_BLUE",
                "MUSE_PSFR_BLUE_TIERS"):
        assert var not in os.environ, f"unset {var} before dumping plans"
    seeing, GL, L0, mask = build_rows(n)
    lbda = np.linspace(490, 930, 35)
    plan = plan_batch(seeing, GL, L0, mask, lbda, npsflin=npsflin,
                      cfg=GalacsiConfig(), chunk=chunk)
    return plan.summary()


def main():
    outdir = os.path.join(ROOT, "tests", "data")
    for name, kw in CASES.items():
        path = os.path.join(outdir, f"golden_plan_{name}.json")
        summary = plan_case(**kw)
        with open(path, "w") as fh:
            json.dump(summary, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"{path}: {len(summary['groups'])} groups, "
              f"chunk {summary['chunk']}")


if __name__ == "__main__":
    main()
