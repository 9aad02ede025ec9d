"""Slope-method device time of each group executable, blue vs plain.

Isolates the blue-segment window split's per-chunk device cost from
the night-level dispatch/pull overheads: plans the bench night both
ways (MUSE_PSFR_NO_BLUE toggled at plan time), then times each group's
`_fit_chunk` executable with the slope method (N enqueues + one tiny
sync pull, difference of two N).  The night-level A/B is
measure_blue_split.py; for device time per stage prefer a profiler
trace (benchmarks/profile_stages.py).
"""
import json, os, sys, time
import numpy as np
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT); sys.path.insert(0, os.path.join(_ROOT, "benchmarks"))
from bench import build_rows
import jax, jax.numpy as jnp
from muse_psfr_tpu.config import GalacsiConfig
from muse_psfr_tpu.parallel import batch as B

rows, chunk, npsflin = 1000, 100, 1
lbda = np.linspace(490, 930, 35)
seeing, GL, L0, mask = build_rows(rows)
(cfg_r, groups, chunk_n, table, lbda_j, h_t, ws, shd, npixc_j) = \
    B._plan_batch(seeing, GL, L0, mask, lbda, (100, 10000), npsflin,
                  GalacsiConfig(), chunk, None)
os.environ["MUSE_PSFR_NO_BLUE"] = "1"
groups_plain = B._plan_batch(seeing, GL, L0, mask, lbda, (100, 10000),
                             npsflin, GalacsiConfig(), chunk, None)[1]
del os.environ["MUSE_PSFR_NO_BLUE"]

def slope(fn, reps=5, n_hi=6):
    fn()
    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)
        # tiny sync pull
        float(np.asarray(out[2]))
        return time.perf_counter() - t0
    return float(np.median([(run(n_hi) - run(1)) / (n_hi - 1)
                            for _ in range(reps)]))

for label, gs in (("blue", groups), ("plain", groups_plain)):
    for gcfg, gidx in gs:
        gt = table[gidx][:chunk_n]
        if gt.shape[0] < chunk_n:
            gt = np.concatenate([gt, np.repeat(gt[-1:], chunk_n - gt.shape[0], 0)])
        t = jnp.asarray(gt, gcfg.dtype)
        nv = jnp.asarray(np.int32(chunk_n))
        f = lambda t=t, nv=nv, gcfg=gcfg: B._fit_chunk(
            t, nv, lbda_j, npixc_j, h_t, ws, npsflin, gcfg, "float32")
        dt = slope(f)
        print(json.dumps({"variant": label, "support": gcfg.otf_support,
                          "blue": gcfg.otf_blue, "rows": int(gidx.size),
                          "ms_per_chunk": round(1e3 * dt, 2),
                          "ms_per_row": round(1e3 * dt / chunk_n, 4)}),
              flush=True)
