"""A/B: async-issued final pull (pull_packed copy_to_host_async) vs the
plain blocking np.asarray, on the real night workload.

The final packed pull cannot START its byte transfer before the last
chunk finishes (its payload depends on every chunk), but the transfer
COMMAND can be issued while compute is still in flight — pull_packed
now calls copy_to_host_async before blocking, so the bytes flow the
moment the result materialises instead of after a ready-notification
round trip.  This measures whether that round trip is being paid.

Usage: python benchmarks/measure_async_final.py [rows] [chunk] [reps] [npsflin]
Alternates the two modes (MUSE_PSFR_NO_ASYNC_FINAL) rep by rep in one
process, both warmed; reports per-mode best/median and the paired ratio.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

rows = int(sys.argv[1]) if len(sys.argv) > 1 else 100
chunk = int(sys.argv[2]) if len(sys.argv) > 2 else 50
reps = int(sys.argv[3]) if len(sys.argv) > 3 else 8
npsflin = int(sys.argv[4]) if len(sys.argv) > 4 else 1

from bench import build_rows  # noqa: E402
from muse_psfr_tpu.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu.parallel.batch import process_batch  # noqa: E402

cfg = GalacsiConfig()
lbda = np.linspace(490, 930, 35)
seeing, GL, L0, mask = build_rows(rows)


def night():
    t0 = time.perf_counter()
    process_batch(seeing, GL, L0, mask, lbda, npsflin=npsflin, cfg=cfg,
                  chunk=chunk)
    return time.perf_counter() - t0


# warm both modes (identical executables; only host-side pull behaviour
# differs, but run each once so any lazy state is settled)
os.environ.pop("MUSE_PSFR_NO_ASYNC_FINAL", None)
night()
os.environ["MUSE_PSFR_NO_ASYNC_FINAL"] = "1"
night()

t_async, t_sync = [], []
for r in range(reps):
    os.environ.pop("MUSE_PSFR_NO_ASYNC_FINAL", None)
    t_async.append(night())
    os.environ["MUSE_PSFR_NO_ASYNC_FINAL"] = "1"
    t_sync.append(night())
    print(f"rep {r}: async {t_async[-1]*1e3:7.1f} ms   "
          f"sync {t_sync[-1]*1e3:7.1f} ms   "
          f"ratio {t_sync[-1]/t_async[-1]:.3f}", flush=True)

os.environ.pop("MUSE_PSFR_NO_ASYNC_FINAL", None)
ratios = sorted(s / a for s, a in zip(t_sync, t_async))
med = ratios[len(ratios) // 2]
print(f"\nrows={rows} chunk={chunk} npsflin={npsflin} reps={reps}")
print(f"async: best {min(t_async)*1e3:.1f} ms ({rows/min(t_async):.0f} rows/s)"
      f"  median {sorted(t_async)[reps//2]*1e3:.1f} ms")
print(f"sync:  best {min(t_sync)*1e3:.1f} ms ({rows/min(t_sync):.0f} rows/s)"
      f"  median {sorted(t_sync)[reps//2]*1e3:.1f} ms")
print(f"paired ratio (sync/async) median {med:.3f}  "
      f"range [{ratios[0]:.3f}, {ratios[-1]:.3f}]  "
      f">1 means async wins")
