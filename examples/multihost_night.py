"""Process a night of SPARTA telemetry across SEVERAL HOSTS.

The batch layer shards telemetry rows over a global device mesh: across
the devices of each host, and across hosts via ``jax.distributed`` —
replacing the reference's single-node joblib process pool
(psfrec.py:1082-1083) with SPMD execution.  Every process calls
``process_batch`` with the SAME full telemetry; each computes only its
mesh shard, results are all-gathered, and every process returns the
complete night.

On a real multi-host deployment (e.g. several GPU nodes), run one copy
per host with the coordinator address, process count and process id
passed to ``init_multihost``:

    python examples/multihost_night.py worker

Standalone (this demo): no arguments — the script spawns two local
worker processes with 2 virtual CPU devices each (a 4-device global
mesh) and checks they produce identical results.
"""

import os
import subprocess
import sys

import numpy as np

TINY = bool(os.environ.get("MUSE_PSFR_TINY"))


def worker(coordinator=None, num_processes=None, process_id=None):
    import jax
    if TINY:
        # the tiny demo config computes in float64 (CPU)
        jax.config.update("jax_enable_x64", True)
    from muse_psfr_tpu.parallel.mesh import init_multihost
    from muse_psfr_tpu.parallel.batch import process_batch
    from muse_psfr_tpu.config import DEFAULT_CONFIG, TINY_CONFIG

    mesh = init_multihost(coordinator, num_processes, process_id)
    cfg = (TINY_CONFIG.with_(dtype="float64", fit_dtype="float64")
           if TINY else DEFAULT_CONFIG)

    rng = np.random.default_rng(7)
    n = 8 if TINY else 100
    seeing = rng.uniform(0.6, 1.4, n)
    GL = rng.uniform(0.3, 0.9, n)
    L0 = rng.uniform(10, 28, n)
    mask = np.ones((n, 4))
    lbda = np.linspace(490, 930, 3 if TINY else 35)

    fit, psf_mean, fit_mean = process_batch(
        seeing, GL, L0, mask, lbda, cfg=cfg,
        chunk=max(4, n // 4), mesh=mesh)
    print(f"process {jax.process_index()}/{jax.process_count()}: "
          f"night of {n} rows done on a {mesh.size}-device mesh; "
          f"fit {fit.shape}, mean PSF {psf_mean.shape}")
    return fit


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        # platform-configured multi-host run (coordinator from env)
        worker()
        return
    if len(sys.argv) > 1:
        # internal: spawned demo worker <id> <port>
        pid, port = int(sys.argv[1]), sys.argv[2]
        fit = worker(f"localhost:{port}", 2, pid)
        np.save(f"mh_demo_fit_{pid}.npy", fit)
        return

    # demo driver: 2 processes x 2 virtual CPU devices
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                        + env.get("XLA_FLAGS", ""))
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("MUSE_PSFR_TINY", "1")
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, here, str(i), str(port)],
                              env=env) for i in range(2)]
    for p in procs:
        p.wait(timeout=600)
        assert p.returncode == 0, "worker failed"
    a = np.load("mh_demo_fit_0.npy")
    b = np.load("mh_demo_fit_1.npy")
    assert np.array_equal(a, b), "processes disagree"
    print(f"wrote mh_demo_fit_0.npy / mh_demo_fit_1.npy "
          f"(identical, {a.shape})")


if __name__ == "__main__":
    main()
