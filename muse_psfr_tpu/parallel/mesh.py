"""Device-mesh helpers: single-host meshes and multi-host setup.

The workload's only parallel axis is data parallelism over telemetry work
items (SURVEY.md §5): there is no sequence/tensor dimension worth
splitting (a 2048^2 complex64 FFT fits easily in one device's memory),
so scaling is a 1-D mesh over rows — across the devices of one host
(all-to-all NVLink on a multi-GPU node), and across hosts via
``jax.distributed``.
"""

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROWS = "rows"


def default_mesh(devices=None):
    """1-D mesh over the given (default: all addressable) devices."""
    devs = np.array(devices if devices is not None else jax.devices())
    return Mesh(devs, axis_names=(ROWS,))


def rows_sharding(mesh):
    """NamedSharding placing the leading (row) axis across the mesh."""
    return NamedSharding(mesh, P(ROWS))


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None):
    """Initialise multi-host execution (one process per host).

    Call once at program start on every host, then build the global mesh
    with :func:`default_mesh` — ``jax.devices()`` spans all hosts
    afterwards and the batch layer shards rows globally.  Pass the
    coordinator address (``host:port`` of process 0), the process count
    and this process's id; they may be omitted only under a cluster
    environment that ``jax.distributed`` configures itself from.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
    return default_mesh()
