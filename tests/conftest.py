"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices (for mesh/sharding
tests) and float64 enabled (for oracle-parity tests).  This must happen
before JAX initialises its backends.

With ``MUSE_PSFR_GPU_TESTS=1`` (set by ``chip_smoke.py``, which runs the
tests marked ``gpu`` inside its own process on the card) the backend is
left as it is: JAX's default device is then the GPU.
"""

import os
import sys

import pytest

if not os.environ.get("MUSE_PSFR_GPU_TESTS"):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu_device():
    """JAX's default device, which must be an NVIDIA GPU: tests that use
    this fixture skip anywhere else (decided here, at run time)."""
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's default device is "
                    f"{d.platform!r} (run them on the card with "
                    f"`python chip_smoke.py`)")
    return d
