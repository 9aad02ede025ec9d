"""The host CPU device used for host-side planning and float64 work."""

import jax


def host_cpu_device():
    """First local device of the CPU backend.

    Host planning (the correction-zone model behind the OTF-support
    bound) and the float64 FIT_MEAN refit run there whatever the default
    backend is.  A process started with ``JAX_PLATFORMS=cuda`` has no
    CPU backend, so this fails at once with what to do instead.
    """
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError as err:
        raise RuntimeError(
            "muse_psfr_tpu needs JAX's CPU backend for host-side planning "
            "next to the accelerator; leave JAX_PLATFORMS unset or set it "
            f"to 'cuda,cpu' (JAX said: {err})") from err

