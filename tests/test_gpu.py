"""Checks that only mean something on an NVIDIA GPU.

Every test here is marked ``gpu`` and takes the ``gpu_device`` fixture,
so it skips on any other backend.  ``python chip_smoke.py`` runs them on
the card, inside its own process (``MUSE_PSFR_GPU_TESTS=1``).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_fft_mode_on_gpu(gpu_device):
    """cuFFT is there: the backend decision keeps the FFT path."""
    from muse_psfr_tpu import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import fft_available, resolve_fft_mode
    assert fft_available()
    cfg = GalacsiConfig()
    assert resolve_fft_mode(cfg) is cfg


def test_host_cpu_device_beside_gpu(gpu_device):
    """Host planning finds the CPU backend next to the GPU one."""
    from muse_psfr_tpu.utils.devices import host_cpu_device
    assert host_cpu_device().platform == "cpu"
    assert gpu_device.platform == "gpu"


def test_highest_matmul_is_float32_on_gpu(gpu_device):
    """``Precision.HIGHEST`` is true float32 on the card (TF32, with its
    10-bit mantissa, would be ~1e-3 relative here)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    b = rng.standard_normal((512, 512)).astype(np.float32)
    got = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b),
                                precision=jax.lax.Precision.HIGHEST))
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_compat_scope_is_float64_on_gpu(gpu_device):
    """The reference-compatible API runs float64 on the GPU."""
    import jax.numpy as jnp
    from muse_psfr_tpu.compat import _x64_context
    with _x64_context():
        x = jnp.ones(3, jnp.float64) * 2.0
        assert x.dtype == jnp.float64
        assert x.devices() == {gpu_device}


def test_chunked_zoom_path_matches_fft_path_on_gpu(gpu_device):
    """The GPU runs the wavelength-chunked zoom-DFT path (chunks of
    ``lambda_chunk`` with padding); it agrees with the FFT resampling."""
    import jax.numpy as jnp
    from muse_psfr_tpu.config import TINY_CONFIG
    from muse_psfr_tpu.otf import psf as P
    from muse_psfr_tpu.psd.model import simulate_psd, effective_wind_speed
    cfg = TINY_CONFIG
    lb = np.linspace(620.0, 900.0, 9)          # 9 = 7 + 2 padded
    assert P._wavelength_chunk(cfg, lb.size) == cfg.lambda_chunk
    h = (100, 10000)
    psd = simulate_psd(1.0, 0.7, 25.0, jnp.ones(4, cfg.dtype), h,
                       effective_wind_speed(h, cfg), 2, cfg)
    zoom = np.asarray(P.psf_cube(psd, lb, cfg))
    fft = np.asarray(P.psf_cube(psd, lb, cfg.with_(use_zoom_dft=False)))
    assert zoom.shape == (9, cfg.dimpsf, cfg.dimpsf)
    np.testing.assert_allclose(zoom, fft, atol=2e-6)
