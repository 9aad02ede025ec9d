"""muse_psfr_tpu — accelerator-native PSF reconstruction for MUSE WFM-AO.

A from-scratch JAX/XLA reimplementation of the capabilities of the
``muse-psfr`` package (GLAO PSF reconstruction from SPARTA seeing /
ground-layer-fraction / outer-scale telemetry, Fusco et al. 2020): the
Fourier-domain residual-PSD model, the PSD->OTF->PSF chain, tip-tilt and
instrument convolutions, and batched Moffat fitting run as one jitted,
vmapped, mesh-shardable program; FITS I/O and the ``muse-psfr`` CLI are
preserved exactly.
"""

__version__ = "2.0.0"

from .utils.log import setup_logging as _setup_logging

_setup_logging()

from .config import GalacsiConfig, DEFAULT_CONFIG, TINY_CONFIG  # noqa: E402
from .api import (  # noqa: E402
    compute_psf,
    compute_psf_from_sparta,
    create_sparta_table,
    fit_psf_with_polynom,
    fit_table_from_arrays,
    MIN_L0,
    MAX_L0,
)
from .fit.moffat_fit import fit_moffat_cube  # noqa: E402
from .io.fits import (  # noqa: E402
    HDUList, PrimaryHDU, ImageHDU, BinTableHDU, fits_open,
)
from .io.table import FitTable  # noqa: E402
from .plotting import plot_psf, radial_profile  # noqa: E402
from .psd.model import simulate_psd, seeing_to_r0  # noqa: E402
from .otf.psf import psf_cube, pupil_otf  # noqa: E402
from .otf.convolve import convolve_final  # noqa: E402
from .parallel.batch import (  # noqa: E402
    reconstruct_batch, process_batch, default_mesh, fft_available,
)
from .api import condition_sweep, save_sweep  # noqa: E402

__all__ = [
    "GalacsiConfig", "DEFAULT_CONFIG", "TINY_CONFIG",
    "compute_psf", "compute_psf_from_sparta", "create_sparta_table",
    "fit_psf_with_polynom", "fit_table_from_arrays", "fit_moffat_cube",
    "MIN_L0", "MAX_L0",
    "HDUList", "PrimaryHDU", "ImageHDU", "BinTableHDU", "fits_open",
    "FitTable", "plot_psf", "radial_profile",
    "simulate_psd", "seeing_to_r0", "psf_cube", "pupil_otf",
    "convolve_final", "reconstruct_batch", "process_batch",
    "default_mesh", "fft_available", "condition_sweep", "save_sweep",
    "__version__",
]
