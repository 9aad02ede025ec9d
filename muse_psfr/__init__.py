"""Drop-in import shim: ``import muse_psfr`` backed by the JAX framework.

Exposes the reference package's public namespace (see
``muse_psfr_tpu.compat``) so existing code and scripts keep working.
"""

from muse_psfr_tpu import __version__  # noqa: F401
from muse_psfr_tpu.compat import *  # noqa: F401,F403
from muse_psfr_tpu.compat import (  # noqa: F401
    MIN_L0, MAX_L0, compute_psf, compute_psf_from_sparta,
    create_sparta_table, fit_psf_with_polynom, plot_psf, radial_profile,
    simul_psd_wfm, psf_muse, psd_to_psf, dsp4muse, seeing2r01, pupil_mask,
    direction_perf, calc_var_from_psd, psd_fit, crop, interpolate,
    calc_mat_rec_glao_finale, calc_dsp_res_glao_finale, muse_intrinsic_psf,
    convolve_final_psf, fit_psf_cube,
)
from muse_psfr_tpu import cli  # noqa: F401
