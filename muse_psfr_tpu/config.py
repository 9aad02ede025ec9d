"""Static configuration of the GALACSI WFM ground-layer AO system.

The reference implementation hardcodes these constants inside
``simul_psd_wfm`` (reference psfrec.py:70-104) and scatters a few more magic
numbers through ``psf_muse``/``convolve_final_psf`` (psfrec.py:655-659, 899).
Here they live in one frozen, hashable dataclass so the whole pipeline can be
traced once per configuration by ``jax.jit`` (the config is a static
argument: every field is a Python scalar, and derived grids are rebuilt at
trace time).

Changing ``dim``/``dim_pup`` gives the high-resolution (2048^2) and the tiny
multi-chip dry-run configurations with the same code path.
"""

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class GalacsiConfig:
    # --- telescope / AO system (reference psfrec.py:70-104) ---------------
    dpup: float = 8.0          # telescope diameter [m]
    occ: float = 0.14          # central obscuration (linear fraction)
    alt_dm: float = 1.0        # DM conjugation altitude [m]
    h_sodium: float = 90000.0  # sodium layer altitude [m] (debug only)
    lambda_ref: float = 0.5    # PSD reference wavelength [um]
    nact: float = 24.0         # linear number of DM actuators
    nsspup: float = 24.0       # linear number of WFS subapertures
    fsamp: float = 1000.0      # WFS sampling frequency [Hz]
    delay_ms: float = 2.5      # loop delay (readout + RTC) [ms]
    sep_lgs: float = 63.0      # LGS radial separation [arcsec]
    noise_lgs2: float = 1.0    # WFS noise a priori [rad^2]
    wind_speed: float = 12.5   # layer wind speed [m/s] (see int-h quirk)
    wind_dir_0: float = 0.628163   # layer 0 wind direction [rad] (pinned)
    wind_dir_1: float = -0.326497  # layer 1 wind direction [rad] (pinned)
    lse: bool = True           # LSE reconstructor (False -> MAP prior)

    # --- numerical grids (reference psfrec.py:103, 655-659, 899) ----------
    dim: int = 1280            # full PSD / OTF grid [px]
    dim_pup: int = 40          # correction-zone pupil size [px]
    dimpsf: int = 40           # output PSF cube size [px]
    pixscale: float = 0.2      # output PSF pixel scale [arcsec/px]
    samp: float = 2.0          # PSF sampling (Nyquist)
    lambda_chunk: int = 7      # wavelengths processed per OTF step (a
                               # serial per-wavelength loop leaves the
                               # device underused); each step holds
                               # ~rows*lambda_chunk*ndir*window floats

    # --- telemetry validity limits (reference psfrec.py:30-31) ------------
    min_l0: float = 8.0        # minimum valid outer scale [m]
    max_l0: float = 30.0       # maximum valid outer scale [m]

    # --- compute policy ----------------------------------------------------
    dtype: str = "float32"     # compute dtype for the heavy stages
    fit_dtype: str = "float32" # dtype of the Moffat LM solve
    use_zoom_dft: bool = True  # zoom-DFT matmuls instead of a full IFFT
    use_fft: bool = True       # device FFTs for the structure function /
                               # convolutions; False = DFT-matmul path
                               # (exact, FFT-free; an explicit user
                               # choice, never selected automatically on
                               # a backend that has FFTs)
    matmul_precision: str = "highest"  # precision of every float32 matmul
                               # of the OTF/zoom transforms: "highest" =
                               # true float32 (4.2e-8 rms vs the f64
                               # oracle on CPU); "high"/"default" let
                               # the backend use reduced-precision
                               # passes (TF32 on NVIDIA GPUs), which
                               # can exceed the 1e-5 rms budget
    conv_precision: str = "highest"  # same, for the final-PSF
                               # convolution DFT matmuls of the FFT-free
                               # path (tip-tilt + instrument Moffat)
    use_dphi_split: bool = True  # linearity split of the structure
                               # function: the fitting-PSD transform is
                               # precomputed per config (Taylor basis in
                               # 1/L0^2, certified <=1e-7 relative for
                               # L0 >= dphi_split_l0_min) and only the
                               # centrally-supported correction-zone block
                               # is transformed per row (~16x fewer FLOPs).
                               # The batch layer falls back to the exact
                               # full transform when any row's L0 is below
                               # dphi_split_l0_min.
    dphi_split_degree: int = 5  # certified 8.9e-9 relative at l0_min=2.5
                               # (fc=1.5); two extra precomputed basis
                               # planes per row (~negligible next to the
                               # zoom stage).  Raised from 3/5.0 so
                               # synthetic low-L0 sweep points (the valid
                               # telemetry range is L0 in [8, 30]) stay on
                               # the fast split path instead of spilling
                               # into the exact-transform executable.
    dphi_split_l0_min: float = 2.5
    use_sym_fold: bool = True  # point-symmetry fold of the OTF-side
                               # contractions: PSDs and the pupil
                               # autocorrelation are transforms of real
                               # fields, so every OTF-side array satisfies
                               # G[i, j] = G[(N-i)%N, (N-j)%N]; the final
                               # zoom contraction's per-column terms are
                               # then equal in mirrored pairs and only
                               # columns 0..N/2 need computing (mirrors
                               # get weight 2).  Cuts the dominant exp +
                               # zoom-matmul work ~1.67x (10 -> 6 column
                               # tiles at dim=1280) and the structure-
                               # function transform ~2.5x.  Exact up to
                               # float-noise symmetrisation (measured
                               # against the f64 oracle); requires
                               # dim % 256 == 0 and the zoom-DFT path,
                               # silently off otherwise.
    otf_support: int = 0       # OTF support inf-radius [px]: the system
                               # OTF exp(-Dphi/2)*dl decays below any
                               # threshold well inside the grid (the
                               # residual structure function saturates at
                               # 2*sigma_res^2), so the zoom/dphi
                               # contractions only compute the centred
                               # block rows [c-S, c+S) x cols [c-S,
                               # c+128) under the fold.  0 = full half
                               # grid; the batch layer sets it per batch
                               # from a host-side rigorous bound on the
                               # least-damped row (see
                               # parallel/batch.py:estimate_otf_support).
                               # Must be a multiple of 128 (tile-aligned);
                               # each distinct value is a separate
                               # compilation of the pipeline.
    otf_blue: tuple = None     # optional blue-segment window split
                               # (nb, S_blue): the first nb wavelengths
                               # (which must be the BLUEST — the batch
                               # planner only engages it on ascending
                               # grids) run the whole OTF/zoom machinery
                               # on the smaller centred sub-window
                               # S_blue < otf_window S, the rest on the
                               # bucket window.  The structure function
                               # is wavelength-free but the damping
                               # exponent scales as (2pi/lambda)^2, so
                               # blue planes admit much smaller windows
                               # than the band maximum that sizes the
                               # per-row bucket: on the bench-night
                               # telemetry 100% of S=256-bucket rows
                               # admit S=128 for lambda <= 658 nm
                               # (area 1/3) and ~72% of full-window
                               # rows admit S=256 there (area 1/5) —
                               # benchmarks/measure_perlambda_window.py.
                               # Set per GROUP by the batch planner from
                               # the host-side admission model
                               # (parallel/batch.py:rows_windowable at
                               # max(lambda[:nb])), backstopped by the
                               # extended device window guard; each
                               # distinct value is a separate pipeline
                               # compilation.  None = single window.
    blue_tiers: int = 0        # max blue subgroups the planner may form
                               # per support bucket (a LADDER of
                               # descending segment lengths — admission
                               # is graded in nb, so strong admitters
                               # can run a longer blue segment than a
                               # single group-wide nb allows).  Each
                               # tier is one more compiled executable,
                               # guarded by the same 4/3 score rule as
                               # the single-subgroup split; env override
                               # MUSE_PSFR_BLUE_TIERS.  1 = one blue
                               # subgroup per bucket; 0 = AUTO: 2 tiers
                               # for multi-direction runs (ndir >= 9,
                               # where the exp area is largest), 1
                               # otherwise.

    # --- derived ------------------------------------------------------------
    @property
    def dimall(self) -> int:
        """Correction-zone PSD grid size (2x the pupil, psfrec.py:138)."""
        return 2 * self.dim_pup

    @property
    def pitch(self) -> float:
        """DM inter-actuator distance [m] (psfrec.py:132) — sets the
        fitting-PSD cutoff ``fc``.  The WFS transfer functions use
        :attr:`wfs_pitch` (the reference keeps the two separate:
        psfrec.py:578 vs :582; its reconstructor's ``pitchs_dm``
        parameter is dead)."""
        return self.dpup / self.nact

    @property
    def wfs_pitch(self) -> float:
        """WFS subaperture pitch ``dpup/nsspup`` [m] (psfrec.py:578) —
        drives the WFS transfer-function sinc response and cutoffs.
        Equal to :attr:`pitch` in the GALACSI default (nsspup == nact ==
        24, psfrec.py:77-78)."""
        return self.dpup / self.nsspup

    @property
    def fc(self) -> float:
        """AO fitting cutoff frequency 1/(2*pitch) [1/m]."""
        return 1.0 / (2.0 * self.pitch)

    @property
    def fold_ncols(self):
        """OTF-grid columns actually computed under the symmetry fold.

        ``dim//2 + 128`` (columns 0..dim/2 rounded up to a full 128-lane
        tile; the pad columns carry zero fold weight), or ``None`` when
        the fold does not apply (no zoom-DFT resampling, or ``dim`` not a
        multiple of 256 — the fold needs dim/2 tile-aligned).
        """
        if not (self.use_sym_fold and self.use_zoom_dft
                and self.dim % 256 == 0):
            return None
        return min(self.dim, self.dim // 2 + 128)

    @property
    def otf_window(self):
        """(row_lo, S): the computed OTF block under the symmetry fold.

        Rows ``[c-S, c+S)``, columns ``[c-S, c+128)`` of the full
        (dim, dim) OTF grid, where ``c = dim//2`` and ``S`` is
        ``otf_support`` (full half grid when 0).  ``None`` when the fold
        is off (full grid, no windowing).
        """
        if self.fold_ncols is None:
            return None
        c = self.dim // 2
        S = min(self.otf_support, c) if self.otf_support else c
        if S % 128 != 0 or S <= 0:
            raise ValueError(f"otf_support must be a positive multiple "
                             f"of 128, got {self.otf_support}")
        return (c - S, S)

    @property
    def npup(self) -> int:
        """Pupil support on the full grid [px] (psfrec.py:656)."""
        return self.dim // 2

    @property
    def cdtype(self):
        """Complex dtype matching ``dtype``."""
        return "complex64" if self.dtype == "float32" else "complex128"

    def with_(self, **kw) -> "GalacsiConfig":
        return replace(self, **kw)


DEFAULT_CONFIG = GalacsiConfig()

#: small configuration for multi-chip dry runs and fast unit tests:
#: same code path, tiny grids, red wavelengths only (so the lambda-dependent
#: crop fits inside the small grid).
TINY_CONFIG = GalacsiConfig(dim=256, dim_pup=16, dimpsf=8)
