"""Batched / sharded PSF reconstruction over SPARTA work items.

The reference parallelises over telemetry rows with a joblib process pool
(reference psfrec.py:1082-1083) — embarrassing data parallelism with no
inter-worker communication.  Here work items (seeing, GL, L0,
guide-star mask) become a batch axis of one jitted program; the batch
axis is

* **vmapped** on one device (chunked to bound the PSD-cube working set),
  and
* **sharded** across the devices of a ``jax.sharding.Mesh`` when a mesh
  is provided — XLA partitions the whole pipeline; the only cross-device
  traffic in the pipeline is the final gather of (nl, dimpsf, dimpsf)
  cubes, so scaling is linear.
"""

import dataclasses
import os
import threading
import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import GalacsiConfig
from ..psd.model import simulate_psd, simulate_psd_split
from ..otf.psf import (psf_cube, psf_cube_from_base, dphi_base,
                       dphi_base_split)
from ..otf.convolve import convolve_final
from ..utils.devices import host_cpu_device
from ..utils.log import get_logger

logger = get_logger("batch")


def _window_guard(base, lbda, cfg: GalacsiConfig):
    """Margin of the OTF-support window, from the windowed structure
    function: ``0.5 * convnm_max^2 * min(D on the window boundary) -
    ln(1e9)``.  Nonnegative means every dropped OTF value is below 1e-9
    of the DC, i.e. the window was large enough; callers recompute with
    the full window otherwise.  +inf when no support reduction is
    active.

    The bound treats the boundary minimum as a lower bound for all of
    the exterior, i.e. it assumes ``D`` grows outward in the inf-radius.
    That is a *heuristic*: ``D = 2(bg00 - Re(bg))`` is not strictly
    monotone for all telemetry, so a non-monotone ridge strictly outside
    the window with ``D`` below the boundary minimum would evade this
    guard.  The real screen is the host-side estimator
    (:func:`rows_windowable`), which samples ``D`` on 8 extreme rays out
    to the full grid edge at a threshold (1e-12) three decades below
    this guard's 1e-9 — the guard is the on-device backstop for rows
    the estimator admitted, not the primary certification.

    With ``cfg.otf_blue = (nb, S_blue)`` the bluest ``nb`` wavelengths
    run on the smaller centred sub-window, so the guard additionally
    checks the SUB-window boundary at ``max(lbda[:nb])`` (only the top/
    bottom rows and the left column are truncation boundaries — columns
    past ``c+128`` are reached through the point-symmetry fold, whose
    mirror lands inside the computed block for any 128-multiple S).
    """
    win = cfg.otf_window
    g = jnp.asarray(np.inf, cfg.dtype)
    if win is not None and cfg.otf_blue is not None:
        nb, Sb = int(cfg.otf_blue[0]), int(cfg.otf_blue[1])
        S = win[1]
        lo, hi = S - Sb, S + Sb
        d_edge_b = jnp.minimum(
            jnp.minimum(jnp.min(base[:, lo, lo:]),
                        jnp.min(base[:, hi - 1, lo:])),
            jnp.min(base[:, lo:hi, lo]))
        convnm2_b = (2.0 * np.pi / jnp.max(lbda[:nb])) ** 2
        g = (0.5 * convnm2_b * d_edge_b - float(np.log(1e9))).astype(
            jnp.dtype(cfg.dtype))
    if win is None or win[1] >= cfg.dim // 2:
        # full (half-)window: the fold drops nothing beyond any blue
        # sub-window already guarded above
        return g
    d_edge = jnp.minimum(
        jnp.minimum(jnp.min(base[:, 0, :]), jnp.min(base[:, -1, :])),
        jnp.min(base[:, :, 0]))
    convnm2 = (2.0 * np.pi / jnp.max(lbda)) ** 2
    return jnp.minimum(g, 0.5 * convnm2 * d_edge - float(np.log(1e9)))


def reconstruct_one(seeing, GL, L0, gs_mask, lbda, h, wind_speed,
                    npsflin: int, cfg: GalacsiConfig, return_guard=False,
                    npixc=None):
    """Single work item: telemetry -> final PSF cube (nl, dimpsf, dimpsf).

    With ``cfg.use_dphi_split`` the full-grid PSD is never materialised:
    the fitting-PSD part of the structure function comes from precomputed
    per-config constants and only the correction-zone block is
    transformed (valid for L0 >= cfg.dphi_split_l0_min — the batch entry
    points check this on the host and fall back to the exact path).

    With ``return_guard`` also returns the scalar window-guard margin
    (see :func:`_window_guard`).
    """
    # stage names (jax.named_scope) reach the compiled program's op
    # metadata, where benchmarks/profile_stages.py attributes device time
    if cfg.use_dphi_split:
        with jax.named_scope("psd"):
            w, delta = simulate_psd_split(seeing, GL, L0, gs_mask, h,
                                          wind_speed, npsflin, cfg)
        with jax.named_scope("dphi"):
            base = dphi_base_split(w, delta, cfg)
    else:
        with jax.named_scope("psd"):
            psd = simulate_psd(seeing, GL, L0, gs_mask, h, wind_speed,
                               npsflin, cfg)
        with jax.named_scope("dphi"):
            base = dphi_base(psd.astype(cfg.dtype), cfg)
    with jax.named_scope("otf_zoom"):
        psf = psf_cube_from_base(base, lbda, cfg, npixc=npixc)
    with jax.named_scope("convolve"):
        out = convolve_final(psf, lbda, seeing, GL, L0, cfg)
    if return_guard:
        with jax.named_scope("guard"):
            return out, _window_guard(base, lbda, cfg)
    return out


@partial(jax.jit, static_argnames=("h", "wind_speed", "npsflin", "cfg"))
def _reconstruct_vmapped(seeing, GL, L0, gs_mask, lbda, npixc, h,
                         wind_speed, npsflin, cfg):
    psf, guard = jax.vmap(
        lambda s, g, l, m: reconstruct_one(s, g, l, m, lbda, h, wind_speed,
                                           npsflin, cfg, return_guard=True,
                                           npixc=npixc)
    )(seeing, GL, L0, gs_mask)
    return psf, jnp.min(guard)


@partial(jax.jit, static_argnames=("h", "wind_speed", "npsflin", "cfg"))
def _reconstruct_chunk(t, lbda, npixc, h, wind_speed, npsflin, cfg):
    """One (chunk, 7) telemetry slice laid out [seeing, GL, L0, gs_mask(4)]
    -> (PSF cubes, window-guard margin).  The slice shape is the
    compilation key: callers must slice the device-resident table
    *outside* (with a traced offset, so the total batch size never
    enters any compiled program)."""
    psf, guard = jax.vmap(
        lambda row: reconstruct_one(row[0], row[1], row[2], row[3:7],
                                    lbda, h, wind_speed, npsflin, cfg,
                                    return_guard=True, npixc=npixc)
    )(t)
    return psf, jnp.min(guard)


def _valid_row_sum(psf, n_valid):
    """Sum of the first ``n_valid`` PSF cubes of the chunk (the rest are
    padding) as an elementwise masked sum: exact float32 adds, where a
    dot over the row axis could run at reduced matmul precision."""
    w = (jnp.arange(psf.shape[0]) < n_valid).astype(psf.dtype)
    return jnp.sum(w[:, None, None, None] * psf, axis=0)


@partial(jax.jit, static_argnames=("h", "wind_speed", "npsflin", "cfg",
                                   "fit_dtype"))
def _fit_chunk(t, n_valid, lbda, npixc, h, wind_speed, npsflin, cfg,
               fit_dtype):
    """Fused chunk step for fit-oriented batches: reconstruction + packed
    Moffat fit + pad-masked PSF sum + window guard in ONE dispatch.

    One fused jitted call per chunk and no eager reductions in the loop
    (process_batch defers those to one stacked op at the end): every
    host-side dispatch costs command latency, so the per-chunk op count
    is kept at one.
    """
    from ..fit.moffat_fit import fit_moffat_cube_packed
    psf, guard = jax.vmap(
        lambda row: reconstruct_one(row[0], row[1], row[2], row[3:7],
                                    lbda, h, wind_speed, npsflin, cfg,
                                    return_guard=True, npixc=npixc)
    )(t)
    with jax.named_scope("moffat_fit"):
        fit = fit_moffat_cube_packed(psf, dtype=fit_dtype)
    with jax.named_scope("row_sum"):
        psum = _valid_row_sum(psf, n_valid)
    return fit, psum, jnp.min(guard)


@partial(jax.jit, static_argnames=("h", "wind_speed", "npsflin", "cfg",
                                   "fit_dtype"))
def _fit_vmapped(seeing, GL, L0, gs_mask, n_valid, lbda, npixc, h,
                 wind_speed, npsflin, cfg, fit_dtype):
    """Mesh-sharded variant of :func:`_fit_chunk`."""
    from ..fit.moffat_fit import fit_moffat_cube_packed
    psf, guard = jax.vmap(
        lambda s, g, l, m: reconstruct_one(s, g, l, m, lbda, h, wind_speed,
                                           npsflin, cfg, return_guard=True,
                                           npixc=npixc)
    )(seeing, GL, L0, gs_mask)
    with jax.named_scope("moffat_fit"):
        fit = fit_moffat_cube_packed(psf, dtype=fit_dtype)
    with jax.named_scope("row_sum"):
        psum = _valid_row_sum(psf, n_valid)
    return fit, psum, jnp.min(guard)


_REPLICATE_JIT = {}


def _replicate_for_host(mesh, *arrays):
    """All-gather mesh-sharded chunk results so every process holds the
    full value (SURVEY.md §5: the only collective the workload needs).

    Multi-host only: a row-sharded ``jax.Array`` spans non-addressable
    devices there, so the host-side sinks (``on_chunk``, the packed
    pulls) cannot fetch it.  Single-process meshes skip the extra op —
    the sharded arrays are fully addressable.
    """
    if mesh is None or jax.process_count() == 1:
        return arrays
    key = (mesh, len(arrays))
    if key not in _REPLICATE_JIT:
        sh = NamedSharding(mesh, P())
        _REPLICATE_JIT[key] = jax.jit(
            lambda *a: a, out_shardings=tuple(sh for _ in arrays))
    return _REPLICATE_JIT[key](*arrays)


from .mesh import default_mesh  # noqa: E402  (re-exported here for API)

def _warm_enabled():
    """Whether the concurrent warm-up engages (see `_warm_programs`).

    Default ON: XLA compiles distinct programs on separate host cores.
    ``MUSE_PSFR_NO_WARM=1`` turns it off.
    """
    return not os.environ.get("MUSE_PSFR_NO_WARM")


def _warm_concurrency():
    """Concurrent compile width for the warm-up (default 2).

    Width 2 overlaps the night's two main bucket compiles while bounding
    the host memory of concurrent production-size compiles.  Override
    with ``MUSE_PSFR_WARM_CONCURRENCY`` (>= 1; large = unbounded
    fan-out).
    """
    raw = os.environ.get("MUSE_PSFR_WARM_CONCURRENCY", "2")
    try:
        return max(1, int(raw))
    except ValueError:
        logger.warning("ignoring non-integer MUSE_PSFR_WARM_CONCURRENCY=%r",
                       raw)
        return 2


def _compile_concurrently(jobs, width=None):
    """Run AOT compile thunks, at most ``width`` at a time.

    ``jobs`` is a list of ``(thunk, chunk_size)`` pairs; each thunk
    lowers + compiles one pipeline executable.  XLA releases the GIL
    during compilation, so worker threads overlap the compiles of a
    night's executables (reduced-window bucket, full-window bucket,
    tail sizes, exact-transform group) — bounded by ``width`` (default
    :func:`_warm_concurrency`).  The first failure re-raises unchanged
    once every worker has finished.  Jobs run in the given order
    (callers sort largest-first so the critical-path compile starts
    immediately).
    """
    width = _warm_concurrency() if width is None else max(1, int(width))
    if len(jobs) == 1 or width == 1:
        for thunk, _ in jobs:
            thunk()
        return
    errs = []
    it = iter(list(jobs))
    lock = threading.Lock()

    def _worker():
        while True:
            with lock:
                job = next(it, None)
            if job is None:
                return
            thunk, _ = job
            try:
                thunk()
            except Exception as err:  # noqa: BLE001
                errs.append(err)

    threads = [threading.Thread(target=_worker, daemon=True)
               for _ in range(min(width, len(jobs)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]


_WARM_MEMO = set()


def _redo_warm_specs(specs, chunk_n, seeing, GL, L0,
                     gs_mask, lbda, h, npsflin, cfg, windowed):
    """Add the guard-redo executables to ``specs``.

    The redo re-plans with ``_force_full=True``; deriving the specs from
    that plan (rather than hand-building ``cfg.with_(otf_support=0)``)
    picks up everything ``_plan_batch`` resolves — the exact-transform
    (split-bad) redo group — so the
    warm covers exactly what a trip would dispatch.  ``setdefault``
    dedups against groups the night already compiles.  No-op when no
    reduced-window group exists (nothing can trip)."""
    if not windowed:
        return
    _, r_groups, _, r_table, *_ = _plan_batch(
        seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg, chunk_n, None,
        True)
    for rcfg, ridx in r_groups:
        rt = r_table[ridx]
        if rt.shape[0] < chunk_n:
            rt = np.concatenate(
                [rt, np.repeat(rt[-1:], chunk_n - rt.shape[0], axis=0)],
                axis=0)
        specs.setdefault((rcfg, chunk_n), rt)


def _warm_programs(specs, kind, lbda_j, npixc_j, h_t, wind_speed, npsflin,
                   fit_dtype=None, mean_spec=None):
    """Compile the chunk executables a night will dispatch, in parallel.

    ``specs`` maps ``(gcfg, chunk_size)`` — one entry per distinct
    executable the bucketed dispatch loop will need (each support-bucket
    group at its main chunk size plus any tail size) — to a real
    ``(chunk_size, 7)`` telemetry slice of that group.  Without this, the
    executables compile serially at their first dispatch: bucket A's
    compile fully precedes bucket B's, and a
    reduced-window bucket's tail program compiles mid-night at the last
    chunk.

    Warming CALLS the jitted chunk function with the group's real leading
    rows: the only path guaranteed to land in the dispatch loop's call
    cache — AOT ``lower().compile()`` does NOT populate it in this JAX
    version (measured: the call after an AOT compile re-traces and
    re-compiles; pinned by
    ``tests/test_parallel.py::test_warm_populates_jit_cache``).  The
    discarded execution costs one chunk of device time per executable per
    process — small against the compiles being parallelised.  Skipped when fewer than two executables are cold
    (nothing to parallelise: the loop compiles a single cold program at
    first dispatch exactly as before, with no duplicated execution).
    Memoised per process; ``MUSE_PSFR_NO_WARM=1`` turns it off
    (:func:`_warm_enabled`).
    """
    if not _warm_enabled():
        return
    jobs = []
    for (gcfg, size), tab in sorted(specs.items(),
                                    key=lambda kv: -kv[0][1]):
        key = (kind, gcfg, size, lbda_j.shape, str(lbda_j.dtype), h_t,
               wind_speed, npsflin, fit_dtype)
        if key in _WARM_MEMO:
            continue

        def _thunk(gcfg=gcfg, size=size, tab=tab, key=key):
            t = jnp.asarray(tab[:size], gcfg.dtype)
            if kind == "fit":
                _fit_chunk(t, jnp.asarray(np.int32(size)), lbda_j, npixc_j,
                           h_t, wind_speed, npsflin, gcfg, fit_dtype)
            else:
                _reconstruct_chunk(t, lbda_j, npixc_j, h_t, wind_speed,
                                   npsflin, gcfg)
            _WARM_MEMO.add(key)

        jobs.append((_thunk, size))
    if mean_spec is not None:
        # the standalone mean-PSF fit program (fit_moffat_cube_packed on
        # the (nl, dimpsf, dimpsf) mean cube) otherwise compiles
        # synchronously at mean_enqueue, after every chunk is dispatched
        # — one more serial first-night compile
        shape, dtype = mean_spec
        mkey = ("mean", shape, str(dtype), fit_dtype)
        if mkey not in _WARM_MEMO:

            def _mean_thunk(shape=shape, dtype=dtype, mkey=mkey):
                from ..fit.moffat_fit import fit_moffat_cube_packed
                fit_moffat_cube_packed(jnp.zeros(shape, dtype),
                                       dtype=fit_dtype)
                _WARM_MEMO.add(mkey)

            jobs.append((_mean_thunk, "mean-fit"))
    if len(jobs) < 2:
        return
    t0 = time.perf_counter()
    _compile_concurrently(jobs)
    dt = time.perf_counter() - t0
    if dt > 1.0:
        logger.info("warmed %d chunk executables in %.1f s "
                    "(concurrent compile)", len(jobs), dt)


#: backends whose runtime executes ``jnp.fft`` (cuFFT on NVIDIA GPUs;
#: ``jax.default_backend()`` names every GPU backend "gpu")
_FFT_BACKENDS = ("cpu", "gpu")


def fft_available() -> bool:
    """Whether the default backend executes FFTs, decided from the
    backend's name alone (no probe program is run)."""
    return jax.default_backend() in _FFT_BACKENDS


def resolve_fft_mode(cfg: GalacsiConfig) -> GalacsiConfig:
    """Switch ``cfg`` to the FFT-free DFT-matmul path when the backend
    has no FFTs — with a warning, never silently."""
    if cfg.use_fft and not fft_available():
        logger.warning("backend %r has no FFT support: using the FFT-free "
                       "DFT-matmul path (use_fft=False)",
                       jax.default_backend())
        if not cfg.use_zoom_dft:
            cfg = cfg.with_(use_zoom_dft=True)
        cfg = cfg.with_(use_fft=False)
    return cfg


_SPLIT_CPU_CACHE = {}


def _split_on_cpu(seeing, GL, L0, gs_mask, h, wind_speed, npsflin, cfg):
    """(w, delta) of the split PSD for every row, computed on the host
    CPU backend (the zone block is dim-independent and tiny: ~13 ms per
    100 rows)."""
    from ..psd.model import simulate_psd_split
    h_t = tuple(float(x) for x in np.asarray(h, np.float64).ravel())
    key = (h_t, float(wind_speed), npsflin, cfg)
    if key not in _SPLIT_CPU_CACHE:
        _SPLIT_CPU_CACHE[key] = jax.jit(jax.vmap(
            lambda s, g, l, m: simulate_psd_split(
                s, g, l, m, h_t, float(wind_speed), npsflin, cfg)))
    with jax.default_device(host_cpu_device()):
        w, delta = _SPLIT_CPU_CACHE[key](
            jnp.asarray(seeing), jnp.asarray(GL), jnp.asarray(L0),
            jnp.asarray(gs_mask))
    return np.asarray(w, np.float64), np.asarray(delta, np.float64)


def default_support_bucket(cfg: GalacsiConfig) -> int:
    """The one reduced OTF-support bucket used by the batch layer.

    Roughly dim/4, 128-aligned (dim=1280 -> 256, dim=2048 -> 512).  A
    single fixed bucket keeps the number of compiled pipeline variants
    at two (reduced + full) and is deterministic: any sub-batch of a
    night reuses the same executables.
    """
    return max(128, (cfg.dim // 4) // 128 * 128)


_WINDOWABLE_MEMO = {}


def rows_windowable(seeing, GL, L0, gs_mask, lbda_max_nm, cfg, S,
                    h=(100, 10000), wind_speed=None, npsflin=1,
                    thresh: float = 1e-12):
    """Per-row host-side test: is ``otf_support=S`` safe for each row?

    The normalised system OTF is ``exp(-0.5 convnm^2 D) * dl/dl_max``
    with ``D = D_fit + D_corr`` the wavelength-free structure function;
    both parts are evaluated on the host: ``D_fit = sum_k w_k T_k`` from
    the precomputed basis (lower-bounded per inf-norm ring by sign-aware
    min/max envelopes — exact), and ``D_corr`` from the correction-zone
    block ``delta``, whose tiny dim-independent model runs for every row
    on the CPU backend (~13 ms / 100 rows).  ``D`` is sampled along the
    8 inf-norm-ring extreme rays (axes + diagonals) at 32-px radius
    steps from ``S-1`` outward; a row is windowable when the sampled
    damping stays below ``thresh`` everywhere beyond the window.

    The ray/step sampling is backstopped at run time: the pipeline
    returns the minimum structure-function value on the window boundary
    (window guard) and the batch layer recomputes with the full window
    if the implied |G| exceeds 1e-9 (three decades of margin to
    ``thresh``).

    Rows outside the certified split range (L0 < cfg.dphi_split_l0_min)
    or with non-finite telemetry report not-windowable.  Zenith is
    ignored (cos^0.6 <= 1 only increases turbulence, i.e. damping).
    Results are memoised on the telemetry content; the expensive part
    (the exact zone model + ring sampling, which is independent of both
    the wavelength and the window size) is memoised ONCE per telemetry
    by :func:`_ring_damping`, so probing several (lambda, S) pairs —
    the blue-split planner's menu — reuses one evaluation.
    """
    from ..psd.model import effective_wind_speed
    seeing = np.atleast_1d(np.asarray(seeing, np.float64))
    GL = np.atleast_1d(np.asarray(GL, np.float64))
    L0 = np.atleast_1d(np.asarray(L0, np.float64))
    gs_mask = np.atleast_2d(np.asarray(gs_mask, np.float64))
    out = np.zeros(seeing.shape[0], bool)
    if cfg.otf_window is None or S >= cfg.dim // 2 or S % 128 != 0:
        return out
    if wind_speed is None:
        wind_speed = effective_wind_speed(h, cfg)
    h_t = tuple(float(x) for x in np.asarray(h, np.float64).ravel())
    key = (seeing.tobytes(), GL.tobytes(), L0.tobytes(), gs_mask.tobytes(),
           float(lbda_max_nm), S, h_t, float(wind_speed), npsflin, cfg,
           thresh)
    if key in _WINDOWABLE_MEMO:
        return _WINDOWABLE_MEMO[key]
    idx, d_tot, r_of_pt = _ring_damping(seeing, GL, L0, gs_mask, cfg,
                                        h_t, float(wind_speed), npsflin)
    if idx.size == 0:
        return out
    convnm2 = (2.0 * np.pi / float(lbda_max_nm)) ** 2
    need = -np.log(thresh)
    sel = r_of_pt >= S - 1
    ok_rows = np.all(0.5 * convnm2 * d_tot[:, :, sel] >= need, axis=(1, 2))
    out[idx] = ok_rows
    if len(_WINDOWABLE_MEMO) > 64:
        _WINDOWABLE_MEMO.clear()
    _WINDOWABLE_MEMO[key] = out
    return out


_RING_DAMPING_MEMO = {}


def _ring_damping(seeing, GL, L0, gs_mask, cfg, h_t, wind_speed,
                  npsflin):
    """Exact host-side structure-function samples on the admission rays.

    Returns ``(idx, d_tot, r_of_pt)``: the valid-row indices, their
    ``(R, ndir, npts)`` structure-function values on the 8 inf-norm-ring
    extreme rays at 32-px radius steps from 127 (= the smallest window's
    boundary; every 128-multiple boundary S-1 lands on this grid) out to
    the grid edge, and each point's radius.  Wavelength- and window-
    independent — the caller thresholds ``0.5 * (2pi/lbda)^2 * d_tot``
    on the subset ``r_of_pt >= S - 1``.  Memoised on the telemetry
    content (one zone-model + GEMM evaluation serves every (lambda, S)
    probe of a planning pass).
    """
    from ..core.vonkarman import fitting_expansion_spec, CST_VK_EXACT
    from ..otf.psf import fitting_dphi_ring_envelopes, _centered_idft_np
    key = (seeing.tobytes(), GL.tobytes(), L0.tobytes(), gs_mask.tobytes(),
           h_t, wind_speed, npsflin, cfg.with_(otf_support=0,
                                               otf_blue=None))
    if key in _RING_DAMPING_MEMO:
        return _RING_DAMPING_MEMO[key]
    ok = (np.isfinite(seeing) & (seeing > 0) & np.isfinite(L0)
          & (L0 >= cfg.dphi_split_l0_min) & np.isfinite(GL)
          & np.all(np.isfinite(gs_mask), axis=1))
    idx = np.nonzero(ok)[0]
    if idx.size == 0:
        res = (idx, np.zeros((0, 1, 0)), np.zeros(0, int))
        _RING_DAMPING_MEMO[key] = res
        return res
    see_v, gl_v, l0_v, m_v = seeing[idx], GL[idx], L0[idx], gs_mask[idx]
    dim = cfg.dim
    c = dim // 2

    # fit part: per-row ring lower bound of sum_k w_k T_k (exact)
    tmin, tmax = fitting_dphi_ring_envelopes(cfg)        # (K+1, c+1)
    u0, binoms = fitting_expansion_spec(cfg.dphi_split_l0_min,
                                        cfg.dphi_split_degree)
    from ..psd.model import seeing_to_r0
    with jax.default_device(host_cpu_device()):
        r0 = np.asarray(seeing_to_r0(see_v, cfg.lambda_ref), np.float64)
    nm2 = (cfg.lambda_ref * 1000.0 / (2 * np.pi)) ** 2
    du = 1.0 / (l0_v * l0_v) - u0
    w = (nm2 * CST_VK_EXACT * r0[:, None] ** (-5.0 / 3.0) * binoms[None]
         * du[:, None] ** np.arange(len(binoms))[None])  # (R, K+1)
    d_fit = (np.where(w[:, :, None] >= 0, w[:, :, None] * tmin[None],
                      w[:, :, None] * tmax[None])).sum(axis=1)  # (R, c+1)

    # correction part: exact zone model, sampled on the 8 ring-extreme
    # rays at 32-px steps from the smallest window boundary outward
    _, delta = _split_on_cpu(see_v, gl_v, l0_v, m_v, h_t,
                             wind_speed, npsflin, cfg)
    L = cfg.dpup * (dim / cfg.npup)
    scale = dim * dim / (L * L)
    bg00 = delta.sum(axis=(-2, -1)) / (L * L)            # (R, ndir)
    lo = c - cfg.dim_pup
    s = delta.shape[-1]
    cb, sb = _centered_idft_np(dim, cols=(lo, s))        # (dim, s) f64
    radii = np.arange(127, c, 32)
    if radii[-1] != c - 1:
        radii = np.append(radii, c - 1)
    # evaluation points (dy, dx) covering the 8 rays at each radius
    pts = []
    for r in radii:
        r = int(r)
        pts += [(r, 0), (-r, 0), (0, r), (0, -r),
                (r, r), (-r, -r), (r, -r), (-r, r)]
    rows_p = np.array([c + dy for dy, _ in pts])
    cols_q = np.array([c + dx for _, dx in pts])
    uq, qinv = np.unique(cols_q, return_inverse=True)
    # contract as BLAS GEMMs (einsum would loop): (R*ndir*s, s) @ (s, nq)
    rr, nd = delta.shape[0], delta.shape[1]
    flat = delta.reshape(-1, s)
    yc = (flat @ cb[uq].T).reshape(rr, nd, s, -1)        # (R,ndir,s,nq)
    ys = (flat @ sb[uq].T).reshape(rr, nd, s, -1)
    re = (np.einsum("ps,rdsp->rdp", cb[rows_p],
                    yc[..., qinv])
          - np.einsum("ps,rdsp->rdp", sb[rows_p], ys[..., qinv]))
    d_corr = 2.0 * (bg00[..., None] - re * scale)        # (R, ndir, npts)
    r_of_pt = np.repeat(radii, 8)
    d_tot = d_fit[:, r_of_pt][:, None, :] + d_corr       # (R, ndir, npts)
    if len(_RING_DAMPING_MEMO) > 16:
        _RING_DAMPING_MEMO.clear()
    _RING_DAMPING_MEMO[key] = (idx, d_tot, r_of_pt)
    return idx, d_tot, r_of_pt


def estimate_otf_support(seeing, GL, L0, gs_mask, lbda_max_nm, cfg,
                         h=(100, 10000), wind_speed=None, npsflin=1,
                         thresh: float = 1e-12) -> int:
    """Smallest 128-aligned ``otf_support`` safe for EVERY given row
    (see :func:`rows_windowable`), or 0 when only the full window is.
    The batch layer instead buckets rows individually
    (:func:`default_support_bucket`); this scalar form is for pinning
    one window explicitly (benchmarks, single conditions, tests).
    """
    cfg_probe = cfg if cfg.otf_support == 0 else cfg.with_(otf_support=0)
    for S in range(128, cfg.dim // 2, 128):
        if rows_windowable(seeing, GL, L0, gs_mask, lbda_max_nm,
                           cfg_probe, S, h, wind_speed, npsflin,
                           thresh).all():
            return S
    return 0


def _blue_tiers(cfg, ndir: int = 1) -> int:
    """Max blue tiers per group: ``MUSE_PSFR_BLUE_TIERS`` overrides
    ``cfg.blue_tiers`` (defensive parse, like MUSE_PSFR_PULL_PART).

    ``cfg.blue_tiers == 0`` is AUTO: 2 tiers for multi-direction runs
    (``ndir >= 9``, where the exp area is largest), 1 otherwise.
    """
    raw = None
    env = os.environ.get("MUSE_PSFR_BLUE_TIERS")
    if env is not None:
        try:
            raw = int(env)
        except ValueError:
            logger.warning("MUSE_PSFR_BLUE_TIERS=%r is not an integer; "
                           "using cfg.blue_tiers", env)
    if raw is None:
        raw = int(getattr(cfg, "blue_tiers", 0))
    if raw == 0:              # AUTO — same semantics for env and cfg
        return 2 if ndir >= 9 else 1
    # the ladder enumeration is C(menu, tiers) per group: clamp to a
    # small constant so a forced value cannot blow up host planning
    return min(4, max(1, raw))


def _blue_split_plan(groups, seeing, GL, L0, gs_mask, lb_np, h_t,
                     wind_speed, npsflin, chunk_c):
    """Per-group blue-segment window planning (``cfg.otf_blue``).

    The damping exponent scales as ``(2pi/lambda)^2``, so the bluest
    wavelengths admit much smaller OTF windows than the band maximum
    that sized each group's bucket.  For every windowed/full group this
    probes the host admission model (:func:`rows_windowable`) at the
    half-bucket window ``S_blue`` for a menu of segment lengths
    ``nb in {lambda_chunk, 2*lambda_chunk, ...}`` (the menu keeps the
    static-key variety — and hence the compile count — bounded across
    nights) and either:

    * annotates the whole group with the largest ``nb`` every row
      admits (no extra executable), or
    * splits the group into a blue-admitting subgroup + the remainder
      when the partial split saves meaningfully more exp area than the
      whole-group annotation (>4/3, i.e. whole-group wins at >=0.75 of
      the best partial score) AND the subgroup covers at least a
      quarter of the group (a second executable costs a compile).

    A partial split is CHUNK-AWARE: the blue subgroup is rounded DOWN
    to a multiple of the dispatch quantum (the clamped chunk for
    full-window groups, which always pad; the chunk/4 tail-menu step
    for reduced-window groups) by demoting excess admitted rows to the
    plain group — otherwise both subgroups pad up to the chunk and the
    padded rows' real device work repays the saving (e.g. the 1000-row
    bench night would pad 102 extra rows at chunk=100).  Demotion only ever costs the demoted rows' saving;
    the plain group's worst-case pad stays <= chunk-1, the same as the
    unsplit group's.

    With ``cfg.blue_tiers > 1`` (env ``MUSE_PSFR_BLUE_TIERS``) the
    planner may form a LADDER of blue subgroups per group — descending
    segment lengths ``nb_1 > nb_2``, tier ``i`` keeping the
    quantum-rounded admitters of ``nb_i`` not taken by a bluer tier —
    because admission is graded in nb (e.g. 47% of full-window rows
    admit S=256 out to 748.8 nm vs 72% at 658.2 nm): a single segment
    forfeits the deeper saving of the strong admitters.  Every
    executable beyond the group's own must buy a 4/3 score factor, the
    same compile-count guard as the single-subgroup rule (which
    ``blue_tiers=1`` reproduces exactly).

    Ceiling data: benchmarks/measure_perlambda_window.py (bench-night
    telemetry: the S=256 bucket admits S=128 for lambda <= 658 nm for
    100% of rows; ~72% of full-window rows admit S=256 there).
    Requires an ascending wavelength grid; groups already annotated or
    outside the split-certified range are left alone.
    Skipped wholesale with ``MUSE_PSFR_NO_BLUE=1``.
    """
    nl = lb_np.size
    if (nl < 2 or np.any(np.diff(lb_np) < 0)
            or os.environ.get("MUSE_PSFR_NO_BLUE")):
        return groups
    out = []
    for gcfg, gidx in groups:
        win = gcfg.otf_window
        if (win is None or not gcfg.use_dphi_split
                or gcfg.otf_blue is not None
                or gidx.size == 0):
            out.append((gcfg, gidx))
            continue
        S = win[1]
        Sb = ((S // 2) // 128) * 128
        kl = max(1, int(gcfg.lambda_chunk))
        if Sb < 128 or Sb >= S or nl <= kl:
            out.append((gcfg, gidx))
            continue
        probe = gcfg if gcfg.otf_support == 0 else gcfg.with_(otf_support=0)
        n_rows = gidx.size
        quantum = (chunk_c if gcfg.otf_support == 0
                   else max(1, chunk_c // 4))
        # admission counts over the nb menu (monotone decreasing in nb;
        # the expensive host model is memoised, so the whole menu costs
        # one evaluation per row)
        cnts, adms = {}, {}
        for nb in range(kl, nl, kl):
            adm = rows_windowable(seeing[gidx], GL[gidx], L0[gidx],
                                  gs_mask[gidx], float(lb_np[nb - 1]),
                                  probe, Sb, h=h_t, wind_speed=wind_speed,
                                  npsflin=npsflin)
            cnt = int(adm.sum())
            if cnt == 0:
                break           # admission is monotone decreasing in nb
            cnts[nb], adms[nb] = cnt, adm
        if not cnts:
            out.append((gcfg, gidx))
            continue
        full_nb = max((nb for nb, c in cnts.items() if c == n_rows),
                      default=0)
        tiers = _blue_tiers(gcfg, npsflin * npsflin)
        # enumerate blue LADDERS: descending (nb_1 > nb_2 > ...) tier
        # segment lengths, tier i keeping the quantum-rounded admitters
        # of nb_i not already taken by a bluer tier.  Score = sum of
        # nb_i * keep_i (saved exp area per row is proportional to nb at
        # a common Sb); each executable beyond the group's own must buy
        # a 4/3 score factor (the compile-count guard), i.e.
        # candidates are ranked by score * 0.75^extra_executables.
        # tiers=1 reproduces the single-subgroup behaviour exactly.
        nbs_asc = sorted(cnts)
        # bound C(menu, tiers): with a fine wavelength grid the nb menu
        # can reach hundreds of entries; thin to <=16 evenly spaced
        # (keeping the reddest/highest-scoring end exactly) before
        # enumerating ladders — full_nb and max(nbs) always survive
        if len(nbs_asc) > 16:
            idx = np.unique(np.round(
                np.linspace(0, len(nbs_asc) - 1, 16)).astype(int))
            keep_set = {nbs_asc[i] for i in idx}
            if full_nb:
                keep_set.add(full_nb)
            nbs_asc = sorted(keep_set)
        whole = ((float(full_nb * n_rows), full_nb * n_rows,
                  [(full_nb, n_rows)], 0) if full_nb else None)
        best = whole   # (value, score, ladder=[(nb, keep)], extra)
        from itertools import combinations
        for t in range(1, max(1, tiers) + 1):
            # ascending enumeration keeps the historical smallest-nb
            # tie-break of the single-subgroup planner; each ladder
            # itself runs bluest (largest nb) tier first
            for asc in combinations(nbs_asc, t):
                ladder = asc[::-1]
                taken, keeps = 0, []
                for nb in ladder:
                    avail = cnts[nb] - taken
                    # a tier that admits the whole group absorbs every
                    # remaining row (no plain remainder -> no rounding)
                    keep = (n_rows - taken if cnts[nb] == n_rows
                            else (avail // quantum) * quantum)
                    if keep <= 0:
                        break
                    keeps.append((nb, keep))
                    taken += keep
                if len(keeps) < t:
                    continue    # a shorter ladder; already enumerated
                extra = len(keeps) - (1 if taken == n_rows else 0)
                score = sum(nb * k for nb, k in keeps)
                value = score * 0.75 ** extra
                if best is None or value > best[0]:
                    best = (value, score, keeps, extra)
        # the minimum-size guard applies to the SELECTED candidate (a
        # guard-failing argmax falls back to whole-group annotation or
        # plain, never to a lower-score ladder) — the single-subgroup
        # planner's historical semantics, which blue_tiers=1 must
        # reproduce bit-for-bit
        if best is not None and \
                sum(k for _, k in best[2]) < max(1, n_rows // 4):
            best = whole
        if best is None:
            out.append((gcfg, gidx))
            continue
        _, _, keeps, _ = best
        if len(keeps) == 1 and keeps[0][1] == n_rows:
            out.append((gcfg.with_(otf_blue=(keeps[0][0], Sb)), gidx))
            continue
        taken_rows = np.zeros(n_rows, bool)
        for nb, keep in keeps:
            sel = np.nonzero(adms[nb] & ~taken_rows)[0][:keep]
            tier_rows = np.zeros(n_rows, bool)
            tier_rows[sel] = True
            taken_rows |= tier_rows
            out.append((gcfg.with_(otf_blue=(nb, Sb)), gidx[tier_rows]))
        if not taken_rows.all():
            out.append((gcfg, gidx[~taken_rows]))
    return out


def clamped_chunk(chunk: int, B: int, mesh: Mesh = None) -> int:
    """The chunk size the batch layer actually dispatches: clamped to the
    batch, at least the mesh size, rounded up to a mesh-size multiple.
    This (together with the config statics) is the compilation key."""
    n_dev = 1 if mesh is None else mesh.size
    c = max(min(chunk, B), n_dev)
    return ((c + n_dev - 1) // n_dev) * n_dev


def _plan_batch(seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg, chunk,
                mesh, force_full=False):
    """Shared batch planning: validate, resolve the config against the
    backend, bucket rows by OTF support, and build the telemetry table.

    Returns ``(cfg, groups, chunk, table, lbda_j, h_t, wind_speed,
    sharding)`` with ``groups`` a list of ``(group_cfg, row_indices)``.
    """
    from ..psd.model import effective_wind_speed
    from ..utils.compile_cache import ensure_compile_cache
    ensure_compile_cache()   # idempotent; must precede the first compile
    cfg = resolve_fft_mode(cfg or GalacsiConfig())
    wind_speed = effective_wind_speed(h, cfg)

    # the lambda-dependent crop must fit inside the PSD grid; the bluest
    # wavelength sets the largest crop (reference psfrec.py:663-664 slices
    # out of bounds there, failing with a confusing shape error)
    lb_np = np.atleast_1d(np.asarray(lbda, dtype=np.float64))
    if lb_np.size == 0:
        raise ValueError("empty wavelength array")
    # per-wavelength crop sizes in host float64: the banker's-rounding
    # .5 boundaries must be decided exactly (otf/psf.py:lambda_crop_size
    # QUIRK, the single home of the crop formula) — the in-graph f32
    # quotient can land on the wrong side
    from ..otf.psf import lambda_crop_size
    # host copy: the plan holds no device arrays (executors pass the
    # array to the jit, where the aval — i32[nl] — is what matters)
    npixc = np.asarray(lambda_crop_size(lb_np, cfg))
    npixc_max = int(npixc.max())
    if npixc_max > cfg.dim:
        raise ValueError(
            f"wavelength {lb_np.min():.1f} nm needs a {npixc_max} px crop, "
            f"larger than the {cfg.dim}^2 PSD grid; raise cfg.dim or the "
            f"minimum wavelength")
    h_t = tuple(float(x) for x in np.asarray(h, dtype=np.float64).ravel())
    # planning stays device-free: the normalised 1-D HOST copy is
    # returned; executors convert with ``jnp.asarray(lb_np, cfg.dtype)``
    # (a scalar lbda would otherwise become a 0-d device array and crash
    # deep in the pipeline)
    lbda = lb_np
    seeing = np.atleast_1d(np.asarray(seeing, dtype=np.float64))
    GL = np.atleast_1d(np.asarray(GL, dtype=np.float64))
    L0 = np.atleast_1d(np.asarray(L0, dtype=np.float64))

    gs_mask = np.atleast_2d(np.asarray(gs_mask, dtype=np.float64))
    B = seeing.shape[0]
    if B == 0:
        raise ValueError("empty batch: no telemetry rows to reconstruct "
                         "(seeing/GL/L0 arrays have length 0)")

    # rows outside the certified split range (L0 < dphi_split_l0_min or
    # non-finite) get their own exact-transform group instead of
    # disabling the split for the whole batch
    split_bad = np.zeros(B, bool)
    if cfg.use_dphi_split:
        split_bad = ~(np.isfinite(L0) & (L0 >= cfg.dphi_split_l0_min))

    if force_full:
        # guard-redo path: the ORIGINAL config's full-window executable
        # (otf_support=0 <-> full window share the jit static key only
        # when the field itself is 0); any blue-segment split is cleared
        # too — the guard that sent us here may have tripped on the blue
        # sub-window boundary
        g0 = (cfg.with_(otf_support=0, otf_blue=None)
              if (cfg.otf_support or cfg.otf_blue is not None) else cfg)
        groups = [(g0, np.arange(B))]
        if split_bad.any():
            groups = [(g0.with_(use_dphi_split=False),
                       np.nonzero(split_bad)[0])]
            if (~split_bad).any():
                groups.insert(0, (g0, np.nonzero(~split_bad)[0]))
    else:
        groups = []
        if split_bad.any():
            groups.append((cfg.with_(use_dphi_split=False),
                           np.nonzero(split_bad)[0]))
        rest = np.nonzero(~split_bad)[0]
        if rest.size:
            # telemetry-aware OTF-support buckets: rows whose OTF
            # provably fits the reduced window run the cheap variant,
            # the rest the full one; the in-pipeline window guard
            # backstops the host-side bound
            sub = [(cfg, rest)]
            # a pinned otf_blue is a pinned-window config: bucketing
            # could otherwise assign otf_support == S_blue (invalid)
            if (cfg.otf_support == 0 and cfg.otf_window is not None
                    and cfg.otf_blue is None):
                bq = default_support_bucket(cfg)
                if bq < cfg.dim // 2:
                    okw = rows_windowable(
                        seeing[rest], GL[rest], L0[rest], gs_mask[rest],
                        float(lb_np.max()), cfg, bq, h=h_t,
                        wind_speed=wind_speed, npsflin=npsflin)
                    cfg_w = cfg.with_(otf_support=bq)
                    if okw.all():
                        sub = [(cfg_w, rest)]
                    elif okw.any():
                        sub = [(cfg_w, rest[okw]), (cfg, rest[~okw])]
            groups += sub

    # blue-segment window split (cfg.otf_blue): the bluest wavelengths
    # of each group run on a half-bucket window when the host admission
    # model certifies it for the group's rows (see _blue_split_plan) —
    # only on the auto-bucketed path (an explicit otf_support pins one
    # window; force_full is the guard-redo escape hatch)
    if not force_full and cfg.otf_support == 0:
        groups = _blue_split_plan(groups, seeing, GL, L0, gs_mask, lb_np,
                                  h_t, wind_speed, npsflin,
                                  clamped_chunk(chunk, B, mesh))

    # clamp the chunk to the batch (smaller nights would pad pointlessly)
    # — EXCEPT on the guard-redo path: the redo subset is usually smaller
    # than one chunk, and shrinking would trace a fresh (B, 7) static
    # shape, i.e. a multi-minute recompile; the redo call sites pass the
    # ORIGINAL batch's clamped chunk so its executables are reused
    # (padding is cheap there)
    chunk = clamped_chunk(chunk, B, mesh) if not force_full \
        else clamped_chunk(chunk, chunk, mesh)

    sharding = None
    if mesh is not None:
        sharding = NamedSharding(mesh, P("rows"))

    table = np.concatenate(
        [seeing[:, None], GL[:, None], L0[:, None], gs_mask], axis=1)
    return (cfg, groups, chunk, table, lbda, h_t, wind_speed, sharding,
            npixc)


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One bucket group's dispatch schedule (pure data, no device state).

    ``rows`` are input-row indices in dispatch order; the group's padded
    telemetry table is ``table[rows]`` extended by ``sum(sizes) -
    len(rows)`` repeats of its last row.  ``sizes[i]`` is the i-th
    dispatch's static chunk size (the jit static key together with
    ``cfg``), ``nvals[i]`` how many of its rows are real, ``offs[i]``
    its row offset into the padded group table.
    """
    cfg: GalacsiConfig
    rows: np.ndarray
    sizes: tuple
    nvals: tuple
    offs: tuple

    @property
    def n_pad(self) -> int:
        return int(sum(self.sizes)) - int(self.rows.shape[0])


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """The complete, inspectable plan of a batch run.

    A pure function of (telemetry, wavelength grid, npsflin, cfg, chunk,
    mesh size) — no device arrays, no side effects — produced by
    :func:`plan_batch` and executed by :func:`process_batch`.  Golden
    plans for the bench nights are pinned by
    ``tests/test_batch_plan.py`` so planner changes that alter the
    dispatch schedule are caught as diffs, not throughput regressions.
    """
    cfg: GalacsiConfig            # resolved base config
    chunk: int                    # clamped main chunk size
    npsflin: int
    use_tail: bool
    lbda: np.ndarray              # normalised host wavelength grid [nm]
    npixc: np.ndarray             # per-wavelength crop sizes (int32,
                                  # decided in host float64 — the
                                  # banker's-rounding QUIRK of
                                  # otf/psf.py:lambda_crop_size)
    h: tuple                      # layer altitudes
    wind_speed: float
    table: np.ndarray             # (B, 7) normalised telemetry
    groups: tuple                 # of GroupPlan, dispatch order

    def executable_keys(self):
        """The distinct (group_cfg, chunk_size) executables the dispatch
        loop needs — the compile set a warm-up must cover."""
        keys = []
        for g in self.groups:
            for s in g.sizes:
                if (g.cfg, s) not in keys:
                    keys.append((g.cfg, s))
        return keys

    def summary(self) -> dict:
        """JSON-serializable plan summary (golden-plan test target).

        Group configs are recorded as deltas against the resolved base
        config, so new planner dimensions show up automatically and the
        summary stays insensitive to backend-resolved base fields
        (``use_fft`` on FFT-less runtimes) that do not differ per group.
        """
        def _j(v):
            if isinstance(v, (np.integer,)):
                return int(v)
            if isinstance(v, (np.floating,)):
                return float(v)
            if isinstance(v, (tuple, list)):
                return [_j(x) for x in v]
            return v

        groups = []
        for g in self.groups:
            delta = {}
            for f in dataclasses.fields(GalacsiConfig):
                a, b = getattr(self.cfg, f.name), getattr(g.cfg, f.name)
                if a != b:
                    delta[f.name] = _j(b)
            groups.append({
                "cfg_delta": delta,
                "rows": [int(i) for i in g.rows],
                "sizes": [int(s) for s in g.sizes],
                "nvals": [int(n) for n in g.nvals],
                "offs": [int(o) for o in g.offs],
            })
        return {
            "chunk": int(self.chunk),
            "npsflin": int(self.npsflin),
            "use_tail": bool(self.use_tail),
            "nl": int(self.lbda.size),
            "npixc": [int(n) for n in np.asarray(self.npixc)],
            "n_rows": int(self.table.shape[0]),
            "groups": groups,
        }


def _tail_size(chunk_n: int, rem: int) -> int:
    """Smallest size from the fixed tail menu {c/4, c/2, 3c/4} covering
    ``rem`` leftover rows (falls back to the full chunk)."""
    for num, den in ((1, 4), (1, 2), (3, 4)):
        t = max(1, chunk_n * num // den)
        if t >= rem:
            return t
    return chunk_n


_PLAN_MEMO = {}
_PLAN_MEMO_MAX = 8


def plan_batch(seeing, GL, L0, gs_mask, lbda, h=(100, 10000),
               npsflin: int = 1, cfg: GalacsiConfig = None,
               chunk: int = 8, mesh: Mesh = None, force_full=False,
               use_tail: bool = None) -> BatchPlan:
    """Build the complete :class:`BatchPlan` for a batch run.

    Pure host-side planning: validation, backend config resolution,
    OTF-support bucketing, blue-segment splits (:func:`_plan_batch`), then the per-group dispatch schedule —
    tail-chunk policy (the last partial chunk of a REDUCED-WINDOW bucket
    dispatches at the smallest covering size from the fixed menu
    {c/4, c/2, 3c/4}; full-window groups always pad so the guard-redo
    can reuse their executable; disabled on the mesh path where chunks
    are mesh-multiples, and by ``MUSE_PSFR_NO_TAIL=1``) and padding
    counts.  No device arrays are created.
    """
    seeing = np.atleast_1d(np.asarray(seeing, np.float64))
    GL = np.atleast_1d(np.asarray(GL, np.float64))
    L0 = np.atleast_1d(np.asarray(L0, np.float64))
    gs_mask = np.atleast_2d(np.asarray(gs_mask, np.float64))
    if use_tail is None:
        use_tail = (not force_full
                    and not os.environ.get("MUSE_PSFR_NO_TAIL"))
    # the plan is a pure function of its inputs (plus the planning env
    # knobs): re-planning an identical batch — e.g. repeated nights of
    # the same telemetry — is wasted host time.
    # Tiny keyed memo; env knobs that alter planning are part of the key.
    memo_key = None
    try:
        memo_key = (seeing.tobytes(), GL.tobytes(), L0.tobytes(),
                    gs_mask.tobytes(),
                    np.asarray(lbda, np.float64).tobytes(),
                    tuple(np.asarray(h, np.float64).ravel()), npsflin,
                    cfg, chunk,
                    (None if mesh is None
                     else (mesh.size, tuple(mesh.axis_names))),
                    bool(force_full), bool(use_tail),
                    os.environ.get("MUSE_PSFR_NO_BLUE"),
                    os.environ.get("MUSE_PSFR_BLUE_TIERS"))
        hit = _PLAN_MEMO.get(memo_key)
        if hit is not None:
            return hit
    except Exception:  # noqa: BLE001 — unhashable input: skip the memo
        memo_key = None
    (cfg_r, groups, chunk_n, table, lb_np, h_t, wind_speed, sharding,
     npixc) = _plan_batch(seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg,
                          chunk, mesh, force_full)
    gplans = []
    for gcfg, gidx in groups:
        gb = gidx.shape[0]
        n_main, rem = divmod(gb, chunk_n)
        if rem and use_tail and sharding is None and gcfg.otf_support:
            tail = _tail_size(chunk_n, rem)
        else:
            tail = chunk_n if rem else 0
        sizes = tuple([chunk_n] * n_main + ([tail] if rem else []))
        nvals = tuple([chunk_n] * n_main + ([rem] if rem else []))
        offs = tuple(int(o) for o in
                     np.concatenate([[0], np.cumsum(sizes)[:-1]]))
        gplans.append(GroupPlan(gcfg, gidx, sizes, nvals, offs))
    # freeze the plan's arrays: the memo shares one BatchPlan across
    # calls, and the executor hands on_chunk/on_final VIEWS of
    # groups[].rows — an (incorrect) in-place mutation by a sink must
    # fail loudly, not silently corrupt the cached plan.  lb_np may
    # alias the caller's array, so it is copied before freezing.
    lb_np = np.array(lb_np)
    for arr in (table, npixc, lb_np, *(g.rows for g in gplans)):
        arr.setflags(write=False)
    plan = BatchPlan(cfg_r, chunk_n, npsflin, bool(use_tail), lb_np,
                     npixc, h_t, float(wind_speed), table,
                     tuple(gplans))
    if memo_key is not None:
        if len(_PLAN_MEMO) >= _PLAN_MEMO_MAX:
            _PLAN_MEMO.pop(next(iter(_PLAN_MEMO)))
        _PLAN_MEMO[memo_key] = plan
    return plan


def _run_chunks(seeing, GL, L0, gs_mask, lbda, h=(100, 10000),
                npsflin: int = 1, cfg: GalacsiConfig = None,
                chunk: int = 8, mesh: Mesh = None, force_full=False):
    """Yield (row_indices, psf_chunk, window_guard) over padded chunks;
    the arrays stay on device.  ``row_indices`` maps the chunk's first
    ``len(row_indices)`` results back to input rows — rows are bucketed
    by OTF support (:func:`_plan_batch`), so chunks do NOT arrive in
    input order.  A negative ``window_guard`` means the OTF-support
    window was too small for some row of the chunk (see
    :func:`_window_guard`) and the caller must recompute those rows with
    the full window (``cfg.with_(otf_support=cfg.dim // 2)``).

    ``chunk`` bounds the per-step working set (each item holds an
    (ndir, dim, dim) PSD cube on device).  With ``mesh``, each chunk's
    batch axis is sharded across the mesh's devices; ``chunk`` is rounded
    up to a multiple of the mesh size and each bucket padded accordingly.
    All chunks are dispatched with identical shapes (one compilation per
    bucket).
    """
    lbda_host = lbda               # original value, for the redo re-plan
    (cfg, groups, chunk, table, lbda, h_t, wind_speed, sharding,
     npixc) = _plan_batch(seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg,
                          chunk, mesh, force_full)
    lbda = jnp.asarray(lbda, cfg.dtype)
    npixc = jnp.asarray(npixc)   # one push, not one per chunk dispatch
    mesh = None if sharding is None else sharding.mesh

    if sharding is None and not force_full:
        # one executable per bucket group here (no tails on this path);
        # compile them concurrently before the first dispatch
        specs = {}
        for gcfg, gidx in groups:
            gt = table[gidx]
            if gt.shape[0] < chunk:
                gt = np.concatenate(
                    [gt, np.repeat(gt[-1:], chunk - gt.shape[0], axis=0)],
                    axis=0)
            specs.setdefault((gcfg, chunk), gt)
        _redo_warm_specs(specs, chunk, seeing, GL, L0, gs_mask,
                         lbda_host, h, npsflin, cfg,
                         any(gcfg.otf_support or gcfg.otf_blue is not None
                             for gcfg, _ in groups))
        _warm_programs(specs, "recon", lbda, npixc, h_t, wind_speed,
                       npsflin)

    # single-push run: ONE H2D transfer carries every group's padded
    # telemetry and ONE more every chunk's global offset (every push
    # pays command latency) — see the same policy in process_batch.  Chunks dynamic-slice at their global
    # offset: traced offset + static size, so the slice compiles once
    # for any batch size and any chunk position, and the full table
    # shape never reaches the pipeline executable.
    night = None
    if sharding is None:
        gts, offs_all, base = [], [], 0
        for gcfg, gidx in groups:
            gb = gidx.shape[0]
            gt = table[gidx]
            n_pad = (-gb) % chunk
            if n_pad:
                gt = np.concatenate(
                    [gt, np.repeat(gt[-1:], n_pad, axis=0)], axis=0)
            gts.append(gt)
            offs_all.append(base + np.arange(0, gb, chunk))
            base += gt.shape[0]
        if gts:
            night = (jnp.asarray(np.concatenate(gts, axis=0), cfg.dtype),
                     jnp.asarray(np.concatenate(offs_all), jnp.int32))

    for g_i, (gcfg, gidx) in enumerate(groups):
        gb = gidx.shape[0]
        if sharding is None:
            table_d, offs_d = night
            j0 = int(sum(o.size for o in offs_all[:g_i]))
            for ci, lo in enumerate(range(0, gb, chunk)):
                t = jax.lax.dynamic_slice_in_dim(
                    table_d, offs_d[j0 + ci], chunk, axis=0)
                res, guard = _reconstruct_chunk(t, lbda, npixc, h_t,
                                                wind_speed, npsflin, gcfg)
                yield gidx[lo:lo + chunk], res, guard
            continue
        gt = table[gidx]
        n_pad = (-gb) % chunk
        if n_pad:
            gt = np.concatenate([gt, np.repeat(gt[-1:], n_pad, axis=0)],
                                axis=0)

        # mesh path: ONE host->device push of the padded bucket table
        # (per-chunk pushes dominated: n_chunks transfers vs one for the
        # same bytes), laid out (n_chunks, chunk, 7) with the *chunk*
        # axis sharded across the mesh.  Each chunk is then a static
        # slice along the unsharded leading axis — device-local, no
        # cross-device gather (a traced-offset slice of a row-sharded
        # axis would make XLA conservatively all-gather).
        n_chunks = gt.shape[0] // chunk
        table_d = jax.device_put(
            jnp.asarray(gt.reshape(n_chunks, chunk, gt.shape[1]),
                        gcfg.dtype),
            NamedSharding(mesh, P(None, "rows")))
        for i in range(n_chunks):
            t = jax.device_put(table_d[i], sharding)  # no-op reshard
            res, guard = _reconstruct_vmapped(t[:, 0], t[:, 1], t[:, 2],
                                              t[:, 3:7], lbda, npixc,
                                              h_t, wind_speed, npsflin,
                                              gcfg)
            res, guard = _replicate_for_host(mesh, res, guard)
            yield gidx[i * chunk:(i + 1) * chunk], res, guard


def reconstruct_batch(seeing, GL, L0, gs_mask, lbda, h=(100, 10000),
                      npsflin: int = 1, cfg: GalacsiConfig = None,
                      chunk: int = 8, mesh: Mesh = None,
                      _force_full=False):
    """Reconstruct PSF cubes for a batch of work items.

    Parameters are (B,)-shaped arrays (``gs_mask``: (B, 4) float validity
    mask).  Returns a (B, nl, dimpsf, dimpsf) numpy array.  Note: this
    pulls every PSF to the host; for fit-oriented workflows prefer
    :func:`process_batch`, which keeps the cubes on device.
    """
    seeing = np.atleast_1d(np.asarray(seeing, np.float64))
    GL = np.atleast_1d(np.asarray(GL, np.float64))
    L0 = np.atleast_1d(np.asarray(L0, np.float64))
    gs_mask = np.atleast_2d(np.asarray(gs_mask, np.float64))
    out = None
    for idx, res, guard in _run_chunks(seeing, GL, L0, gs_mask, lbda, h,
                                       npsflin, cfg, chunk, mesh,
                                       _force_full):
        psf_np, guard_np = pull_packed(res, guard)
        if out is None:
            out = np.empty((seeing.shape[0],) + psf_np.shape[1:],
                           psf_np.dtype)
        if float(guard_np) < 0.0:
            # the auto OTF-support window was too small for this chunk's
            # telemetry: recompute these rows with the full window
            # (same config -> the full bucket's executable is reused)
            logger.warning(
                "OTF-support window guard tripped (margin %.2f); "
                "recomputing %d rows with the full window",
                float(guard_np), len(idx))
            out[idx] = reconstruct_batch(
                seeing[idx], GL[idx], L0[idx], gs_mask[idx], lbda, h,
                npsflin, cfg, clamped_chunk(chunk, seeing.shape[0], mesh),
                mesh, _force_full=True)
        else:
            out[idx] = psf_np[:len(idx)]
    return out


def pull_packed(*arrays):
    """Pull several device arrays to the host in ONE transfer.

    Every device->host pull pays a fixed latency; concatenating the
    raveled arrays on device and pulling once amortises it across all
    results.  Returns
    the arrays as numpy, original shapes restored.
    """
    arrays = [jnp.asarray(a) for a in arrays]
    shapes = [a.shape for a in arrays]
    dt = jnp.result_type(*arrays)
    flat_d = jnp.concatenate([jnp.ravel(a).astype(dt) for a in arrays])
    if not os.environ.get("MUSE_PSFR_NO_ASYNC_FINAL"):
        # issue the D2H copy command NOW, before blocking: the host
        # reaches this point while chunk compute is still in flight
        # (everything upstream is async), so the transfer request rides
        # the command stream behind the compute and the bytes start
        # flowing the moment the result materialises — instead of
        # paying a ready-notification round trip first.  A/B knob:
        # MUSE_PSFR_NO_ASYNC_FINAL=1.
        try:
            flat_d.copy_to_host_async()
        except Exception:  # noqa: BLE001 - plain sync pull below
            pass
    flat = np.asarray(flat_d)
    out, off = [], 0
    for s in shapes:
        n = int(np.prod(s)) if s else 1
        out.append(flat[off:off + n].reshape(s))
        off += n
    return out


def process_batch(seeing, GL, L0, gs_mask, lbda, h=(100, 10000),
                  npsflin: int = 1, cfg: GalacsiConfig = None,
                  chunk: int = 8, mesh: Mesh = None,
                  fit_dtype: str = None, on_chunk=None, on_redo_start=None,
                  on_final=None, _force_full=False, _return_parts=False):
    """Full device-resident batch: reconstruct, Moffat-fit, and average.

    Returns ``(fit_packed, psf_mean, fit_mean_packed)`` — numpy arrays:
    per-item per-wavelength packed Moffat parameters (B, nl, N_PACKED)
    (see :data:`muse_psfr_tpu.fit.moffat_fit.PACKED_FIELDS`), the
    (nl, dimpsf, dimpsf) mean PSF cube, and its packed fit.  Only these
    small arrays ever cross to the host: every ``MUSE_PSFR_PULL_PART``
    chunks (default: half the night's chunks, capped to [2, 8]; single
    pull under 4 chunks) the accumulated packed fits start an async
    device->host copy that overlaps later compute — with the last part
    forced at the penultimate chunk (``MUSE_PSFR_PULL_AT`` overrides
    the cut positions outright) — and one final packed transfer
    carries the remainder, the mean arrays, and the per-chunk window
    guards; the (B, nl, dimpsf, dimpsf) PSF cubes never leave the
    device.  Unpack with
    :func:`muse_psfr_tpu.fit.moffat_fit.unpack_fit`.

    When the OTF-support window guard trips, ONLY the rows of the
    tripped chunks are recomputed with the full window (the per-chunk
    guard vector rides the packed result pull); the mean PSF and its
    fit are corrected on device from the redone rows' sums.  Untripped
    chunks — in particular everything already in the full-window bucket
    — are never recomputed.

    ``on_chunk(row_indices, packed_numpy)`` is an optional incremental
    sink called after each chunk completes, with the input-row indices
    the chunk covers — chunks do NOT arrive in input order (rows are
    bucketed by OTF support).  On a window-guard trip, ``on_chunk`` is
    called AGAIN for the redone rows with the corrected values (same
    indices as an earlier call): sinks must treat the indices as keys
    (index an array, as :func:`muse_psfr_tpu.api.condition_sweep` does),
    not append.  The reference has nothing comparable; use it to
    checkpoint long sweeps — it pulls each chunk's packed fits to the
    host, which costs one small transfer per chunk.

    ``on_redo_start(row_indices)`` is called once, BEFORE the redo
    dispatch, with the input-row indices about to be recomputed — their
    earlier ``on_chunk`` values are stale (too-small window).  Durable
    sinks must un-mark those rows until the corrected ``on_chunk`` call
    arrives: otherwise a crash between the stale delivery and the
    corrected one would persist the wrong values as done (the
    checkpoint/resume path of :func:`muse_psfr_tpu.api.condition_sweep`
    does exactly this).

    ``on_final(row_indices)`` is called when rows' values become FINAL
    — i.e. provably not subject to a window-guard redo: right after
    delivery for chunks of guard-free groups (groups dispatched with
    ``otf_support=0`` and no blue sub-window, whose guard is
    structurally +inf — the pure full-window bucket, and every group
    when the base config is full-window — so a mid-night crash resumes
    past them), once for
    all rows of untripped
    reduced-window chunks (after the guard vector is pulled), and once
    more for the redone rows (after their corrected values are
    delivered).  An ``on_chunk`` delivery alone is provisional: the
    guard is only known at the night's final pull, so a durable sink
    that marks rows complete at ``on_chunk`` time can persist
    too-small-window values across a crash + resume.  Mark completion
    in ``on_final``, store values in ``on_chunk``.

    ``_return_parts`` (internal, redo path): return the device-resident
    ``(fit_packed, psf_sum, guard_vec)`` without any host pull, mean, or
    guard handling.
    """
    from ..fit.moffat_fit import fit_moffat_cube_packed
    from ..utils.profiling import stage_timer, logger as profile_logger
    cfg = cfg or GalacsiConfig()
    fit_dtype = fit_dtype or cfg.fit_dtype
    seeing = np.atleast_1d(np.asarray(seeing, np.float64))
    GL = np.atleast_1d(np.asarray(GL, np.float64))
    L0 = np.atleast_1d(np.asarray(L0, np.float64))
    gs_mask = np.atleast_2d(np.asarray(gs_mask, np.float64))

    with stage_timer("batch.plan"):
        plan = plan_batch(seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg,
                          chunk, mesh, _force_full)
    cfg_r, chunk_n, table = plan.cfg, plan.chunk, plan.table
    h_t, wind_speed = plan.h, plan.wind_speed
    lbda_j = jnp.asarray(plan.lbda, cfg_r.dtype)
    # ONE device push for the crop-size vector: a numpy jit argument
    # would re-transfer host->device on EVERY chunk dispatch
    npixc_j = jnp.asarray(plan.npixc)
    sharding = None if mesh is None else NamedSharding(mesh, P("rows"))

    fits, idxs, psums, guards = [], [], [], []
    gfree = []             # per chunk: guard structurally +inf (no window)
    parts = []             # device concats already copying to the host
    part_start = 0         # fits index where the unpulled remainder begins
    # pull-tail overlap: every `part_n` chunks the accumulated packed
    # fits start a device->host copy (copy_to_host_async) while later
    # chunks compute, so the transfer rides under tail compute and the
    # final pull carries only the remainder + the small mean arrays
    # (benchmarks/measure_pull_overlap.py); disable with
    # MUSE_PSFR_NO_OVERLAP=1, tune with MUSE_PSFR_PULL_PART (chunks).
    # Default: half the night's chunks, capped to [2, 8]; nights under
    # 4 chunks keep the single minimum-latency pull.
    total_chunks = sum(len(g.sizes) for g in plan.groups)
    default_part = (max(2, min(8, total_chunks // 2))
                    if total_chunks >= 4 else 0)
    if _return_parts or os.environ.get("MUSE_PSFR_NO_OVERLAP"):
        part_n = 0
    else:
        try:
            part_n = int(os.environ.get("MUSE_PSFR_PULL_PART", default_part))
        except ValueError:
            logger.warning("ignoring non-integer MUSE_PSFR_PULL_PART=%r",
                           os.environ["MUSE_PSFR_PULL_PART"])
            part_n = default_part
    # explicit cut schedule (A/B experiments): comma-separated chunk
    # counts after which to start a part copy, e.g. "2,5,8,10" — cuts
    # when the i-th chunk of the night has been enqueued.  Overrides the
    # stride logic; ignored on the redo path.
    cut_at = None
    env_cuts = os.environ.get("MUSE_PSFR_PULL_AT")
    if env_cuts and not _return_parts:
        # parsed regardless of part_n so the documented override of
        # BOTH other knobs holds on short (<4-chunk) and
        # MUSE_PSFR_NO_OVERLAP nights too, where part_n is 0
        try:
            cut_at = {int(x) for x in env_cuts.split(",") if x.strip()}
        except ValueError:
            logger.warning("ignoring malformed MUSE_PSFR_PULL_AT=%r",
                           env_cuts)

    def _cut_part():
        nonlocal part_start
        gf = (jnp.concatenate(fits[part_start:], axis=0)
              if len(fits) - part_start > 1 else fits[part_start])
        try:
            gf.copy_to_host_async()
        except Exception:  # noqa: BLE001 - plain sync pull later
            pass
        parts.append(gf)
        part_start = len(fits)

    def _maybe_part():
        if cut_at is not None:
            if len(fits) in cut_at and len(fits) > part_start:
                _cut_part()
            return
        # the FIRST part cuts at half size: the transfer (bytes + a
        # fixed latency per pull) needs a head start to drain under the
        # remaining compute; later parts are full-size to bound the
        # per-pull latency count; the LAST part is forced at the
        # penultimate chunk so the final (serialized) pull carries one
        # chunk + the mean arrays instead of a multi-chunk byte
        # remainder (benchmarks/measure_pull_schedule.py)
        need = part_n if parts else max(1, part_n // 2)
        if part_n > 0 and len(fits) > part_start and (
                len(fits) - part_start >= need
                or len(fits) == total_chunks - 1):
            _cut_part()

    # tail-chunk policy (the last partial chunk of a REDUCED-WINDOW
    # bucket dispatches at the smallest covering size from the fixed
    # {c/4, c/2, 3c/4} menu; full-window groups always pad so the
    # guard-redo can reuse their executable; A/B knob MUSE_PSFR_NO_TAIL)
    # and dispatch schedule come from the plan — see :func:`plan_batch`.
    # Only the padded telemetry slices are materialised here.
    plans = []
    for g in plan.groups:
        gt = table[g.rows]
        if g.n_pad:
            gt = np.concatenate(
                [gt, np.repeat(gt[-1:], g.n_pad, axis=0)], axis=0)
        plans.append((g.cfg, g.rows, gt, g.sizes, g.nvals, g.offs))

    if sharding is None and not _force_full:
        # compile every executable the dispatch loop will need,
        # CONCURRENTLY, before the first dispatch (the redo path reuses
        # the main night's full-window executable — warmed explicitly
        # below when no full-window group exists — so it skips the
        # warm-up itself)
        specs = {}
        for gcfg, _, gt, sizes, _, _ in plans:
            for s in sizes:
                specs.setdefault((gcfg, s), gt)
        # when any group can trip the window guard, warm the redo
        # executables too: on an all-windowed night they exist in no
        # plan and a trip would otherwise compile MID-NIGHT (this path
        # only runs when warming is enabled; lazy deployments pay the
        # compile on a trip — rare by the estimator's 3-decade margin)
        _redo_warm_specs(specs, chunk_n, seeing, GL, L0, gs_mask,
                         lbda, h, npsflin, cfg,
                         any(gcfg.otf_support or gcfg.otf_blue is not None
                             for gcfg, *_ in plans))
        with stage_timer("batch.warm"):
            _warm_programs(
                specs, "fit", lbda_j, npixc_j, h_t, wind_speed, npsflin,
                fit_dtype,
                mean_spec=((lbda_j.shape[0], cfg_r.dimpsf, cfg_r.dimpsf),
                           cfg_r.dtype))

    count = 0
    _t_disp = time.perf_counter()
    # single-push night: ONE H2D transfer carries every group's padded
    # telemetry (concatenated) and ONE more the global chunk offsets +
    # valid counts, instead of two pushes per bucket group (the blue
    # split makes 3-4 groups), each paying command latency.  Chunks
    # dynamic-slice out of the
    # one pushed table at their GLOBAL offset — values per chunk are
    # bit-identical to the per-group push.
    night_meta = None
    if sharding is None and plans:
        base = 0
        all_offs, all_nvals, bounds = [], [], []
        for _, _, gt_g, sizes_g, nvals_g, offs_g in plans:
            all_offs += [base + o for o in offs_g]
            all_nvals += list(nvals_g)
            bounds.append((len(all_offs) - len(sizes_g), len(all_offs)))
            base += gt_g.shape[0]
        table_all_d = jnp.asarray(
            np.concatenate([p[2] for p in plans], axis=0), cfg_r.dtype)
        meta_all_d = jnp.asarray(np.stack([all_offs, all_nvals]),
                                 jnp.int32)
        night_meta = (table_all_d, meta_all_d, bounds)
    for g_i, (gcfg, gidx, gt, sizes, nvals, offs) in enumerate(plans):
        n_chunks = len(sizes)
        # everything the per-chunk loop needs lives on device up front —
        # the loop then issues only async device ops (no H2D transfers,
        # no eager reductions): offset/valid-count scalars are sliced
        # from the night's one pushed array, and the fused _fit_chunk is
        # the single real dispatch per chunk
        if sharding is None:
            table_d, meta_all_d, bounds = night_meta
            j0 = bounds[g_i][0]
            for i in range(n_chunks):
                t = jax.lax.dynamic_slice_in_dim(
                    table_d, meta_all_d[0, j0 + i], sizes[i], axis=0)
                fit, psum, guard = _fit_chunk(
                    t, meta_all_d[1, j0 + i], lbda_j, npixc_j, h_t,
                    wind_speed, npsflin, gcfg, fit_dtype)
                n = int(nvals[i])
                fits.append(fit[:n])
                idxs.append(gidx[int(offs[i]):int(offs[i]) + n])
                psums.append(psum)
                guards.append(guard)
                gfree.append(not gcfg.otf_support
                             and gcfg.otf_blue is None)
                _maybe_part()
                if on_chunk is not None:
                    on_chunk(idxs[-1], np.asarray(fits[-1]))
                if on_final is not None and gfree[-1]:
                    # no window (and no blue sub-window) => the guard is
                    # +inf by construction and the rows can never be
                    # redone: final at delivery.  A crash mid-night then
                    # resumes past these chunks instead of recomputing
                    # the whole sweep.
                    on_final(idxs[-1])
                count += n
        else:
            meta_d = jnp.asarray(np.stack([offs, nvals]), jnp.int32)
            table_d = jax.device_put(
                jnp.asarray(gt.reshape(n_chunks, chunk_n, gt.shape[1]),
                            gcfg.dtype),
                NamedSharding(sharding.mesh, P(None, "rows")))
            for i in range(n_chunks):
                t = jax.device_put(table_d[i], sharding)
                fit, psum, guard = _fit_vmapped(
                    t[:, 0], t[:, 1], t[:, 2], t[:, 3:7],
                    meta_d[1, i], lbda_j, npixc_j, h_t, wind_speed,
                    npsflin, gcfg, fit_dtype)
                fit, psum, guard = _replicate_for_host(
                    sharding.mesh, fit, psum, guard)
                n = int(nvals[i])
                fits.append(fit[:n])
                idxs.append(gidx[int(offs[i]):int(offs[i]) + n])
                psums.append(psum)
                guards.append(guard)
                gfree.append(not gcfg.otf_support
                             and gcfg.otf_blue is None)
                _maybe_part()
                if on_chunk is not None:
                    on_chunk(idxs[-1], np.asarray(fits[-1]))
                if on_final is not None and gfree[-1]:
                    on_final(idxs[-1])
                count += n

    # enqueue-side wall time of the chunk loop (all dispatches are async:
    # device compute overlaps; this is pure host/dispatch overhead)
    profile_logger.debug("stage %-24s %8.3f ms", "batch.dispatch_enqueue",
                         (time.perf_counter() - _t_disp) * 1e3)
    total_psum = jnp.sum(jnp.stack(psums), axis=0)
    guard_vec = jnp.stack(guards)
    order = np.concatenate(idxs)
    in_order = np.array_equal(order, np.arange(count))
    if _return_parts:
        # redo path: hand the device arrays back for the on-device mean
        # correction; no pull, no mean fit (force_full => guards are +inf)
        fit = jnp.concatenate(fits, axis=0) if len(fits) > 1 else fits[0]
        if not in_order:
            fit = fit[jnp.asarray(np.argsort(order))]
        return fit, total_psum, guard_vec
    with stage_timer("batch.mean_enqueue"):
        psf_mean = total_psum / count
        fit_mean = fit_moffat_cube_packed(psf_mean, dtype=fit_dtype)
    # `parts` are already on their way to the host; the final packed
    # pull carries only the remainder + the mean arrays + the guards.
    # NOTE the pull timer absorbs ALL outstanding device compute (the
    # dispatches above are async) plus the transfer latency.
    rem = fits[part_start:]
    with stage_timer("batch.final_pull"):
        if rem:
            last_f = jnp.concatenate(rem, axis=0) if len(rem) > 1 else rem[0]
            last_np, psf_mean_np, fit_mean_np, guard_np = pull_packed(
                last_f, psf_mean, fit_mean, guard_vec)
            part_np = [np.asarray(p) for p in parts] + [last_np]
        else:
            psf_mean_np, fit_mean_np, guard_np = pull_packed(
                psf_mean, fit_mean, guard_vec)
            part_np = [np.asarray(p) for p in parts]
    fit_np = (np.concatenate(part_np, axis=0) if len(part_np) > 1
              else part_np[0])
    # the bucketed dispatch reorders rows: restore input order (on the
    # host - the data is already here)
    if not in_order:
        fit_np = fit_np[np.argsort(order)]
    # per-chunk window-guard check, piggybacked on the single result pull
    tripped = np.nonzero(guard_np < 0.0)[0]
    if on_final is not None:
        trip_set = set(int(i) for i in tripped)
        clear = [idxs[i] for i in range(len(idxs))
                 if i not in trip_set and not gfree[i]]
        if clear:
            on_final(np.concatenate(clear))
    if tripped.size == 0:
        return fit_np, psf_mean_np, fit_mean_np

    # surgical redo: ONLY the tripped chunks' rows are recomputed with
    # the full window (the ORIGINAL config's full-bucket executable is
    # reused); the mean PSF is corrected on device by swapping those
    # rows' contribution out of the already-accumulated sum
    redo_idx = np.concatenate([idxs[i] for i in tripped])
    logger.warning(
        "OTF-support window guard tripped for %d of %d chunks (worst "
        "margin %.2f); recomputing %d of %d rows with the full window",
        tripped.size, guard_np.shape[0], float(guard_np.min()),
        redo_idx.size, count)
    if on_redo_start is not None:
        on_redo_start(redo_idx)
    on_chunk_redo = None
    if on_chunk is not None:
        def on_chunk_redo(local_idx, packed_np):
            on_chunk(redo_idx[local_idx], packed_np)
    fit_redo, psum_redo, _ = process_batch(
        seeing[redo_idx], GL[redo_idx], L0[redo_idx], gs_mask[redo_idx],
        lbda, h, npsflin, cfg, chunk_n, mesh, fit_dtype, on_chunk_redo,
        _force_full=True, _return_parts=True)
    old_sub = jnp.sum(jnp.stack([psums[i] for i in tripped]), axis=0)
    psf_mean = (total_psum - old_sub + psum_redo) / count
    fit_mean = fit_moffat_cube_packed(psf_mean, dtype=fit_dtype)
    fit_redo_np, psf_mean_np, fit_mean_np = pull_packed(
        fit_redo, psf_mean, fit_mean)
    fit_np = np.array(fit_np)  # pull_packed views are read-only
    fit_np[redo_idx] = fit_redo_np
    if on_final is not None:
        on_final(redo_idx)      # corrected values delivered above
    return fit_np, psf_mean_np, fit_mean_np
