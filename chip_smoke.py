#!/usr/bin/env python3
"""Smoke test of the PSF-reconstruction main path on NVIDIA GPUs.

    python chip_smoke.py           # one card, every phase below
    python chip_smoke.py --four    # four cards: the row-sharded 1000-row
                                   # night against the same rows on one card

One-card phases, each through the entry points a user calls, at the
production widths (1280^2 grid, 35 wavelengths, float32 with every matmul
at ``Precision.HIGHEST``):

1. device: refuse any platform but ``gpu``; print the card line;
2. CLI golden: ``muse-psfr --values 1,0.7,25`` in-process, FWHM/BETA
   against the reference goldens, the output file's HDUs;
3. SPARTA file path: a multi-row table through ``compute_psf_from_sparta``
   with the LGS mean and per laser;
4. 100-row x 35-lambda night (npsflin=1, chunk 50) through
   ``process_batch``: plan groups, cold and warm times, the pinned row's
   rms against the float64 golden;
5. 9-direction night (npsflin=3): 100 rows at chunk 44 and one 88-row
   chunk, ``memory_analysis()`` of the largest chunk program, and the
   reference's npsflin=3 golden;
6. one 2048^2 row against the float64 NumPy oracle;
7. the tests marked ``gpu`` (tests/test_gpu.py), in this process.

Any failing phase ends the run with a non-zero exit and no result line.
Only when every phase passed is the last line of standard output
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Files go to ``chiprun_out/chip_smoke/`` under the checkout.
"""

import json
import os
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
GOLDEN_PSF = os.path.join(ROOT, "tests", "data",
                          "golden_psf_35l_s1.0_gl0.7_l025.npy")
RMS_BUDGET = 1e-5          # PSF rms against a float64 reference
GOLDEN_FWHM = (0.85, 0.73, 0.62)   # reference test_psfrec.py:121-128
GOLDEN_BETA = (2.73, 2.55, 2.23)
GOLDEN_TOL = 0.01
HDU_NAMES = ["PRIMARY", "SPARTA_ATM_DATA", "FIT_ROWS", "FIT_MEAN",
             "PSF_MEAN"]
# four cards against one, relative to each field's scale.  The per-card
# programs see 25-row instead of 100-row batches, so float32 sums can
# round differently.  The mean PSF must agree to 1e-6 (measured on four
# H100s: 1.73e-7).  The 20-iteration Moffat fit amplifies those
# rounding-level PSF differences (measured: 7.5e-5 on flux, the largest
# field), so the fit gate sits 4x above that reading
SHARDED_PSF_RTOL = 1e-6
SHARDED_FIT_RTOL = 3e-4
FIT_PARAMS = ("cy", "cx", "flux", "peak", "fwhm", "n")


class PhaseFailed(AssertionError):
    """A phase's check did not hold."""


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def require_gpu(devices):
    """The device label of ``devices`` (platform, kind, count); exits
    with an error unless JAX's default device is an NVIDIA GPU."""
    d = devices[0]
    if d.platform != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU, but JAX's default "
                 f"device is {d.platform!r} ({d.device_kind})")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def result_line(device):
    """The last line of a run in which every phase passed."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": int(device["count"])}})


def rms(a, b):
    a = np.asarray(a, np.float64)
    return float(np.sqrt(np.mean((a - np.asarray(b, np.float64)) ** 2)))


def peak_bytes(device=None):
    """Peak device bytes in use so far in this process (``None`` where
    the backend keeps no memory statistics)."""
    import jax
    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(phase, **kw):
    kw["peak_bytes_in_use"] = peak_bytes()
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


def plan_groups(plan):
    """One line per dispatch group of a :class:`BatchPlan`."""
    return [{"otf_support": int(g.cfg.otf_support),
             "otf_blue": (list(map(int, g.cfg.otf_blue))
                          if g.cfg.otf_blue else None),
             "split": bool(g.cfg.use_dphi_split),
             "rows": int(g.rows.size), "sizes": list(map(int, g.sizes))}
            for g in plan.groups]


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


# --- phases -------------------------------------------------------------

def phase_device():
    import jax
    from benchmarks.device_label import card_line
    device = require_gpu(jax.devices())
    card = card_line()
    check(card is not None, "nvidia-smi gave no card line")
    print(card, flush=True)
    env = {k: v for k, v in sorted(os.environ.items())
           if k.startswith(("JAX_", "XLA_"))}
    report("device", jax=jax.__version__, kind=device["kind"],
           count=device["count"], env=env)
    return device


def phase_cli():
    from muse_psfr_tpu.cli import main
    from muse_psfr_tpu.io.fits import fits_open
    from muse_psfr_tpu.io.table import FitTable
    out = os.path.join(OUT, "cli_values.fits")
    log = os.path.join(OUT, "cli_values.log")
    if os.path.exists(log):
        os.remove(log)
    dt, _ = timed(lambda: main(["--values", "1,0.7,25", "--no-color",
                                "-o", out, "--logfile", log]))
    hdul = fits_open(out)
    names = [h.name for h in hdul]
    check(names == HDU_NAMES, f"CLI output HDUs {names}")
    fit = FitTable.from_hdu(hdul["FIT_MEAN"])
    fwhm, beta = np.asarray(fit["fwhm"])[:, 0], np.asarray(fit["n"])
    check(np.allclose(fwhm, GOLDEN_FWHM, atol=GOLDEN_TOL),
          f"CLI FWHM {fwhm} vs golden {GOLDEN_FWHM}")
    check(np.allclose(beta, GOLDEN_BETA, atol=GOLDEN_TOL),
          f"CLI BETA {beta} vs golden {GOLDEN_BETA}")
    report("cli", seconds=dt, fwhm=fwhm.tolist(), beta=beta.tolist(),
           hdus=names)


def phase_sparta():
    from muse_psfr_tpu import compute_psf_from_sparta, create_sparta_table
    from muse_psfr_tpu.io.table import FitTable
    path = os.path.join(OUT, "sparta_6rows.fits")
    create_sparta_table(nlines=6, seeing=0.9, GL=0.6, L0=22, bad_l0=True,
                        outfile=path)
    for mean_of_lgs in (True, False):
        dt, res = timed(lambda: compute_psf_from_sparta(
            path, mean_of_lgs=mean_of_lgs))
        check(res is not None, "compute_psf_from_sparta returned None")
        rows = FitTable.from_hdu(res["FIT_ROWS"])
        psf = np.asarray(res["PSF_MEAN"].data)
        check(psf.shape == (35, 40, 40), f"PSF_MEAN shape {psf.shape}")
        check(np.isfinite(psf).all(), "non-finite PSF_MEAN")
        fwhm = np.asarray(rows["fwhm"])
        check(np.isfinite(fwhm).all(), "non-finite FIT_ROWS fwhm")
        report("sparta", mean_of_lgs=mean_of_lgs, seconds=dt,
               fit_rows=int(fwhm.shape[0]))


def phase_night():
    from bench import build_rows
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.fit.moffat_fit import unpack_fit
    from muse_psfr_tpu.parallel.batch import (plan_batch, process_batch,
                                              reconstruct_batch)
    cfg = GalacsiConfig()
    lbda = np.linspace(490, 930, 35)
    n, chunk = 100, 50
    seeing, GL, L0, mask = build_rows(n)
    plan = plan_batch(seeing, GL, L0, mask, lbda, npsflin=1, cfg=cfg,
                      chunk=chunk)
    groups = plan_groups(plan)
    check(any(g["otf_support"] for g in groups)
          and any(not g["otf_support"] for g in groups),
          f"night plan lacks a reduced- or a full-window group: {groups}")

    def run():
        return process_batch(seeing, GL, L0, mask, lbda, npsflin=1,
                             cfg=cfg, chunk=chunk)

    cold, _ = timed(run)
    warm, (fit, psf_mean, fit_mean) = timed(run)
    f = unpack_fit(fit)
    check(fit.shape[:2] == (n, 35), f"fit shape {fit.shape}")
    check(np.isfinite(f["fwhm"]).all() and f["ok"].all(),
          "night fits not finite / not converged")
    check(np.isfinite(psf_mean).all(), "non-finite mean PSF")
    psf0 = reconstruct_batch(seeing[:chunk], GL[:chunk], L0[:chunk],
                             mask[:chunk], lbda, npsflin=1, cfg=cfg,
                             chunk=chunk)[0]
    r = rms(psf0, np.load(GOLDEN_PSF))
    check(r <= RMS_BUDGET, f"pinned-row rms {r:.3e} > {RMS_BUDGET}")
    report("night_npsflin1", rows=n, chunk=chunk, groups=groups,
           compile_and_first_run_s=cold, warm_s=warm, pinned_row_rms=r)


def phase_npsflin3():
    import jax.numpy as jnp
    from bench import build_rows
    from muse_psfr_tpu import HDUList, compute_psf_from_sparta, \
        create_sparta_table
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.fit.moffat_fit import unpack_fit
    from muse_psfr_tpu.io.table import FitTable
    from muse_psfr_tpu.parallel.batch import (_fit_chunk, plan_batch,
                                              process_batch)
    cfg = GalacsiConfig()
    lbda = np.linspace(490, 930, 35)
    seeing, GL, L0, mask = build_rows(100)

    # the largest chunk program of the 88-row night, compiled ahead to
    # read its memory plan before anything runs at that size
    plan = plan_batch(seeing[:88], GL[:88], L0[:88], mask[:88], lbda,
                      npsflin=3, cfg=cfg, chunk=88)
    big = max(plan.groups, key=lambda g: (
        g.cfg.otf_support == 0, g.cfg.otf_blue is None, max(g.sizes)))
    t = jnp.asarray(plan.table[:max(big.sizes)], cfg.dtype)
    compiled = _fit_chunk.lower(
        t, jnp.asarray(np.int32(t.shape[0])), jnp.asarray(plan.lbda,
                                                          cfg.dtype),
        jnp.asarray(plan.npixc), plan.h, plan.wind_speed, 3, big.cfg,
        cfg.fit_dtype).compile()
    print(f"[npsflin3] memory_analysis (chunk {t.shape[0]}, otf_support "
          f"{big.cfg.otf_support}, otf_blue {big.cfg.otf_blue}): "
          f"{compiled.memory_analysis()}", flush=True)

    for rows, chunk in ((100, 44), (88, 88)):
        def run():
            return process_batch(seeing[:rows], GL[:rows], L0[:rows],
                                 mask[:rows], lbda, npsflin=3, cfg=cfg,
                                 chunk=chunk)
        cold, _ = timed(run)
        warm, (fit, psf_mean, _) = timed(run)
        f = unpack_fit(fit)
        check(np.isfinite(f["fwhm"]).all() and f["ok"].all(),
              f"npsflin=3 fits not finite at chunk {chunk}")
        check(np.isfinite(psf_mean).all(), "non-finite mean PSF")
        report("npsflin3_night", rows=rows, chunk=chunk,
               groups=plan_groups(plan_batch(
                   seeing[:rows], GL[:rows], L0[:rows], mask[:rows], lbda,
                   npsflin=3, cfg=cfg, chunk=chunk)),
               compile_and_first_run_s=cold, warm_s=warm)

    # reference test_psfrec.py:22-31
    res = compute_psf_from_sparta(HDUList([create_sparta_table()]),
                                  npsflin=3, lmin=490, lmax=541.76, nl=5)
    fit = FitTable.from_hdu(res["FIT_ROWS"])
    lb1, fwhm1 = float(fit["lbda"][1]), float(np.asarray(fit["fwhm"])[1][0])
    centre = np.asarray(fit["center"])
    check(abs(lb1 - 502.9) <= 0.1, f"npsflin=3 golden lbda {lb1}")
    check(abs(fwhm1 - 0.85) <= GOLDEN_TOL, f"npsflin=3 FWHM {fwhm1}")
    check(np.allclose(centre, 20, atol=1e-4),
          f"npsflin=3 Moffat centre {centre.min()}..{centre.max()}")
    report("npsflin3_golden", lbda=lb1, fwhm=fwhm1)


def phase_highres():
    from benchmarks import oracle_numpy as oracle
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import reconstruct_batch
    lbda = np.linspace(490, 930, 35)
    seeing, GL, L0 = 1.0, 0.7, 25.0
    ref = {}

    def host_oracle():
        psd = oracle.simulate_psd([GL, 1 - GL], (100, 10000), seeing, L0,
                                  npsflin=1, dim=2048)[0]
        psf = oracle.psf_cube_from_psd(psd, lbda)
        ref["psf"] = oracle.convolve_tt_and_instrument(psf, lbda, seeing,
                                                       GL, L0)

    th = threading.Thread(target=host_oracle)
    th.start()
    cfg = GalacsiConfig(dim=2048)
    dt, out = timed(lambda: reconstruct_batch(
        [seeing], [GL], [L0], np.ones((1, 4)), lbda, cfg=cfg, chunk=1))
    th.join()
    check("psf" in ref, "the float64 oracle failed")
    check(out.shape == (1, 35, 40, 40), f"2048^2 cube shape {out.shape}")
    r = rms(out[0], ref["psf"])
    check(r <= RMS_BUDGET, f"2048^2 rms vs oracle {r:.3e} > {RMS_BUDGET}")
    report("highres_2048", compile_and_run_s=dt, rms_vs_oracle=r)


def phase_gpu_tests():
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    counter = Count()
    os.environ["MUSE_PSFR_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[counter])
    check(rc == 0, f"gpu-marked tests exited {rc}")
    check(counter.passed > 0, "no gpu-marked test ran")
    report("gpu_tests", passed=counter.passed)


def sharded_night(devices, n_rows=1000, chunk=100, cfg=None, lbda=None):
    """A night of ``n_rows`` sharded over a 1-D row mesh of ``devices``
    against the same rows on ``devices[0]`` alone.  Returns the largest
    relative differences (fit parameters, mean PSF) and the times."""
    import jax
    from bench import build_rows
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.fit.moffat_fit import PACKED_FIELDS
    from muse_psfr_tpu.parallel.batch import process_batch
    from muse_psfr_tpu.parallel.mesh import default_mesh
    cfg = cfg or GalacsiConfig()
    lbda = np.linspace(490, 930, 35) if lbda is None else lbda
    seeing, GL, L0, mask = build_rows(n_rows)
    mesh = default_mesh(devices)

    def run(m):
        return process_batch(seeing, GL, L0, mask, lbda, npsflin=1,
                             cfg=cfg, chunk=chunk, mesh=m)

    cold_mesh, _ = timed(lambda: run(mesh))
    warm_mesh, (fit_m, mean_m, fitm_m) = timed(lambda: run(mesh))
    with jax.default_device(devices[0]):
        cold_one, _ = timed(lambda: run(None))
        warm_one, (fit_1, mean_1, fitm_1) = timed(lambda: run(None))

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(b).max(), np.finfo(np.float64).tiny)
        return float(np.abs(a - b).max() / scale)

    diffs = {name: max(rel(fit_m[..., k], fit_1[..., k]),
                       rel(fitm_m[..., k], fitm_1[..., k]))
             for k, name in enumerate(PACKED_FIELDS)}
    diffs["psf_mean"] = rel(mean_m, mean_1)
    return {"rows": n_rows, "chunk": chunk, "devices": len(devices),
            "rel_diff": diffs,
            "mesh_compile_and_first_run_s": cold_mesh,
            "mesh_warm_s": warm_mesh,
            "one_card_compile_and_first_run_s": cold_one,
            "one_card_warm_s": warm_one}


def phase_four():
    import jax
    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 GPUs, JAX sees {len(devs)}")
    res = sharded_night(devs[:4])
    report("four_cards", **res)
    d = res["rel_diff"]
    check(d["psf_mean"] <= SHARDED_PSF_RTOL,
          f"sharded mean PSF differs from one card by {d['psf_mean']:.3e}")
    worst = max(d[k] for k in FIT_PARAMS)
    check(worst <= SHARDED_FIT_RTOL,
          f"sharded fits differ from one card by {worst:.3e} relative")
    check(d["ok"] == 0.0, "sharded and one-card convergence flags differ")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    unknown = [a for a in argv if a != "--four"]
    if unknown:
        sys.exit(f"chip_smoke: unknown arguments {unknown}")
    device = phase_device()
    os.makedirs(OUT, exist_ok=True)
    if four:
        phases = [phase_four]
    else:
        phases = [phase_cli, phase_sparta, phase_night, phase_npsflin3,
                  phase_highres, phase_gpu_tests]
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        print(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(result_line(device))


if __name__ == "__main__":
    main()
