"""Telemetry-aware OTF support window (config ``otf_support``).

The system OTF ``exp(-Dphi/2) * dl`` decays below any threshold well
inside the grid; ``parallel/batch.py:estimate_otf_support`` bounds the
support inf-radius on the host (rigorously: the residual PSD dominates
the fitting PSD pointwise and the structure-function transform is
monotone in the PSD) and the zoom/dphi contractions compute only the
centred block.  These tests pin (a) the bound against the measured
float64 support, (b) end-to-end parity of the windowed batch with the
full-window batch, and (c) the gating rules.
"""

import numpy as np
import jax.numpy as jnp
from numpy.testing import assert_allclose

from muse_psfr_tpu.config import GalacsiConfig, TINY_CONFIG
from muse_psfr_tpu.parallel.batch import estimate_otf_support, \
    reconstruct_batch
from muse_psfr_tpu.psd.model import simulate_psd, effective_wind_speed
from muse_psfr_tpu.otf.psf import dphi_base, pupil_otf

H = (100, 10000)
CFG = GalacsiConfig(dim=512, dim_pup=24, dimpsf=12)


def _measured_support(seeing, GL, L0, lbda_nm, thresh=1e-12):
    """float64 inf-radius of |G_norm| > thresh on the full grid."""
    cfg = CFG.with_(dtype="float64", use_sym_fold=False, use_fft=True)
    ws = effective_wind_speed(H, cfg)
    psd = simulate_psd(seeing, GL, L0, jnp.ones(4, jnp.float64), H, ws,
                       1, cfg)
    base = np.asarray(dphi_base(psd.astype(cfg.dtype), cfg))[0]
    c = cfg.dim // 2
    g = np.exp(-0.5 * (2 * np.pi / lbda_nm) ** 2 * base)
    g *= np.asarray(pupil_otf(cfg)) / g[c, c]
    ii = np.abs(np.arange(cfg.dim) - c)
    r = np.maximum(ii[:, None], ii[None, :])
    return int(r[np.abs(g) > thresh].max())


def test_estimate_is_an_upper_bound():
    """The host bound must dominate the measured f64 support (or report
    0 = full window) across the telemetry range, including the
    least-damped corner (excellent seeing, low GL, red wavelength)."""
    cases = [(0.4, 0.05, 30.0), (0.6, 0.3, 29.0), (1.0, 0.7, 25.0),
             (1.6, 0.9, 9.0)]
    for seeing, GL, L0 in cases:
        S = estimate_otf_support([seeing], [GL], [L0], np.ones((1, 4)), 930.0, CFG)
        measured = _measured_support(seeing, GL, L0, 930.0)
        assert S == 0 or (S % 128 == 0 and measured <= S), \
            (seeing, GL, L0, S, measured)
    # the production condition must actually get a reduced window
    assert 0 < estimate_otf_support([1.0], [0.7], [25.0], np.ones((1, 4)),
                                930.0, CFG) < CFG.dim // 2


def test_batch_min_over_rows():
    """The batch support must cover its least-damped row."""
    s_all = estimate_otf_support([1.6, 0.4], [0.9, 0.05], [9.0, 30.0],
                             np.ones((2, 4)), 930.0, CFG)
    s_weak = estimate_otf_support([0.4], [0.05], [30.0], np.ones((1, 4)),
                              930.0, CFG)
    assert s_all == s_weak


def test_gating():
    m1 = np.ones((1, 4))
    assert estimate_otf_support([1.0], [0.7], [25.0], m1, 930.0,
                                CFG.with_(use_sym_fold=False)) == 0
    # below the certified expansion range -> full window
    assert estimate_otf_support([1.0], [0.7], [3.0], m1, 930.0, CFG) == 0
    assert estimate_otf_support([np.nan], [0.7], [25.0], m1, 930.0,
                                CFG) == 0
    # tiny grids: no reduction possible (S would reach dim/2)
    assert estimate_otf_support([1.0], [0.7], [25.0], m1, 930.0,
                                TINY_CONFIG) == 0


def test_windowed_batch_matches_full():
    """End-to-end: auto-support batch == full-window batch."""
    lbda = np.array([700.0, 930.0])
    see, gl, l0 = [1.0, 1.3], [0.7, 0.5], [25.0, 18.0]
    mask = np.ones((2, 4))
    assert estimate_otf_support(see, gl, l0, mask, 930.0, CFG,
                            npsflin=2) > 0  # engaged
    a = reconstruct_batch(see, gl, l0, mask, lbda, npsflin=2, cfg=CFG,
                          chunk=2)
    b = reconstruct_batch(see, gl, l0, mask, lbda, npsflin=2,
                          cfg=CFG.with_(otf_support=CFG.dim // 2), chunk=2)
    assert_allclose(a, b, rtol=0, atol=2e-6)


def test_explicit_support_validation():
    import pytest
    with pytest.raises(ValueError, match="multiple of 128"):
        CFG.with_(otf_support=100).otf_window


def test_guard_redo_on_too_small_window():
    """An explicitly forced too-small window must trip the in-pipeline
    guard and be recomputed with the full window (values must match the
    full-window run, not the truncated one)."""
    lbda = np.array([930.0])
    # ultra-weak damping: the OTF support exceeds 128 px at dim=512
    tel = ([0.2], [0.01], [30.0], np.ones((1, 4)))
    a = reconstruct_batch(*tel, lbda, cfg=CFG.with_(otf_support=128),
                          chunk=1)
    b = reconstruct_batch(*tel, lbda,
                          cfg=CFG.with_(otf_support=CFG.dim // 2), chunk=1)
    assert_allclose(a, b, rtol=0, atol=2e-6)


def test_guard_redo_keeps_the_original_chunk():
    """The guard-redo path must NOT shrink the chunk to the (small) redo
    subset — that would trace a fresh (B, 7) static shape, i.e. a
    multi-minute recompile on this deployment.  _plan_batch keeps the
    caller's chunk under force_full; redo call sites pass the original
    clamped chunk."""
    import numpy as _np
    from muse_psfr_tpu.parallel.batch import _plan_batch, clamped_chunk
    args = ([1.0, 1.1], [0.7, 0.6], [25.0, 24.0], _np.ones((2, 4)),
            [800.0], (100, 10000), 1, CFG)
    # normal path: clamp to the batch
    assert _plan_batch(*args, 25, None)[2] == 2
    # redo path: the caller's chunk (the original executable's key) wins
    assert _plan_batch(*args, 25, None, force_full=True)[2] == 25
    assert clamped_chunk(25, 2) == 2
    assert clamped_chunk(25, 100) == 25


def test_unpack_fit_accepts_pre15_width():
    """12-field packed arrays (pre-1.5 checkpoints, no `ok` flag) must
    unpack with an all-True ok; other widths raise with a clear error."""
    import pytest
    from muse_psfr_tpu.fit.moffat_fit import unpack_fit, N_PACKED
    new = np.arange(2 * N_PACKED, dtype=np.float64).reshape(2, N_PACKED)
    old = new[:, :N_PACKED - 1]
    a, b = unpack_fit(new), unpack_fit(old)
    assert set(a) == set(b)              # same keys either way
    assert_allclose(b["n"], a["n"])
    assert_allclose(b["flux"], a["flux"])
    assert b["ok"].all()
    with pytest.raises(ValueError, match="fields"):
        unpack_fit(np.zeros((2, 7)))


def test_pull_overlap_part_paths_match(monkeypatch):
    """The async pull-tail overlap must be value-neutral: part size 1
    (every chunk becomes a part, final pull carries NO fits — the
    empty-remainder branch), the default, and the disabled overlap all
    return identical results."""
    from muse_psfr_tpu.config import TINY_CONFIG
    from muse_psfr_tpu.parallel.batch import process_batch
    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64")
    lbda = np.array([700.0, 900.0])
    see = np.array([1.0, 1.2, 0.9, 1.1])
    gl = np.array([0.7, 0.5, 0.6, 0.4])
    l0 = np.array([25.0, 18.0, 22.0, 20.0])
    mask = np.ones((4, 4))

    def run():
        return process_batch(see, gl, l0, mask, lbda, cfg=cfg, chunk=1)

    def run2():
        return process_batch(see, gl, l0, mask, lbda, cfg=cfg, chunk=2)

    monkeypatch.delenv("MUSE_PSFR_NO_OVERLAP", raising=False)
    monkeypatch.setenv("MUSE_PSFR_PULL_PART", "1")
    a = run()                       # all parts, empty remainder
    monkeypatch.delenv("MUSE_PSFR_PULL_PART")
    b = run()                       # adaptive default (part 2 at 4 chunks)
    monkeypatch.setenv("MUSE_PSFR_NO_OVERLAP", "1")
    c = run()                       # overlap disabled
    for x, y in zip(a, b):
        assert_allclose(x, y, rtol=0, atol=0)
    for x, y in zip(a, c):
        assert_allclose(x, y, rtol=0, atol=0)
    # the true parts-disabled default (under 4 chunks -> single pull)
    monkeypatch.delenv("MUSE_PSFR_NO_OVERLAP")
    d = run2()
    monkeypatch.setenv("MUSE_PSFR_NO_OVERLAP", "1")
    e = run2()
    for x, y in zip(d, e):
        assert_allclose(x, y, rtol=0, atol=0)


def test_pull_schedule_env_matches_default(monkeypatch):
    """MUSE_PSFR_PULL_AT (explicit part-cut positions) must be
    value-neutral against the default stride schedule, including a cut
    at the last chunk (empty final remainder) and a malformed value
    (ignored with a warning)."""
    from muse_psfr_tpu.config import TINY_CONFIG
    from muse_psfr_tpu.parallel.batch import process_batch
    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64")
    lbda = np.array([700.0, 900.0])
    rng = np.random.default_rng(3)
    see = rng.uniform(0.8, 1.3, 6)
    gl = rng.uniform(0.4, 0.8, 6)
    l0 = rng.uniform(12.0, 28.0, 6)
    mask = np.ones((6, 4))

    def run():
        return process_batch(see, gl, l0, mask, lbda, cfg=cfg, chunk=1)

    monkeypatch.delenv("MUSE_PSFR_NO_OVERLAP", raising=False)
    monkeypatch.delenv("MUSE_PSFR_PULL_AT", raising=False)
    ref = run()
    for cuts in ("2,4", "1,2,3,4,5,6", "5", "oops,2"):
        monkeypatch.setenv("MUSE_PSFR_PULL_AT", cuts)
        got = run()
        for x, y in zip(ref, got):
            assert_allclose(x, y, rtol=0, atol=0)
    monkeypatch.delenv("MUSE_PSFR_PULL_AT")


def test_guard_redo_is_surgical():
    """One guard-tripping row in a batch must re-run ONLY its own chunk
    with the full window — not the whole night (process_batch used to
    recompute every row on any trip).  Counted via on_chunk: the tripped
    row's index is delivered twice (original + corrected), every other
    row exactly once; all values and the corrected mean must match the
    full-window run."""
    from muse_psfr_tpu.parallel.batch import process_batch
    lbda = np.array([930.0])
    # row 2 is ultra-weak damping: its OTF support exceeds the forced
    # 128-px window at dim=512 and trips the on-device guard
    see = np.array([1.0, 1.3, 0.2, 1.1])
    gl = np.array([0.7, 0.5, 0.01, 0.6])
    l0 = np.array([25.0, 18.0, 30.0, 22.0])
    mask = np.ones((4, 4))
    cfg_small = CFG.with_(otf_support=128)

    calls = []

    def on_chunk(idx, packed):
        calls.append((list(map(int, idx)), np.array(packed)))

    fit, psf_mean, fit_mean = process_batch(see, gl, l0, mask, lbda,
                                            cfg=cfg_small, chunk=1,
                                            on_chunk=on_chunk)
    counts = {}
    for idx, _ in calls:
        for j in idx:
            counts[j] = counts.get(j, 0) + 1
    assert counts == {0: 1, 1: 1, 2: 2, 3: 1}  # only row 2 redone
    # the LAST delivery for row 2 carries the corrected (full-window) fit
    last = {j: row for idx, packed in calls
            for j, row in zip(idx, packed)}
    assert_allclose(fit[2], last[2], rtol=0, atol=0)

    fit_full, mean_full, fit_mean_full = process_batch(
        see, gl, l0, mask, lbda, cfg=CFG.with_(otf_support=CFG.dim // 2),
        chunk=1)
    assert_allclose(fit, fit_full, rtol=0, atol=1e-4)
    assert_allclose(psf_mean, mean_full, rtol=0, atol=2e-6)
    assert_allclose(fit_mean, fit_mean_full, rtol=0, atol=1e-4)


def test_windowable_admission_adversarial_search():
    """Randomized search for a counterexample to the OTF-window
    admission chain (VERDICT r3 weak-3).

    ``rows_windowable`` admits a row from (a) sign-aware ring min/max
    envelopes of the fitting structure function and (b) the correction
    term sampled on 8 extreme rays at 32-px steps; the on-device guard
    then only checks the window boundary, ASSUMING ``D`` does not dip
    below its boundary minimum further out (a non-monotone ridge could
    evade both).  This test evaluates the exact host-side ``D`` (same
    split model, float64, full grid — every pixel, every ring) for
    hundreds of seeded random telemetry rows across and beyond the
    validity range, and asserts that every ADMITTED row keeps the
    normalised OTF below the guard's 1e-9 of DC on the ENTIRE exterior
    of the window at the reddest wavelength — i.e. the 8-ray/32-px
    sampling at thresh 1e-12 held with the promised three decades of
    margin, on full rings, with no ridge found.
    """
    from muse_psfr_tpu.parallel.batch import (rows_windowable,
                                              _split_on_cpu)
    from muse_psfr_tpu.otf.psf import (_fitting_dphi_basis_np,
                                       _centered_idft_np)
    from muse_psfr_tpu.psd.model import effective_wind_speed
    cfg = CFG
    dim, c, S = cfg.dim, cfg.dim // 2, 128
    lb_max = 930.0
    h_t = (100.0, 10000.0)
    ws = effective_wind_speed(h_t, cfg)
    rng = np.random.default_rng(20260817)

    # adversarial telemetry: dense in the validity range, plus tails
    # beyond it (poor seeing, tiny/huge GL, L0 at both split/validity
    # edges), plus 3-laser rows
    R = 240
    seeing = np.concatenate([rng.uniform(0.3, 2.0, R - 40),
                             rng.uniform(0.05, 0.3, 20),
                             rng.uniform(2.0, 4.0, 20)])
    GL = np.clip(rng.beta(1.2, 1.2, R), 1e-4, 1.0)
    L0 = np.concatenate([rng.uniform(5.0, 32.0, R - 30),
                         rng.uniform(32.0, 80.0, 30)])
    mask = np.ones((R, 4))
    mask[rng.random(R) < 0.3, 3] = 0.0

    ii = np.abs(np.arange(dim) - c)
    ring = np.maximum(ii[:, None], ii[None, :])
    outside = (ring >= S).ravel()
    convnm2 = (2.0 * np.pi / lb_max) ** 2
    need_guard = np.log(1e9)           # the on-device guard's criterion
    need_est = np.log(1e12)            # the estimator's admission level

    worst = {}
    for npsflin, nrows in ((1, R), (3, 64)):
        see_v, gl_v, l0_v, m_v = (seeing[:nrows], GL[:nrows], L0[:nrows],
                                  mask[:nrows])
        ok = rows_windowable(see_v, gl_v, l0_v, m_v, lb_max, cfg, S,
                             h=h_t, wind_speed=ws, npsflin=npsflin)
        assert ok.any() and not ok.all()   # both classes exercised
        idx = np.nonzero(ok)[0]
        # exact split-model D on the FULL f64 grid for admitted rows
        w, delta = _split_on_cpu(see_v[idx], gl_v[idx], l0_v[idx],
                                 m_v[idx], h_t, float(ws), npsflin, cfg)
        T = _fitting_dphi_basis_np(cfg.with_(dtype="float64"))
        d_fit = (w @ T.reshape(T.shape[0], -1))         # (A, dim*dim)
        L = cfg.dpup * (dim / cfg.npup)
        scale = dim * dim / (L * L)
        lo, s = c - cfg.dim_pup, delta.shape[-1]
        cb, sb = _centered_idft_np(dim, cols=(lo, s))   # (dim, s)
        min_damp = np.full(idx.size, np.inf)
        for a in range(idx.size):
            for d in range(delta.shape[1]):
                blk = delta[a, d]
                re = cb @ blk @ cb.T - sb @ blk @ sb.T
                d_corr = 2.0 * (blk.sum() / (L * L) - re * scale)
                d_tot = d_fit[a] + d_corr.ravel()
                min_damp[a] = min(min_damp[a],
                                  0.5 * convnm2 * d_tot[outside].min())
        assert np.all(min_damp >= need_guard), (
            "counterexample: admitted row(s) %s have exterior damping "
            "below the guard level (min %0.2f < %0.2f) — the 8-ray/"
            "32-px sampling missed a ridge; pin these rows as a "
            "regression fixture and tighten rows_windowable"
            % (idx[min_damp < need_guard].tolist(), min_damp.min(),
               need_guard))
        worst[npsflin] = float(min_damp.min())
    # empirical margin statement (measured 2026-08, this seed): the
    # tightest admitted row's exact exterior damping is e^-29.0
    # (npsflin=1) / e^-27.8 (npsflin=3) vs the estimator's admission
    # level e^-27.6 — the 8-ray/32-px sampling costs < 0.3 nats of the
    # 6.9-nat (3-decade) slack to the guard level, and no non-monotone
    # ridge evaded it.  Assert a decade of headroom stays
    assert min(worst.values()) >= need_est - np.log(10.0), worst


def test_on_redo_start_announces_before_corrected_delivery():
    """A guard trip must fire ``on_redo_start`` with exactly the stale
    rows BEFORE their corrected ``on_chunk`` delivery — durable sinks
    (the sweep checkpoint) un-mark those rows in that window so a crash
    cannot persist too-small-window fits as done."""
    from muse_psfr_tpu.parallel.batch import process_batch
    lbda = np.array([930.0])
    see = np.array([1.0, 1.3, 0.2, 1.1])
    gl = np.array([0.7, 0.5, 0.01, 0.6])
    l0 = np.array([25.0, 18.0, 30.0, 22.0])
    mask = np.ones((4, 4))
    events = []
    process_batch(
        see, gl, l0, mask, lbda, cfg=CFG.with_(otf_support=128), chunk=1,
        on_chunk=lambda idx, _: events.append(("chunk",
                                               list(map(int, idx)))),
        on_redo_start=lambda idx: events.append(("redo",
                                                 list(map(int, idx)))))
    redo_pos = [i for i, e in enumerate(events) if e[0] == "redo"]
    assert len(redo_pos) == 1
    assert events[redo_pos[0]][1] == [2]          # exactly the stale row
    deliveries_after = [e for e in events[redo_pos[0] + 1:]
                        if e[0] == "chunk" and 2 in e[1]]
    assert len(deliveries_after) == 1             # corrected call follows


def test_sweep_checkpoint_unmarks_redo_rows(tmp_path):
    """End-to-end: a sweep whose guard trips must finish with a complete
    'done' set and full-window-correct values in the checkpoint."""
    import json
    from muse_psfr_tpu.api import condition_sweep
    ck = str(tmp_path / "sweep.npy")
    kw = dict(seeing_vals=[0.2, 1.0], gl_vals=[0.01], l0_vals=[30.0],
              lbda=np.array([930.0]), chunk=1)
    res = condition_sweep(**kw, cfg=CFG.with_(otf_support=128),
                          checkpoint=ck)
    meta = json.load(open(ck + ".meta.json"))
    assert sorted(meta["done"]) == [0, 1]
    saved = np.load(ck)
    assert not np.isnan(saved[:, :, 0]).any()
    # values must equal the full-window sweep's
    full = condition_sweep(**kw, cfg=CFG.with_(otf_support=CFG.dim // 2))
    assert_allclose(res["fwhm"], full["fwhm"], rtol=0, atol=1e-4)


def test_process_batch_restores_input_order():
    """Bucketed dispatch reorders rows; packed fits must come back in
    input order, and on_chunk must receive the true row indices."""
    from muse_psfr_tpu.parallel.batch import process_batch, rows_windowable
    from muse_psfr_tpu.parallel.batch import default_support_bucket
    lbda = np.array([930.0])
    # interleave windowable and non-windowable rows
    see = np.array([1.0, 0.2, 1.3, 0.25])
    gl = np.array([0.7, 0.01, 0.5, 0.02])
    l0 = np.array([25.0, 30.0, 18.0, 29.0])
    mask = np.ones((4, 4))
    ok = rows_windowable(see, gl, l0, mask, 930.0, CFG,
                         default_support_bucket(CFG))
    assert ok.tolist() == [True, False, True, False]  # mixed buckets

    seen = {}

    def on_chunk(idx, packed):
        for j, row in zip(idx, packed):
            seen[int(j)] = row

    fit, psf_mean, fit_mean = process_batch(see, gl, l0, mask, lbda,
                                            cfg=CFG, chunk=2,
                                            on_chunk=on_chunk)
    assert sorted(seen) == [0, 1, 2, 3]
    for j in range(4):
        assert_allclose(fit[j], seen[j], rtol=0, atol=0)

    # input order: must match the full-window run (single group, no
    # reordering) row for row
    fit_full, _, _ = process_batch(see, gl, l0, mask, lbda,
                                   cfg=CFG.with_(otf_support=CFG.dim // 2),
                                   chunk=2)
    assert_allclose(fit, fit_full, rtol=0, atol=1e-4)


def test_bucketed_mesh_matches_single_device():
    """Bucketed dispatch under an 8-device mesh: same values, input
    order restored, per-bucket sharded chunks."""
    from muse_psfr_tpu import default_mesh
    lbda = np.array([930.0])
    see = np.array([1.0, 0.2, 1.3, 0.25])
    gl = np.array([0.7, 0.01, 0.5, 0.02])
    l0 = np.array([25.0, 30.0, 18.0, 29.0])
    mask = np.ones((4, 4))
    a = reconstruct_batch(see, gl, l0, mask, lbda, cfg=CFG, chunk=4,
                          mesh=default_mesh())
    b = reconstruct_batch(see, gl, l0, mask, lbda, cfg=CFG, chunk=4)
    assert_allclose(a, b, rtol=0, atol=1e-6)


def test_warm_specs_include_redo_executable(monkeypatch):
    """An all-windowed night has no full-window group, but the
    guard-redo path dispatches the full-window (chunk_n, 7) executable —
    the warm-up must include it so a guard trip never compiles
    mid-night on warming deployments."""
    import muse_psfr_tpu.parallel.batch as B

    captured = {}

    def spy(specs, kind, *a, **k):
        captured[kind] = dict(specs)   # capture; skip the real compiles

    monkeypatch.setattr(B, "_warm_programs", spy)
    # both rows admit the reduced window (cf. the bucketing test above)
    B.process_batch(np.array([1.0, 1.3]), np.array([0.7, 0.5]),
                    np.array([25.0, 18.0]), np.ones((2, 4)),
                    np.array([930.0]), cfg=CFG, chunk=2)
    specs = captured["fit"]
    assert any(gc.otf_support for gc, s in specs)     # the night's program
    full = [(gc, s) for gc, s in specs if not gc.otf_support]
    assert full, "redo (full-window) executable missing from warm specs"
    assert full[0][1] == 2                            # at chunk_n
    assert specs[full[0]].shape[0] >= 2               # real telemetry rows


def test_on_final_eager_for_guard_free_chunks():
    """Chunks of guard-free groups (full-window: the guard is
    structurally +inf, no redo possible) are final at delivery — their
    ``on_final`` fires immediately after their ``on_chunk``, not at the
    night's final pull, so a mid-night crash resumes past them.
    Windowed chunks stay deferred to guard resolution."""
    from muse_psfr_tpu.parallel.batch import process_batch
    lbda = np.array([930.0])
    # mixed buckets: rows 0, 2 windowed; rows 1, 3 full-window
    see = np.array([1.0, 0.2, 1.3, 0.25])
    gl = np.array([0.7, 0.01, 0.5, 0.02])
    l0 = np.array([25.0, 30.0, 18.0, 29.0])
    mask = np.ones((4, 4))
    events = []
    process_batch(
        see, gl, l0, mask, lbda, cfg=CFG, chunk=2,
        on_chunk=lambda idx, _: events.append(("chunk",
                                               sorted(map(int, idx)))),
        on_final=lambda idx: events.append(("final",
                                            sorted(map(int, idx)))))
    # the full-window chunk's final rides directly on its delivery
    i = events.index(("chunk", [1, 3]))
    assert events[i + 1] == ("final", [1, 3])
    # the windowed chunk's final comes only at the end (guard pull)
    assert events[-1] == ("final", [0, 2])
    # every row final'd exactly once
    assert sorted(r for k, rows in events if k == "final"
                  for r in rows) == [0, 1, 2, 3]


def test_on_final_fires_only_when_guard_resolved():
    """`on_final` must deliver every row exactly once, and the tripped
    row only AFTER its corrected value arrived — a durable sink that
    marks completion in on_final can then never persist a
    too-small-window fit as done across a crash + resume
    (api.condition_sweep's checkpoint relies on this ordering)."""
    from muse_psfr_tpu.parallel.batch import process_batch
    lbda = np.array([930.0])
    see = np.array([1.0, 1.3, 0.2, 1.1])
    gl = np.array([0.7, 0.5, 0.01, 0.6])
    l0 = np.array([25.0, 18.0, 30.0, 22.0])
    mask = np.ones((4, 4))
    cfg_small = CFG.with_(otf_support=128)

    events = []          # interleaved (kind, rows) stream
    values = {}

    def on_chunk(idx, packed):
        events.append(("chunk", list(map(int, idx))))
        for j, row in zip(idx, packed):
            values[int(j)] = np.array(row)

    def on_final(idx):
        events.append(("final", sorted(map(int, idx))))

    fit, _, _ = process_batch(see, gl, l0, mask, lbda, cfg=cfg_small,
                              chunk=1, on_chunk=on_chunk,
                              on_final=on_final)
    finals = [rows for kind, rows in events if kind == "final"]
    assert sorted(r for rows in finals for r in rows) == [0, 1, 2, 3]
    # the tripped row (2) is final'd separately, after its corrected
    # on_chunk delivery
    assert finals[-1] == [2]
    order = [e for e in events if e[0] == "final" or 2 in e[1]]
    assert order[-1] == ("final", [2])
    assert order[-2][0] == "chunk"          # corrected delivery first
    # and the value captured at on_chunk time for row 2 is the final one
    assert_allclose(values[2], fit[2], rtol=0, atol=0)


# ---- blue-segment window split (cfg.otf_blue) ---------------------------
#
# The damping exponent scales as (2pi/lambda)^2, so the bluest
# wavelengths admit much smaller OTF windows than the band maximum that
# sizes the per-row bucket (ceiling data:
# benchmarks/measure_perlambda_window.py).  cfg.otf_blue = (nb, S_blue)
# runs the first nb wavelengths on the S_blue sub-window; the batch
# planner sets it per group from the host admission model and the device
# guard checks the sub-window boundary at max(lbda[:nb]).

BLUE_CFG = GalacsiConfig(dim=512, dim_pup=16, dimpsf=12, lambda_chunk=2)


def test_blue_split_red_identical_blue_within_budget():
    """Mechanism parity: the red segment is bit-identical to the
    unsplit run (same code path on the same window); the blue planes
    differ only by the certified window truncation (f32 noise here —
    this row's OTF damps below 1e-12 inside S=128 at every lambda)."""
    from muse_psfr_tpu.otf.psf import psf_cube_from_base
    cfg = BLUE_CFG
    lb = np.linspace(600.0, 900.0, 6)
    ws = effective_wind_speed(H, cfg)
    psd = simulate_psd(1.0, 0.7, 25.0, jnp.ones(4), H, ws, 1, cfg)
    base = dphi_base(psd.astype(cfg.dtype), cfg)
    ref = np.asarray(psf_cube_from_base(base, lb, cfg))
    got = np.asarray(psf_cube_from_base(base, lb,
                                        cfg.with_(otf_blue=(3, 128))))
    assert np.array_equal(ref[3:], got[3:])
    assert np.abs(ref[:3] - got[:3]).max() < 5e-7


def test_blue_split_validation():
    import pytest
    from muse_psfr_tpu.otf.psf import psf_cube_from_base
    cfg = BLUE_CFG
    lb = np.linspace(600.0, 900.0, 6)
    ws = effective_wind_speed(H, cfg)
    psd = simulate_psd(1.0, 0.7, 25.0, jnp.ones(4), H, ws, 1, cfg)
    base = dphi_base(psd.astype(cfg.dtype), cfg)
    for bad, msg in [((0, 128), "segment length"),
                     ((6, 128), "segment length"),
                     ((3, 64), "multiple of 128"),
                     ((3, 256), "multiple of 128")]:
        with pytest.raises(ValueError, match=msg):
            psf_cube_from_base(base, lb, cfg.with_(otf_blue=bad))
    with pytest.raises(ValueError, match="fold/window"):
        from muse_psfr_tpu.otf.psf import _blue_split_cfgs
        _blue_split_cfgs(cfg.with_(use_sym_fold=False, otf_blue=(3, 128)),
                         6)


def test_window_guard_blue_boundary():
    """The guard must check the SUB-window boundary at the blue
    segment's max wavelength: weak structure function ON that boundary
    trips it; weak values strictly inside do not; the pure full window
    stays structurally +inf."""
    from muse_psfr_tpu.parallel.batch import _window_guard
    cfg = BLUE_CFG                       # otf_window (0, 256): full
    S, Sb, nb = 256, 128, 3
    lb = jnp.asarray(np.linspace(500.0, 900.0, 6), jnp.float32)
    base = jnp.full((1, 2 * S, S + 128), 1e9, jnp.float32)
    assert np.isinf(float(_window_guard(base, lb, cfg)))
    cfgb = cfg.with_(otf_blue=(nb, Sb))
    assert float(_window_guard(base, lb, cfgb)) > 0
    # each of the three truncation boundaries of the sub-window trips
    for r, c in [(S - Sb, S), (S + Sb - 1, S), (S, S - Sb)]:
        tripped = base.at[0, r, c].set(0.0)
        assert float(_window_guard(tripped, lb, cfgb)) < 0, (r, c)
    # a weak value strictly INSIDE the sub-window is not a truncation
    assert float(_window_guard(base.at[0, S, S].set(0.0), lb, cfgb)) > 0
    # ... and the blue guard composes with a real bucket window: the
    # bucket boundary still trips at max(lbda)
    cfg_wb = GalacsiConfig(dim=1024, dim_pup=16, dimpsf=12,
                           otf_support=256, otf_blue=(3, 128))
    Sw = 256
    bw = jnp.full((1, 2 * Sw, Sw + 128), 1e9, jnp.float32)
    assert float(_window_guard(bw, lb, cfg_wb)) > 0
    assert float(_window_guard(bw.at[0, 0, 5].set(0.0), lb, cfg_wb)) < 0


def test_blue_split_plan_partitions_the_full_bucket():
    """Planner: gap rows (blue-admitting but not band-max-admitting)
    get a blue-annotated full group; non-admitting rows stay in the
    pure full group; every row lands exactly once.  MUSE_PSFR_NO_BLUE
    disables the pass."""
    import os
    from muse_psfr_tpu.parallel.batch import _plan_batch
    cfg = BLUE_CFG
    lb = np.linspace(500.0, 900.0, 8)
    # at dim=512/GL=0.85: seeing >= 0.75 admits S=128 at 557 nm but
    # nobody admits it at 900 (measured scan) -> all rows bucket FULL
    see = np.array([0.9, 1.0, 0.5])
    gl = np.full(3, 0.85)
    l0 = np.full(3, 25.0)
    mask = np.ones((3, 4))
    # chunk=2: the blue subgroup (2 gap rows) is a multiple of the
    # dispatch quantum, so the chunk-aware split engages
    groups = _plan_batch(see, gl, l0, mask, lb, H, 1, cfg, 2, None)[1]
    covered = sorted(int(i) for _, gidx in groups for i in gidx)
    assert covered == [0, 1, 2]
    blue = [(gcfg, gidx) for gcfg, gidx in groups
            if gcfg.otf_blue is not None]
    assert blue, [g[0].otf_blue for g in groups]
    for gcfg, gidx in blue:
        nb, sb = gcfg.otf_blue
        assert sb == 128 and nb % cfg.lambda_chunk == 0 and 0 < nb < 8
        assert gcfg.otf_support == 0          # a full-bucket subgroup
        assert set(gidx.tolist()) <= {0, 1}
    pure = [gidx for gcfg, gidx in groups if gcfg.otf_blue is None
            and gcfg.otf_support == 0]
    assert any(2 in gidx for gidx in pure)
    # chunk-aware quantum: at chunk=4 (clamped to the 3-row batch) the
    # 2-row blue subgroup rounds to 0 -> no split (both subgroups would
    # otherwise pad to 3 rows of real device work)
    groups4 = _plan_batch(see, gl, l0, mask, lb, H, 1, cfg, 4, None)[1]
    assert all(gcfg.otf_blue is None for gcfg, _ in groups4)
    # env kill switch
    os.environ["MUSE_PSFR_NO_BLUE"] = "1"
    try:
        groups2 = _plan_batch(see, gl, l0, mask, lb, H, 1, cfg, 2,
                              None)[1]
        assert all(gcfg.otf_blue is None for gcfg, _ in groups2)
    finally:
        del os.environ["MUSE_PSFR_NO_BLUE"]


def test_process_batch_blue_matches_noblue():
    """End-to-end: the auto blue split changes values only within the
    certified window-truncation budget."""
    import os
    from muse_psfr_tpu.parallel.batch import process_batch
    cfg = BLUE_CFG
    lb = np.linspace(500.0, 900.0, 4)
    see = np.array([0.9, 1.4, 0.5])
    gl = np.array([0.85, 0.8, 0.85])
    l0 = np.full(3, 25.0)
    mask = np.ones((3, 4))
    # make sure the comparison is not vacuous: the plan must engage blue
    from muse_psfr_tpu.parallel.batch import _plan_batch
    gps = _plan_batch(see, gl, l0, mask, lb, H, 1, cfg, 1, None)[1]
    assert any(gcfg.otf_blue is not None for gcfg, _ in gps)
    # chunk=1 so the 1-row blue subgroup passes the chunk-aware quantum
    fit_a, mean_a, fm_a = process_batch(see, gl, l0, mask, lb, cfg=cfg,
                                        chunk=1)
    os.environ["MUSE_PSFR_NO_BLUE"] = "1"
    try:
        fit_b, mean_b, fm_b = process_batch(see, gl, l0, mask, lb,
                                            cfg=cfg, chunk=1)
    finally:
        del os.environ["MUSE_PSFR_NO_BLUE"]
    assert_allclose(fit_a, fit_b, rtol=0, atol=1e-5)
    assert_allclose(mean_a, mean_b, rtol=0, atol=1e-6)
    # the LM fit of the mean cube amplifies its ~3e-8 (f32-noise-level)
    # perturbation by ~1e4 in the near-singular error-bar columns — the
    # same amplification any float32 noise gets (docs/precision.md)
    assert_allclose(fm_a, fm_b, rtol=0, atol=1e-3)


def test_blue_guard_redo_on_pinned_too_small_window():
    """A PINNED blue sub-window too small for the telemetry must trip
    the guard and be recomputed with the full window (the redo clears
    otf_blue); a pinned otf_blue also bypasses auto-bucketing (which
    could otherwise assign otf_support == S_blue, an invalid pair)."""
    lbda = np.array([500.0, 930.0])
    tel = ([0.2], [0.01], [30.0], np.ones((1, 4)))
    a = reconstruct_batch(*tel, lbda, cfg=BLUE_CFG.with_(otf_blue=(1, 128)),
                          chunk=1)
    b = reconstruct_batch(*tel, lbda,
                          cfg=BLUE_CFG.with_(otf_support=256), chunk=1)
    assert_allclose(a, b, rtol=0, atol=2e-6)


def test_blue_tiers_ladder_plan(monkeypatch):
    """cfg.blue_tiers=2: graded admission forms a two-tier ladder
    (strong admitters run a longer blue segment) when the extra
    executable buys a 4/3 score factor; tiers=1 reproduces the
    single-subgroup plan on the same data (whole-group annotation
    here, since every row admits the short segment)."""
    from muse_psfr_tpu.parallel import batch as B

    lb = np.linspace(500.0, 900.0, 8)
    gcfg = BLUE_CFG.with_(otf_support=0)   # full bucket, S=256 -> Sb=128
    gidx = np.arange(8)

    def fake_windowable(seeing, GL, L0, gs_mask, lbda_max_nm, cfg, S,
                        h=None, wind_speed=None, npsflin=1, thresh=1e-12):
        # rows 0-3 admit the blue window out to lb[3]=~671 nm (nb=4);
        # EVERY row admits out to lb[1]=~557 nm (nb=2); none further
        if lbda_max_nm <= lb[1] + 1e-9:
            return np.ones(8, bool)
        if lbda_max_nm <= lb[3] + 1e-9:
            return np.arange(8) < 4
        return np.zeros(8, bool)

    monkeypatch.setattr(B, "rows_windowable", fake_windowable)
    args = (np.ones(8), np.ones(8), np.full(8, 25.0), np.ones((8, 4)),
            lb, H, None, 1, 2)

    for tiers, via_env in ((2, False), (2, True)):
        cfg_t = gcfg if via_env else gcfg.with_(blue_tiers=2)
        if via_env:
            monkeypatch.setenv("MUSE_PSFR_BLUE_TIERS", "2")
        else:
            monkeypatch.delenv("MUSE_PSFR_BLUE_TIERS", raising=False)
        out = B._blue_split_plan([(cfg_t, gidx)], *args)
        assert [(g.otf_blue, sorted(i.tolist())) for g, i in out] == [
            ((4, 128), [0, 1, 2, 3]), ((2, 128), [4, 5, 6, 7])]

    monkeypatch.delenv("MUSE_PSFR_BLUE_TIERS", raising=False)
    out1 = B._blue_split_plan([(gcfg, gidx)], *args)
    assert [(g.otf_blue, i.size) for g, i in out1] == [((2, 128), 8)]

    # defensive env parse: a junk value falls back to cfg.blue_tiers
    monkeypatch.setenv("MUSE_PSFR_BLUE_TIERS", "two")
    assert B._blue_tiers(gcfg) == 1
    assert B._blue_tiers(gcfg.with_(blue_tiers=3)) == 3
    monkeypatch.setenv("MUSE_PSFR_BLUE_TIERS", "2")
    assert B._blue_tiers(gcfg) == 2


def test_blue_tiers_ladder_guard_rejects_small_second_tier(monkeypatch):
    """A second tier whose quantum-rounded increment cannot buy the 4/3
    score factor is not split off: the plan stays single-subgroup."""
    from muse_psfr_tpu.parallel import batch as B

    lb = np.linspace(500.0, 900.0, 8)
    gcfg = BLUE_CFG.with_(otf_support=0)
    gidx = np.arange(8)

    def fake_windowable(seeing, GL, L0, gs_mask, lbda_max_nm, cfg, S,
                        h=None, wind_speed=None, npsflin=1, thresh=1e-12):
        # 4 rows admit nb=4, 7 (not all) admit nb=2: the tier-2
        # increment rounds to 2 rows -> score 16+4=20, extra=2,
        # value 11.25 < the single nb=4 subgroup's 12
        if lbda_max_nm <= lb[1] + 1e-9:
            return np.arange(8) < 7
        if lbda_max_nm <= lb[3] + 1e-9:
            return np.arange(8) < 4
        return np.zeros(8, bool)

    monkeypatch.setattr(B, "rows_windowable", fake_windowable)
    args = (np.ones(8), np.ones(8), np.full(8, 25.0), np.ones((8, 4)),
            lb, H, None, 1, 2)
    out = B._blue_split_plan([(gcfg.with_(blue_tiers=2), gidx)], *args)
    assert [(g.otf_blue, i.size) for g, i in out] == [
        ((4, 128), 4), (None, 4)]


def test_process_batch_blue_tiers_matches_noblue():
    """End-to-end: a tiered blue plan changes values only within the
    certified window-truncation budget (same contract as the
    single-tier split)."""
    import os
    from muse_psfr_tpu.parallel.batch import process_batch
    cfg = BLUE_CFG
    lb = np.linspace(500.0, 900.0, 4)
    see = np.array([0.9, 1.4, 0.5])
    gl = np.array([0.85, 0.8, 0.85])
    l0 = np.full(3, 25.0)
    mask = np.ones((3, 4))
    os.environ["MUSE_PSFR_BLUE_TIERS"] = "2"
    try:
        fit_a, mean_a, fm_a = process_batch(see, gl, l0, mask, lb,
                                            cfg=cfg, chunk=1)
    finally:
        del os.environ["MUSE_PSFR_BLUE_TIERS"]
    os.environ["MUSE_PSFR_NO_BLUE"] = "1"
    try:
        fit_b, mean_b, fm_b = process_batch(see, gl, l0, mask, lb,
                                            cfg=cfg, chunk=1)
    finally:
        del os.environ["MUSE_PSFR_NO_BLUE"]
    assert_allclose(fit_a, fit_b, rtol=0, atol=1e-5)
    assert_allclose(mean_a, mean_b, rtol=0, atol=1e-6)
    assert_allclose(fm_a, fm_b, rtol=0, atol=1e-3)


def test_blue_guard_applies_to_argmax_candidate(monkeypatch):
    """The minimum-size guard must bind the SELECTED (argmax-score)
    candidate: when the best subgroup rounds below n_rows//4 the
    planner falls back to whole-group annotation (or plain), never to
    a lower-score subgroup that happens to pass the guard — the
    single-subgroup planner's historical semantics, which
    blue_tiers=1 reproduces (ADVICE r4)."""
    from muse_psfr_tpu.parallel import batch as pb
    cfg = BLUE_CFG                       # otf_window (0, 256), kl=2
    n_rows = 16
    lb = np.linspace(500.0, 900.0, 8)    # nb menu {2, 4, 6}
    see = np.full(n_rows, 1.0)
    gl = np.full(n_rows, 0.7)
    l0 = np.full(n_rows, 25.0)
    mask = np.ones((n_rows, 4))
    gidx = np.arange(n_rows)

    # admission fixture: nb=2 -> rows 0..3; nb=4,6 -> rows 0..2 (nested,
    # monotone non-increasing).  quantum=chunk=2, guard = n_rows//4 = 4:
    #   nb=6: keep=2, score 12  <- argmax, FAILS the guard
    #   nb=2: keep=4, score  8  <- passes the guard
    def fake_windowable(seeing, GL, L0, gs_mask, lbda_max_nm, cfg_, S,
                        **kw):
        nb = int(np.searchsorted(lb, lbda_max_nm - 1e-9) + 1)
        adm = np.zeros(len(seeing), bool)
        adm[: 4 if nb <= 2 else 3] = True
        return adm

    monkeypatch.setattr(pb, "rows_windowable", fake_windowable)
    monkeypatch.delenv("MUSE_PSFR_NO_BLUE", raising=False)
    groups = pb._blue_split_plan([(cfg, gidx)], see, gl, l0, mask, lb,
                                 (100.0, 10000.0), 12.5, 1, chunk_c=2)
    # no candidate passes at the argmax and there is no full_nb: plain
    assert len(groups) == 1 and groups[0][0].otf_blue is None

    # same shape but nb=2 admits ALL rows (full_nb=2) and a deep-blue
    # argmax still fails the guard -> whole-group annotation with nb=2
    lb40 = np.linspace(500.0, 900.0, 40)  # menu up to nb=38

    def fake_windowable2(seeing, GL, L0, gs_mask, lbda_max_nm, cfg_, S,
                         **kw):
        nb = int(np.searchsorted(lb40, lbda_max_nm - 1e-9) + 1)
        adm = np.zeros(len(seeing), bool)
        adm[: n_rows if nb <= 2 else 3] = True
        return adm

    monkeypatch.setattr(pb, "rows_windowable", fake_windowable2)
    groups2 = pb._blue_split_plan([(cfg, gidx)], see, gl, l0, mask,
                                  lb40, (100.0, 10000.0), 12.5, 1,
                                  chunk_c=2)
    assert len(groups2) == 1
    assert groups2[0][0].otf_blue == (2, 128)
    assert groups2[0][1].size == n_rows


def test_blue_tiers_env_clamped(monkeypatch):
    """MUSE_PSFR_BLUE_TIERS / cfg.blue_tiers are clamped to <=4 so the
    C(menu, tiers) ladder enumeration stays bounded (ADVICE r4), and
    the 0=auto default resolves by direction count (2 for ndir>=9,
    1 otherwise)."""
    from muse_psfr_tpu.parallel.batch import _blue_tiers
    monkeypatch.setenv("MUSE_PSFR_BLUE_TIERS", "100")
    assert _blue_tiers(BLUE_CFG) == 4
    monkeypatch.delenv("MUSE_PSFR_BLUE_TIERS")
    assert _blue_tiers(BLUE_CFG.with_(blue_tiers=99)) == 4
    assert _blue_tiers(BLUE_CFG.with_(blue_tiers=2)) == 2
    assert BLUE_CFG.blue_tiers == 0          # auto is the default
    assert _blue_tiers(BLUE_CFG, 1) == 1
    assert _blue_tiers(BLUE_CFG, 9) == 2
    assert _blue_tiers(BLUE_CFG.with_(blue_tiers=1), 9) == 1
