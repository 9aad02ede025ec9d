"""Mesh-sharded batch reconstruction on a virtual 8-device CPU mesh."""

import numpy as np
import jax
from numpy.testing import assert_allclose

from muse_psfr_tpu import TINY_CONFIG, reconstruct_batch, default_mesh


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_batch_matches_single_device():
    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64")
    lbda = np.linspace(600, 900, 3)
    rng = np.random.default_rng(1)
    B = 8
    seeing = rng.uniform(0.6, 1.4, B)
    GL = rng.uniform(0.3, 0.9, B)
    L0 = rng.uniform(10, 28, B)
    mask = np.ones((B, 4))
    mask[2, 3] = 0.0

    ref = reconstruct_batch(seeing, GL, L0, mask, lbda, cfg=cfg, chunk=3)
    mesh = default_mesh()
    shard = reconstruct_batch(seeing, GL, L0, mask, lbda, cfg=cfg,
                              chunk=8, mesh=mesh)
    assert shard.shape == (B, 3, cfg.dimpsf, cfg.dimpsf)
    assert_allclose(shard, ref, atol=1e-12)


def test_batch_padding_with_mesh():
    """Batch size not divisible by the mesh is padded and un-padded."""
    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64")
    lbda = np.array([700.0])
    B = 5
    seeing = np.full(B, 1.0)
    GL = np.full(B, 0.7)
    L0 = np.full(B, 25.0)
    mask = np.ones((B, 4))
    mesh = default_mesh()
    out = reconstruct_batch(seeing, GL, L0, mask, lbda, cfg=cfg,
                            chunk=8, mesh=mesh)
    assert out.shape[0] == B
    # identical conditions -> identical PSFs
    assert_allclose(out, np.repeat(out[:1], B, axis=0), atol=1e-12)


def test_production_shape_lowers_under_mesh():
    """The dim=1280, nl=35 production pipeline SPMD-partitions under the
     8-device mesh at its real shape (lowering only — executing the full
    grid on the CPU test backend would take minutes; the partitioning,
    which is what multi-chip correctness rides on, is decided at
    lowering).  Mirrors the reference's only concurrency contract, the
    joblib row map (psfrec.py:1082-1083)."""
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import _reconstruct_vmapped

    cfg = GalacsiConfig()                      # full production config
    sh = NamedSharding(default_mesh(), P("rows"))
    B, f32 = 8, np.float32
    sds = jax.ShapeDtypeStruct
    low = _reconstruct_vmapped.lower(
        sds((B,), f32, sharding=sh), sds((B,), f32, sharding=sh),
        sds((B,), f32, sharding=sh), sds((B, 4), f32, sharding=sh),
        sds((35,), f32), sds((35,), np.int32), (100.0, 10000.0), 12.0, 1,
        cfg)
    header = low.as_text().split("\n", 1)[0]
    assert "mhlo.num_partitions = 8" in header


def test_mesh_executes_production_path_dim512():
    """EXECUTE (not just lower) the full production code path — dphi
    split + point-symmetry fold + OTF-support window, bucketed dispatch
    — under the 8-device mesh at dim=512, and require parity with the
    single-device result.  Complements
    :func:`test_production_shape_lowers_under_mesh`, which checks only
    the partitioning metadata at dim=1280."""
    from muse_psfr_tpu.parallel.batch import (process_batch,
                                              rows_windowable,
                                              default_support_bucket)
    from tests.test_otf_support import CFG  # dim=512 production-like cfg

    lbda = np.array([930.0])
    # mixed buckets: windowable and full-window rows in one batch
    see = np.array([1.0, 0.2, 1.3, 0.25, 1.1, 0.22, 1.2, 0.3])
    gl = np.array([0.7, 0.01, 0.5, 0.02, 0.6, 0.015, 0.65, 0.03])
    l0 = np.array([25.0, 30.0, 18.0, 29.0, 22.0, 28.0, 24.0, 27.0])
    mask = np.ones((8, 4))
    ok = rows_windowable(see, gl, l0, mask, 930.0, CFG,
                         default_support_bucket(CFG))
    assert ok.any() and (~ok).any()          # both buckets engaged

    # chunk=1 on the single-device side: its two bucket executables are
    # shared with tests/test_otf_support.py (same cfg statics), so only
    # the mesh-sharded variants compile here
    fit_s, mean_s, fitm_s = process_batch(see, gl, l0, mask, lbda,
                                          cfg=CFG, chunk=1)
    fit_m, mean_m, fitm_m = process_batch(see, gl, l0, mask, lbda,
                                          cfg=CFG, chunk=8,
                                          mesh=default_mesh())
    assert_allclose(fit_m, fit_s, rtol=0, atol=1e-4)
    assert_allclose(mean_m, mean_s, rtol=0, atol=1e-6)
    assert_allclose(fitm_m, fitm_s, rtol=0, atol=1e-4)


def test_guard_redo_is_surgical_under_mesh():
    """The window-guard redo path must also work when the batch is
    sharded over a mesh: only the tripped chunk's rows are redone (with
    the mesh passed through), and the corrected mean matches the
    single-device result."""
    import numpy as np
    from numpy.testing import assert_allclose
    from muse_psfr_tpu.parallel.batch import process_batch
    from tests.test_otf_support import CFG

    lbda = np.array([930.0])
    # row 3 is ultra-weak damping: trips the forced 128-px window
    see = np.array([1.0, 1.3, 1.1, 0.2])
    gl = np.array([0.7, 0.5, 0.6, 0.01])
    l0 = np.array([25.0, 18.0, 22.0, 30.0])
    mask = np.ones((4, 4))
    cfg_small = CFG.with_(otf_support=128)
    mesh2 = default_mesh(jax.devices()[:2])      # chunk -> 2 rows/chunk

    calls = []
    fit_m, mean_m, fitm_m = process_batch(
        see, gl, l0, mask, lbda, cfg=cfg_small, chunk=2, mesh=mesh2,
        on_chunk=lambda idx, p: calls.append(list(map(int, idx))))
    counts = {}
    for idx in calls:
        for j in idx:
            counts[j] = counts.get(j, 0) + 1
    assert counts == {0: 1, 1: 1, 2: 2, 3: 2}    # only chunk (2,3) redone

    fit_s, mean_s, fitm_s = process_batch(see, gl, l0, mask, lbda,
                                          cfg=cfg_small, chunk=2)
    assert_allclose(fit_m, fit_s, rtol=0, atol=1e-4)
    assert_allclose(mean_m, mean_s, rtol=0, atol=2e-6)


def test_init_multihost_two_process_cpu(tmp_path):
    """2-process ``jax.distributed`` smoke test of ``init_multihost`` on
    the CPU backend (multi-host analog of the reference's joblib
    concurrency, psfrec.py:1082-1083): both processes must see the
    4-device global mesh and agree on a cross-process collective."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:                 # free port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    worker = tmp_path / "mh_worker.py"
    worker.write_text(
        "import sys, os\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from muse_psfr_tpu.parallel.mesh import init_multihost\n"
        "import numpy as np\n"
        "import jax.numpy as jnp\n"
        "from jax.sharding import NamedSharding, PartitionSpec as P\n"
        f"mesh = init_multihost('localhost:{port}', 2, int(sys.argv[1]))\n"
        "assert len(jax.devices()) == 4, jax.devices()\n"
        "assert len(jax.local_devices()) == 2\n"
        "nloc = len(jax.local_devices())\n"
        "x = jax.make_array_from_process_local_data(\n"
        "    NamedSharding(mesh, P('rows')),\n"
        "    np.full((nloc,), 1.0 + int(sys.argv[1])))\n"
        "tot = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(x)\n"
        "assert float(tot) == 6.0, float(tot)\n"   # 2*1 + 2*2
        "print('MULTIHOST_OK', int(sys.argv[1]))\n")

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(worker), str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert f"MULTIHOST_OK {i}" in out


def test_compute_psf_from_sparta_with_mesh():
    """The top-level API shards its batch over a mesh."""
    import numpy as np
    from muse_psfr_tpu import (compute_psf_from_sparta, create_sparta_table,
                               HDUList, FitTable)
    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64")
    hdu = create_sparta_table(nlines=5)
    res_m = compute_psf_from_sparta(HDUList([hdu.copy()]), lmin=700,
                                    lmax=900, nl=2, cfg=cfg,
                                    mesh=default_mesh(), chunk=8)
    res_s = compute_psf_from_sparta(HDUList([hdu]), lmin=700, lmax=900,
                                    nl=2, cfg=cfg)
    a = FitTable.from_hdu(res_m["FIT_ROWS"])
    b = FitTable.from_hdu(res_s["FIT_ROWS"])
    assert_allclose(a["fwhm"], b["fwhm"], atol=1e-12)
    assert_allclose(res_m["PSF_MEAN"].data, res_s["PSF_MEAN"].data,
                    atol=1e-12)


def test_tail_chunk_matches_padded_dispatch(monkeypatch):
    """The tail-chunk policy (last partial chunk dispatched at a smaller
    static size from the {chunk//4, chunk//2, 3*chunk//4} menu instead
    of padding to a full chunk) must be invisible in the results:
    per-row fits, mean PSF, and mean fit identical to the padded
    dispatch, rows in input order.  B=11 at chunk=8 exercises main
    chunks + a tail of size 4 (rem 3 <= 8//4); B=7 at chunk=8 a
    pure-tail bucket (rem 7 > 3*8//4 falls back to the full chunk).
    Tails engage only on REDUCED-WINDOW groups — the guard-redo must
    be able to reuse the full-window (chunk, 7) executable — so the
    config pins an explicit otf_support window (asserted below); with
    the TINY default every row lands full-window and the policy is
    inert."""
    from muse_psfr_tpu.parallel.batch import process_batch, _plan_batch

    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64",
                            otf_support=128)
    assert all(gc.otf_support for gc, _ in _plan_batch(
        np.array([1.0]), np.array([0.7]), np.array([25.0]),
        np.ones((1, 4)), np.linspace(600, 900, 3), (100, 10000), 1,
        cfg, 1, None, False)[1])
    lbda = np.linspace(600, 900, 3)
    rng = np.random.default_rng(7)
    for B in (11, 7):
        seeing = rng.uniform(0.6, 1.4, B)
        GL = rng.uniform(0.3, 0.9, B)
        L0 = rng.uniform(10, 28, B)
        mask = np.ones((B, 4))
        monkeypatch.delenv("MUSE_PSFR_NO_TAIL", raising=False)
        seen = {}

        def on_chunk(indices, packed):
            # checkpoint sinks must receive every row exactly once with
            # matching shapes, tail chunks included
            for k, row in enumerate(indices):
                assert int(row) not in seen
                seen[int(row)] = packed[k].copy()
            assert packed.shape[0] == len(indices)

        fit_t, mean_t, fitm_t = process_batch(seeing, GL, L0, mask, lbda,
                                              cfg=cfg, chunk=8,
                                              on_chunk=on_chunk)
        assert sorted(seen) == list(range(B))
        for r in range(B):
            assert_allclose(seen[r], fit_t[r], atol=1e-12)
        monkeypatch.setenv("MUSE_PSFR_NO_TAIL", "1")
        fit_p, mean_p, fitm_p = process_batch(seeing, GL, L0, mask, lbda,
                                              cfg=cfg, chunk=8)
        monkeypatch.delenv("MUSE_PSFR_NO_TAIL")
        assert fit_t.shape == fit_p.shape
        assert_allclose(fit_t, fit_p, atol=1e-12)
        assert_allclose(mean_t, mean_p, atol=1e-12)
        assert_allclose(fitm_t, fitm_p, atol=1e-12)


def test_warm_populates_jit_cache():
    """The warm-up must land in the SAME cache the dispatch loop's call
    path hits — otherwise the night would silently compile everything
    twice.  (This is why warming CALLS the jitted function: an AOT
    ``lower().compile()`` does NOT populate the call cache in this JAX
    version — re-timing showed the call after an AOT compile re-traces
    and re-compiles.)  Pin it: after warming two sizes, real calls with
    matching avals must not grow the cache."""
    import jax.numpy as jnp
    from muse_psfr_tpu.parallel.batch import (_warm_programs, _fit_chunk,
                                              _plan_batch)

    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64")
    lbda = np.linspace(600, 900, 3)
    (cfg_r, groups, chunk_n, table, lbda_j, h_t, wind_speed, _,
     npixc_j) = _plan_batch(
        np.array([1.0, 1.1]), np.array([0.7, 0.6]), np.array([25.0, 20.0]),
        np.ones((2, 4)), lbda, (100, 10000), 1, cfg, 2, None, False)
    assert len(groups) == 1
    gcfg = groups[0][0]

    _warm_programs({(gcfg, 2): table, (gcfg, 1): table}, "fit",
                   lbda_j, npixc_j, h_t, wind_speed, 1, "float64")
    n0 = _fit_chunk._cache_size()
    assert n0 >= 2
    for size in (2, 1):
        t = jnp.asarray(table[:size], gcfg.dtype)
        fit, psum, guard = _fit_chunk(t, jnp.asarray(np.int32(size)),
                                      lbda_j, npixc_j, h_t, wind_speed, 1,
                                      gcfg, "float64")
        assert np.isfinite(np.asarray(fit)).all()
    assert _fit_chunk._cache_size() == n0, \
        "dispatch after warm-up recompiled: cache key mismatch"


def test_warm_memo_prevents_recompiles(monkeypatch):
    """A second night with the same executables must not re-lower."""
    from muse_psfr_tpu.parallel import batch as B

    calls = []
    orig = B._compile_concurrently
    monkeypatch.setattr(B, "_compile_concurrently",
                        lambda jobs: (calls.append(len(jobs)), orig(jobs)))

    # otf_support picks a fixed reduced window: the 5-row night at
    # chunk=4 then dispatches a main (4, 7) chunk plus a (1, 7) tail —
    # two executables, so the warm-up engages
    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64",
                            otf_support=128)
    # 4 wavelengths: a lambda-grid shape no other test uses, so the
    # process-level warm memo is guaranteed cold for this test's keys
    lbda = np.linspace(600, 900, 4)
    rng = np.random.default_rng(3)
    Bn = 5
    seeing = rng.uniform(0.6, 1.4, Bn)
    GL = rng.uniform(0.3, 0.9, Bn)
    L0 = rng.uniform(10, 28, Bn)
    mask = np.ones((Bn, 4))

    from muse_psfr_tpu.parallel.batch import process_batch
    fit1, mean1, fitm1 = process_batch(seeing, GL, L0, mask, lbda,
                                       cfg=cfg, chunk=4)
    first = list(calls)
    assert first and first[0] >= 2
    fit2, mean2, fitm2 = process_batch(seeing, GL, L0, mask, lbda,
                                       cfg=cfg, chunk=4)
    # the second identical night warms nothing new
    assert list(calls) == first
    assert_allclose(fit1, fit2, atol=0)

    # the warm-up also pre-compiled the standalone mean-fit program:
    # a call at the production aval must not grow its cache
    import jax.numpy as jnp
    from muse_psfr_tpu.fit.moffat_fit import fit_moffat_cube_packed
    n_mean = fit_moffat_cube_packed._cache_size()
    fit_moffat_cube_packed(jnp.asarray(mean1), dtype="float64")
    assert fit_moffat_cube_packed._cache_size() == n_mean

    # equivalence with the warm-up disabled (fresh keys would recompile
    # lazily in the loop; values must be identical either way)
    monkeypatch.setenv("MUSE_PSFR_NO_WARM", "1")
    fit3, mean3, fitm3 = process_batch(seeing, GL, L0, mask, lbda,
                                       cfg=cfg, chunk=4)
    assert_allclose(fit1, fit3, atol=0)
    assert_allclose(mean1, mean3, atol=0)
    assert_allclose(fitm1, fitm3, atol=0)


def test_warm_covers_every_dispatched_executable(monkeypatch):
    """On a night with an exact-transform group, two buckets, and a tail
    chunk, the warm-up must pre-compile every (cfg, size) the dispatch
    loop uses — pinned by intercepting the warm specs and the real
    dispatch sizes."""
    from muse_psfr_tpu.parallel import batch as B

    specs_seen = []
    orig_warm = B._warm_programs

    def spy(specs, kind, *a, **k):
        specs_seen.extend(specs)
        return orig_warm(specs, kind, *a, **k)

    monkeypatch.setattr(B, "_warm_programs", spy)

    orig_fit = B._fit_chunk
    dispatched = []

    def spy_fit(t, *a, **k):
        dispatched.append(t.shape[0])
        return orig_fit(t, *a, **k)

    monkeypatch.setattr(B, "_fit_chunk", spy_fit)

    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64",
                            otf_support=128)
    lbda = np.linspace(600, 900, 3)
    rng = np.random.default_rng(11)
    Bn = 7
    seeing = rng.uniform(0.6, 1.4, Bn)
    GL = rng.uniform(0.3, 0.9, Bn)
    L0 = rng.uniform(10, 28, Bn)
    L0[0] = 1.5          # below dphi_split_l0_min -> exact-transform group
    mask = np.ones((Bn, 4))

    fit, _, _ = B.process_batch(seeing, GL, L0, mask, lbda, cfg=cfg,
                                chunk=4)
    assert np.isfinite(fit).all()
    warmed_sizes = {s for _, s in specs_seen}
    assert warmed_sizes.issuperset(set(dispatched)), \
        (warmed_sizes, dispatched)


def test_compile_concurrently_error_paths():
    """Failures in warm-up compile threads re-raise AS THEMSELVES, on
    the threaded path (>= 2 jobs, where the error is collected from a
    worker and raised after the join) and on the serial one — the
    caller sees the compiler's own error, with no wrapper."""
    import pytest
    from muse_psfr_tpu.parallel.batch import _compile_concurrently

    def boom_compile():
        raise RuntimeError("RESOURCE_EXHAUSTED: out of device memory")

    def boom_other():
        raise ValueError("unrelated failure")

    ran = []

    def ok():
        ran.append(1)

    for boom, exc, msg in ((boom_compile, RuntimeError,
                            "^RESOURCE_EXHAUSTED: out of device memory$"),
                           (boom_other, ValueError,
                            "^unrelated failure$")):
        with pytest.raises(exc, match=msg):
            _compile_concurrently([(boom, 77), (ok, 50)], width=2)
        with pytest.raises(exc, match=msg):
            _compile_concurrently([(boom, 33)])
    # the threaded path lets every other job finish before raising
    assert ran == [1, 1]


def test_warm_populates_recon_jit_cache():
    """Recon-path twin of test_warm_populates_jit_cache: the eager
    dynamic-slice chunk the dispatch loop feeds `_reconstruct_chunk`
    must hit the executable the warm-up compiled (same aval), or the
    night silently compiles everything twice."""
    import jax
    import jax.numpy as jnp
    from muse_psfr_tpu.parallel.batch import (_warm_programs,
                                              _reconstruct_chunk,
                                              _plan_batch)

    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64")
    # 5 wavelengths: a lambda grid unique to this test so the process
    # warm memo and jit cache are cold for its keys
    lbda = np.linspace(600, 900, 5)
    (cfg_r, groups, chunk_n, table, lbda_j, h_t, wind_speed, _,
     npixc_j) = _plan_batch(
        np.array([1.0, 1.1, 0.9]), np.array([0.7, 0.6, 0.8]),
        np.array([25.0, 20.0, 15.0]), np.ones((3, 4)), lbda,
        (100, 10000), 1, cfg, 3, None, False)
    assert len(groups) == 1
    gcfg = groups[0][0]

    _warm_programs({(gcfg, 3): table, (gcfg, 2): table}, "recon",
                   lbda_j, npixc_j, h_t, wind_speed, 1)
    n0 = _reconstruct_chunk._cache_size()
    assert n0 >= 2
    table_d = jnp.asarray(table, gcfg.dtype)
    for size in (3, 2):
        # the dispatch loop's exact operand construction: an eager
        # traced-offset dynamic slice of the device-resident table
        t = jax.lax.dynamic_slice_in_dim(
            table_d, jnp.asarray(0, jnp.int32), size, axis=0)
        res, guard = _reconstruct_chunk(t, lbda_j, npixc_j, h_t,
                                        wind_speed, 1, gcfg)
        assert np.isfinite(np.asarray(res)).all()
    assert _reconstruct_chunk._cache_size() == n0, \
        "recon dispatch after warm-up recompiled: cache key mismatch"


def test_warm_enabled_policy(monkeypatch):
    """Engagement policy: on by default whatever the backend;
    MUSE_PSFR_NO_WARM turns it off (the old MUSE_PSFR_WARM switch no
    longer changes anything)."""
    from muse_psfr_tpu.parallel import batch as B

    monkeypatch.delenv("MUSE_PSFR_WARM", raising=False)
    monkeypatch.delenv("MUSE_PSFR_NO_WARM", raising=False)
    assert B._warm_enabled()

    monkeypatch.setenv("MUSE_PSFR_NO_WARM", "1")
    assert not B._warm_enabled()
    monkeypatch.setenv("MUSE_PSFR_WARM", "1")
    assert not B._warm_enabled()
    monkeypatch.delenv("MUSE_PSFR_NO_WARM")
    assert B._warm_enabled()

    # no backend sniff: the decision never looks at the devices
    def no_devices():
        raise AssertionError("the warm-up policy must not query devices")

    monkeypatch.setattr(B.jax, "devices", no_devices)
    monkeypatch.delenv("MUSE_PSFR_WARM")
    assert B._warm_enabled()


def test_warm_concurrency_parse(monkeypatch):
    from muse_psfr_tpu.parallel import batch as B
    monkeypatch.delenv("MUSE_PSFR_WARM_CONCURRENCY", raising=False)
    assert B._warm_concurrency() == 2
    monkeypatch.setenv("MUSE_PSFR_WARM_CONCURRENCY", "5")
    assert B._warm_concurrency() == 5
    monkeypatch.setenv("MUSE_PSFR_WARM_CONCURRENCY", "0")
    assert B._warm_concurrency() == 1          # clamped
    monkeypatch.setenv("MUSE_PSFR_WARM_CONCURRENCY", "lots")
    assert B._warm_concurrency() == 2          # warn + default


def test_compile_concurrently_bounded_width(monkeypatch):
    """Every job runs exactly once for any pool width (1 = serial path,
    2 = bounded pool smaller than the job list)."""
    from muse_psfr_tpu.parallel import batch as B

    for width in ("1", "2"):
        monkeypatch.setenv("MUSE_PSFR_WARM_CONCURRENCY", width)
        ran = []
        jobs = [(lambda i=i: ran.append(i), 10 + i) for i in range(5)]
        B._compile_concurrently(jobs)
        assert sorted(ran) == list(range(5)), (width, ran)


def test_process_batch_two_process_multihost(tmp_path):
    """The PRODUCTION pipeline runs multi-host: ``process_batch``
    executed across 2 processes x 2 CPU devices (a 4-device global
    multi-host mesh) must match the single-process result —
    including a window-guard redo case (VERDICT r4 item 3; replaces
    the reference's joblib row map, psfrec.py:1082-1083)."""
    import os
    import socket
    import subprocess
    import sys

    from muse_psfr_tpu.parallel.batch import process_batch
    from tests.test_otf_support import CFG

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    # case A: plain 8-row batch (dim=512, 3 lambdas)
    rng = np.random.default_rng(1)
    B = 8
    see_a = rng.uniform(0.6, 1.4, B)
    gl_a = rng.uniform(0.3, 0.9, B)
    l0_a = rng.uniform(10, 28, B)
    mask_a = np.ones((B, 4))
    mask_a[2, 3] = 0.0
    # case B: forced small window; row 3 (weak damping) trips the
    # guard -> surgical redo, executed under the mesh
    see_b = np.array([1.0, 1.3, 1.1, 0.2])
    gl_b = np.array([0.7, 0.5, 0.6, 0.01])
    l0_b = np.array([25.0, 18.0, 22.0, 30.0])
    mask_b = np.ones((4, 4))

    worker = tmp_path / "mh_pipeline_worker.py"
    worker.write_text(f"""
import sys
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
import numpy as np
from muse_psfr_tpu.parallel.mesh import init_multihost
mesh = init_multihost('localhost:{port}', 2, int(sys.argv[1]))
assert len(jax.devices()) == 4 and len(jax.local_devices()) == 2
from muse_psfr_tpu.config import GalacsiConfig
from muse_psfr_tpu.parallel.batch import process_batch
cfg = GalacsiConfig(dim=512, dim_pup=24, dimpsf=12,
                    dtype='float64', fit_dtype='float64')
lbda = np.linspace(600, 900, 3)
rng = np.random.default_rng(1)
B = 8
see = rng.uniform(0.6, 1.4, B)
gl = rng.uniform(0.3, 0.9, B)
l0 = rng.uniform(10, 28, B)
mask = np.ones((B, 4)); mask[2, 3] = 0.0
fit, mean, fitm = process_batch(see, gl, l0, mask, lbda, cfg=cfg,
                                chunk=4, mesh=mesh)
np.savez(r'{tmp_path}/mh_a_' + sys.argv[1] + '.npz',
         fit=fit, mean=mean, fitm=fitm)
see_b = np.array([1.0, 1.3, 1.1, 0.2])
gl_b = np.array([0.7, 0.5, 0.6, 0.01])
l0_b = np.array([25.0, 18.0, 22.0, 30.0])
calls = []
fit_b, mean_b, fitm_b = process_batch(
    see_b, gl_b, l0_b, np.ones((4, 4)), np.array([930.0]),
    cfg=cfg.with_(otf_support=128), chunk=2, mesh=mesh,
    on_chunk=lambda idx, p: calls.append(sorted(map(int, idx))))
# chunk clamps to the 4-device mesh -> ONE chunk; row 3 trips the
# guard, so the whole chunk is redelivered with corrected values
assert calls.count([0, 1, 2, 3]) == 2, calls
np.savez(r'{tmp_path}/mh_b_' + sys.argv[1] + '.npz',
         fit=fit_b, mean=mean_b)
print('MH_PIPELINE_OK', sys.argv[1])
""")

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    def _launch():
        procs = [subprocess.Popen([sys.executable, str(worker), str(i)],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for i in range(2)]
        return procs, [p.communicate(timeout=900)[0] for p in procs]

    procs, outs = _launch()
    if any(p.returncode for p in procs) and \
            any("DEADLINE_EXCEEDED" in o for o in outs):
        # Gloo's cross-process collective context has a fixed 30 s
        # init deadline; on a loaded 2-core CI machine the first
        # (compile-heavy) attempt can skew the two processes past it.
        # One retry runs with both persistent caches warm.
        procs, outs = _launch()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
        assert f"MH_PIPELINE_OK {i}" in out

    cfg = CFG.with_(dtype="float64", fit_dtype="float64")
    lbda = np.linspace(600, 900, 3)
    fit_s, mean_s, fitm_s = process_batch(see_a, gl_a, l0_a, mask_a,
                                          lbda, cfg=cfg, chunk=4)
    fit_bs, mean_bs, _ = process_batch(
        see_b, gl_b, l0_b, mask_b, np.array([930.0]),
        cfg=cfg.with_(otf_support=128), chunk=2)
    for pid in (0, 1):
        a = np.load(tmp_path / f"mh_a_{pid}.npz")
        assert_allclose(a["fit"], fit_s, rtol=0, atol=1e-4)
        assert_allclose(a["mean"], mean_s, rtol=0, atol=1e-6)
        assert_allclose(a["fitm"], fitm_s, rtol=0, atol=1e-4)
        b = np.load(tmp_path / f"mh_b_{pid}.npz")
        assert_allclose(b["fit"], fit_bs, rtol=0, atol=1e-4)
        assert_allclose(b["mean"], mean_bs, rtol=0, atol=1e-6)
