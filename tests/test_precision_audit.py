"""Every contraction on the traced path states its precision.

A float32 ``dot_general`` at default precision may run in TF32 on an
NVIDIA GPU (10-bit mantissa), which costs ~1e-5 on the PSF — the whole
rms budget against the float64 oracle.  These tests trace the night's
chunk programs and the CLI's at the production width and fail on any
``dot_general`` (or convolution) that is not at ``Precision.HIGHEST``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

from muse_psfr_tpu.config import GalacsiConfig
from muse_psfr_tpu.fit.moffat_fit import fit_moffat_cube_packed
from muse_psfr_tpu.otf.psf import lambda_crop_size
from muse_psfr_tpu.parallel.batch import _fit_chunk, _reconstruct_chunk

H = (100.0, 10000.0)
WIND = 12.0
HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(v):
    if isinstance(v, ClosedJaxpr):
        yield v.jaxpr
    elif isinstance(v, Jaxpr):
        yield v
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _sub_jaxprs(x)


def low_precision_contractions(jaxpr):
    """(primitive, precision) of every contraction below HIGHEST."""
    bad = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            prec = eqn.params.get("precision")
            precs = prec if isinstance(prec, tuple) else (prec,)
            if any(p != HIGHEST for p in precs):
                bad.append((eqn.primitive.name, prec))
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                bad += low_precision_contractions(sub)
    return bad


def _chunk_args(cfg, nl, rows=2):
    lb = np.linspace(490, 930, nl) if nl > 3 else np.linspace(500, 900, nl)
    t = jnp.asarray(np.tile([1.0, 0.7, 25.0, 1, 1, 1, 1], (rows, 1)),
                    cfg.dtype)
    return t, jnp.asarray(lb, cfg.dtype), jnp.asarray(
        lambda_crop_size(lb, cfg))


@pytest.mark.parametrize("kind", ["fit", "recon"])
@pytest.mark.parametrize("npsflin,nl,support", [
    (1, 3, 0),             # the CLI's single condition (3 wavelengths)
    (1, 35, 256),          # the night's reduced-window bucket
    (3, 35, 0),            # the 9-direction full-window bucket
], ids=["cli", "night-reduced", "ndir9-full"])
def test_traced_night_has_only_highest_contractions(kind, npsflin, nl,
                                                    support):
    cfg = GalacsiConfig(otf_support=support)
    t, lb, npixc = _chunk_args(cfg, nl)
    if kind == "fit":
        jaxpr = jax.make_jaxpr(
            lambda t, n, lb, npx: _fit_chunk(t, n, lb, npx, H, WIND,
                                             npsflin, cfg, "float32"))(
            t, jnp.asarray(np.int32(2)), lb, npixc)
    else:
        jaxpr = jax.make_jaxpr(
            lambda t, lb, npx: _reconstruct_chunk(t, lb, npx, H, WIND,
                                                  npsflin, cfg))(
            t, lb, npixc)
    assert low_precision_contractions(jaxpr.jaxpr) == []


def test_fft_free_and_mean_fit_have_only_highest_contractions():
    """The FFT-free path's DFT matmuls and the mean-PSF fit program."""
    cfg = GalacsiConfig(use_fft=False)
    t, lb, npixc = _chunk_args(cfg, 3)
    jaxpr = jax.make_jaxpr(
        lambda t, lb, npx: _reconstruct_chunk(t, lb, npx, H, WIND, 1,
                                              cfg))(t, lb, npixc)
    assert low_precision_contractions(jaxpr.jaxpr) == []
    jaxpr = jax.make_jaxpr(
        lambda c: fit_moffat_cube_packed(c, dtype="float32"))(
        jnp.ones((3, 40, 40), jnp.float32))
    assert low_precision_contractions(jaxpr.jaxpr) == []


def test_audit_catches_default_precision():
    """The audit itself: a default-precision dot nested in a jit and a
    scan is found; an explicit HIGHEST one is not."""
    def f(a, b):
        def body(c, _):
            return c + jnp.dot(a, b), None
        inner = jax.jit(lambda x: jax.lax.scan(body, x, None, length=2)[0])
        return inner(a) + jnp.matmul(a, b, precision=HIGHEST)

    a = jnp.ones((4, 4), jnp.float32)
    bad = low_precision_contractions(jax.make_jaxpr(f)(a, a).jaxpr)
    assert len(bad) == 1 and bad[0][0] == "dot_general"
