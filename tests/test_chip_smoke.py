"""``chip_smoke.py`` on the CPU: what it refuses, the exact shape of its
result line, and its four-card phase rehearsed on four virtual CPU
devices at a tiny size."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Dev:
    def __init__(self, platform, kind):
        self.platform, self.device_kind = platform, kind


@pytest.mark.parametrize("platform", ["cpu", "rocm"])
def test_require_gpu_refuses_other_platforms(platform):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu([_Dev(platform, "x")])
    assert "needs an NVIDIA GPU" in str(exc.value.code)


def test_require_gpu_labels_the_device():
    devs = [_Dev("gpu", "NVIDIA H100 80GB HBM3")] * 4
    assert chip_smoke.require_gpu(devs) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}


def test_result_line_shape():
    line = chip_smoke.result_line({"platform": "gpu", "kind": "K",
                                   "count": 1, "card": "ignored"})
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu", "kind": "K", "count": 1}}


def test_unknown_arguments_rejected():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(["--five"])
    assert "unknown arguments" in str(exc.value.code)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_fails_without_a_gpu(tmp_path, where):
    """Run as a script on the CPU (and with no repository beside it):
    a non-zero exit and no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_plan_groups_summary():
    from muse_psfr_tpu.config import TINY_CONFIG
    from muse_psfr_tpu.parallel.batch import plan_batch
    plan = plan_batch([1.0, 1.1, 0.9], [0.7, 0.6, 0.8], [25.0, 20.0, 15.0],
                      np.ones((3, 4)), [600.0, 900.0], cfg=TINY_CONFIG,
                      chunk=2)
    groups = chip_smoke.plan_groups(plan)
    assert sum(g["rows"] for g in groups) == 3
    for g in groups:
        assert set(g) == {"otf_support", "otf_blue", "split", "rows",
                          "sizes"}
        json.dumps(g)


def test_sharded_night_matches_one_device():
    """The --four phase, rehearsed: 16 rows sharded over four virtual CPU
    devices against the same rows on one device."""
    import jax
    from muse_psfr_tpu.config import TINY_CONFIG
    devs = jax.devices()[:4]
    assert len(devs) == 4
    cfg = TINY_CONFIG.with_(dtype="float64", fit_dtype="float64")
    res = chip_smoke.sharded_night(devs, n_rows=16, chunk=8, cfg=cfg,
                                   lbda=np.array([600.0, 900.0]))
    assert res["devices"] == 4 and res["rows"] == 16
    # float64 on one host: the mean PSF is exact to rounding; the
    # 20-iteration LM fit turns rounding-level differences into ~1e-9
    # (float64) — far inside the float32 bounds the card is held to
    d = res["rel_diff"]
    assert d["psf_mean"] <= 1e-12 and d["ok"] == 0.0, d
    for name in chip_smoke.FIT_PARAMS:
        assert d[name] <= 1e-7, (name, d[name])
