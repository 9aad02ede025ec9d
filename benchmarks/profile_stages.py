"""Per-stage device time of the night's chunk programs, from a
``jax.profiler`` trace.

For each dispatch group of the bench night (``plan_batch``: support
bucket, blue split), the group's fused chunk program (``_fit_chunk``)
is compiled ahead, run warm, and traced for a few runs.  Every device
event of the trace is attributed to one pipeline stage, named in the
program by ``jax.named_scope`` (``parallel/batch.py:reconstruct_one``):

    psd        correction-zone PSD model
    dphi       structure function (split basis + block transform)
    otf_zoom   OTF damping, direction mean and zoom-DFT contraction
    convolve   tip-tilt + instrument Moffat convolutions
    guard      OTF-support window guard
    moffat_fit batched Levenberg-Marquardt fit
    row_sum    masked PSF sum for the night's mean

An event is attributed through its HLO instruction (the ``hlo_op``
statistic, or the kernel name, which is the instruction name with ``.``
spelled ``_``) and that instruction's ``op_name`` metadata in the
compiled program text — a fusion through the instructions it calls.  A
kernel with no instruction of its own (a cuBLAS GEMM) takes the stage
of the kernel before it on its stream.  The script turns XLA's CUDA
command buffers off, so that every kernel is launched, and named, on
its own.  Then the whole night (``process_batch``) is traced once warm,
for its device busy time; the untraced warm wall time is reported
beside it.

Usage (on the card):  python benchmarks/profile_stages.py [npsflin] [chunk]
Prints one JSON object per group and one for the night; traces go to
``chiprun_out/profile/``.
"""

import glob
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("psd", "dphi", "otf_zoom", "convolve", "guard", "moffat_fit",
          "row_sum")
_STAGE_RE = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(STAGES)
                       + r")(?![A-Za-z0-9_])")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OPNAME_RE = re.compile(r"op_name=\"([^\"]*)\"")
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_COMP_RE = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")
# derived summary lines of a device plane (they repeat the kernels)
_DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "Launch Stats",
                  "Source code", "XLA TraceMe")


def stage_of_text(text):
    """The innermost pipeline stage named in a scope path, or None."""
    found = _STAGE_RE.findall(text or "")
    return found[-1] if found else None


def _norm(name):
    return re.sub(r"[.\-]", "_", name)


def hlo_stage_map(hlo_text):
    """Normalised HLO instruction name -> stage, from the compiled
    program's ``op_name`` metadata; a fusion without its own metadata
    takes the most common stage of the computation it calls."""
    own, calls, comp_stages, comp = {}, {}, {}, None
    for line in hlo_text.splitlines():
        c = _COMP_RE.match(line)
        if c and "=" not in line.split("(")[0]:
            comp = c.group(1)
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        op = _OPNAME_RE.search(line)
        st = stage_of_text(op.group(1)) if op else None
        if st is not None:
            own[m.group(1)] = st
            if comp is not None:
                comp_stages.setdefault(comp, []).append(st)
        cl = _CALLS_RE.search(line)
        if cl:
            calls[m.group(1)] = cl.group(1)
    out = {_norm(k): v for k, v in own.items()}
    for name, callee in calls.items():
        if _norm(name) not in out and comp_stages.get(callee):
            sts = comp_stages[callee]
            out[_norm(name)] = max(set(sts), key=sts.count)
    return out


def device_events(trace_dir):
    """(start_ns, duration_ns, name, stats) of every kernel-level event
    on the first GPU device plane of the newest trace in ``trace_dir``."""
    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise RuntimeError(f"no trace under {trace_dir}")
    pd = ProfileData.from_file(paths[-1])
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise RuntimeError("the trace holds no GPU device plane")
    plane = sorted(planes, key=lambda p: p.name)[0]
    lines = [ln for ln in plane.lines if ln.name not in _DERIVED_LINES]
    streams = [ln for ln in lines if ln.name.startswith("Stream")]
    events = []
    for ln in (streams or lines):
        for ev in ln.events:
            stats = {k: v for k, v in ev.stats}
            events.append((ev.start_ns, ev.duration_ns, ev.name, stats))
    return events


def busy_ns(events):
    """Union of the events' intervals."""
    iv = sorted((s, s + d) for s, d, *_ in events)
    total, cur_s, cur_e = 0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def attribute(events, hlo_map):
    """Per-stage summed device ns, the ns attributed only by neighbour,
    and the largest events left unattributed."""
    per, other = {s: 0 for s in STAGES}, {}
    by_neighbour, prev = 0, None
    for _, dur, name, stats in sorted(events, key=lambda e: e[0]):
        st = None
        for v in stats.values():
            if isinstance(v, str) and "/" in v:
                st = stage_of_text(v)
                if st:
                    break
        if st is None:
            hop = stats.get("hlo_op")
            if isinstance(hop, str):
                st = hlo_map.get(_norm(hop))
        if st is None:
            st = hlo_map.get(_norm(name))
        if st is None and prev is not None:
            st, by_neighbour = prev, by_neighbour + dur
        if st is None:
            other[name] = other.get(name, 0) + dur
        else:
            per[st] += dur
            prev = st
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    return per, by_neighbour, top


def main():
    # one launch per kernel, so every trace event names its HLO
    # instruction (inside a command buffer the kernels only name the
    # buffer); set before JAX starts its backends
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=")
    import jax
    import jax.numpy as jnp
    from bench import build_rows
    from muse_psfr_tpu.config import GalacsiConfig
    from muse_psfr_tpu.parallel.batch import (_fit_chunk, plan_batch,
                                              process_batch)
    from benchmarks.device_label import device_label

    npsflin = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    chunk = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    reps = 3
    out_dir = os.path.join(ROOT, "chiprun_out", "profile")
    cfg = GalacsiConfig()
    lbda = np.linspace(490, 930, 35)
    seeing, GL, L0, mask = build_rows(100)
    label = device_label()
    plan = plan_batch(seeing, GL, L0, mask, lbda, npsflin=npsflin, cfg=cfg,
                      chunk=chunk)
    lbda_j = jnp.asarray(plan.lbda, cfg.dtype)
    npixc_j = jnp.asarray(plan.npixc)
    night_dev_ns = 0
    for gi, g in enumerate(plan.groups):
        size = max(g.sizes)
        rows = np.asarray(g.rows)
        tab = plan.table[np.resize(rows, size)]
        t = jnp.asarray(tab, cfg.dtype)
        n = jnp.asarray(np.int32(min(size, rows.size)))
        compiled = _fit_chunk.lower(t, n, lbda_j, npixc_j, plan.h,
                                    plan.wind_speed, npsflin, g.cfg,
                                    cfg.fit_dtype).compile()
        hlo_text = compiled.as_text()
        hlo_map = hlo_stage_map(hlo_text)
        if not hlo_map:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"np{npsflin}_group{gi}.hlo"),
                      "w") as fh:
                fh.write(hlo_text)
        for _ in range(2):
            jax.block_until_ready(compiled(t, n, lbda_j, npixc_j))
        tdir = os.path.join(out_dir, f"np{npsflin}_group{gi}")
        t0 = time.perf_counter()
        with jax.profiler.trace(tdir):
            for _ in range(reps):
                jax.block_until_ready(compiled(t, n, lbda_j, npixc_j))
        wall = (time.perf_counter() - t0) / reps
        ev = device_events(tdir)
        per, by_neighbour, top = attribute(ev, hlo_map)
        busy = busy_ns(ev) / reps
        total = sum(per.values()) + sum(d for _, d in top)
        night_dev_ns += busy * len(g.sizes)
        print(json.dumps({
            "group": gi, "npsflin": npsflin, "chunk": size,
            "otf_support": int(g.cfg.otf_support),
            "otf_blue": list(g.cfg.otf_blue) if g.cfg.otf_blue else None,
            "n_chunks": len(g.sizes),
            "device_busy_ms_per_chunk": busy / 1e6,
            "traced_wall_ms_per_chunk": wall * 1e3,
            "stage_ms_per_chunk": {k: v / reps / 1e6
                                   for k, v in per.items()},
            "stage_share": {k: (v / total if total else None)
                            for k, v in per.items()},
            "by_neighbour_ms_per_chunk": by_neighbour / reps / 1e6,
            "unattributed_ms_per_chunk": [(k, v / reps / 1e6)
                                          for k, v in top],
            "n_events": len(ev), "hlo_ops_mapped": len(hlo_map),
            "device": label}), flush=True)

    def night():
        return process_batch(seeing, GL, L0, mask, lbda, npsflin=npsflin,
                             cfg=cfg, chunk=chunk)

    night()
    t0 = time.perf_counter()
    night()
    wall_untraced = time.perf_counter() - t0
    tdir = os.path.join(out_dir, f"np{npsflin}_night")
    t0 = time.perf_counter()
    with jax.profiler.trace(tdir):
        night()
    wall = time.perf_counter() - t0
    ev = device_events(tdir)
    busy = busy_ns(ev)
    print(json.dumps({
        "night": True, "npsflin": npsflin, "chunk": chunk, "rows": 100,
        "wall_s_untraced": wall_untraced, "wall_s_traced": wall,
        "device_busy_s": busy / 1e9,
        "idle_share_of_traced_wall": 1.0 - busy / 1e9 / wall,
        "sum_of_group_chunk_busy_s": night_dev_ns / 1e9,
        "device": label}), flush=True)


if __name__ == "__main__":
    main()
