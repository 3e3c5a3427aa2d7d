"""Stage timing instrumentation.

Equivalent of the reference's ClockTimer/_timing[] buckets
(GlobalUtil.cpp:301-405, config.h:17-31), with JAX-aware fencing: a stage is
closed only after block_until_ready when a device value is registered.
"""

from __future__ import annotations

import contextlib
import re
import time
from collections import OrderedDict
from typing import Dict, List, Tuple


class StageTimer:
    """Accumulates wall-clock per named stage; last-run and running mean."""

    def __init__(self):
        self.last: "OrderedDict[str, float]" = OrderedDict()
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                fence.block_until_ready()
            dt = (time.perf_counter() - t0) * 1000.0
            self.last[name] = dt
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals.get(name, 0.0) / c if c else 0.0

    def report(self) -> str:
        lines = [f"{k:<24s} {v:9.2f} ms (mean {self.mean(k):9.2f} ms)"
                 for k, v in self.last.items()]
        return "\n".join(lines)

    def csv(self) -> str:
        """Per-stage CSV like hess -time (hessgpucmd.cpp:49-67)."""
        keys = list(self.last.keys())
        head = ",".join(keys)
        vals = ",".join(f"{self.last[k]:.3f}" for k in keys)
        return head + "\n" + vals + "\n"


# ---------------------------------------------------------------------------
# per-stage DEVICE time (reference TIMINGS_* buckets, config.h:17-31)
# ---------------------------------------------------------------------------

# reference bucket names; LOAD_IMAGE / DOWNLOAD_KEYPOINTS are host-side
# (StageTimer covers them), GENERATE_VBO has no analogue here
REFERENCE_BUCKETS = (
    "BUILD_PYRAMID", "DETECT_KEYPOINTS", "GENERATE_FEATURE_LIST",
    "COMPUTE_ORIENTATIONS", "MULTI_ORIENTATIONS", "COMPUTE_DESCRIPTORS",
    "FEATURES_REDUCTION", "OTHER", "TOTAL",
)


def hlo_op_buckets(hlo_text: str) -> Dict[str, str]:
    """HLO instruction name -> reference bucket, from the op_name metadata
    that run_pipeline's jax.named_scope(bucket) leaves on every op of the
    compiled module's text."""
    pat = re.compile(r"%([\w.\-]+) = .*?op_name=\"([^\"]+)\"")
    meta = {}
    for line in hlo_text.splitlines():
        m = pat.search(line)
        if m:
            for b in REFERENCE_BUCKETS:
                if b in m.group(2):
                    meta[m.group(1)] = b
                    break
    return meta


def op_events(profile) -> List[Tuple[str, str, float]]:
    """(hlo_op, event name, duration ms) of every op that ran on device 0
    in a jax.profiler.ProfileData.

    On a GPU these are the kernel events of the /device:GPU:0 plane's
    stream lines; each names its kernel and carries the hlo_op it came
    from ("command_buffer" for a kernel replayed inside a CUDA graph).
    The CPU backend has no device plane: its ops run as events with an
    hlo_op stat on the /host:CPU plane's threads, read so that tests
    exercise the same reduction."""
    planes = {p.name: p for p in profile.planes}
    gpu = planes.get("/device:GPU:0")
    if gpu is not None:
        lines = [l for l in gpu.lines if l.name.startswith("Stream")]
    else:
        lines = list(planes["/host:CPU"].lines)
    out = []
    for line in lines:
        for ev in line.events:
            op = next((v for k, v in ev.stats if k == "hlo_op"), None)
            if op:
                out.append((op, ev.name, ev.duration_ns / 1e6))
    return out


def device_stage_breakdown(jitted_fn, *args, runs: int = 5):
    """Per-stage DEVICE milliseconds for one jitted pipeline call.

    The reference fences every stage and reads wall clocks
    (PyramidCU.cpp:52-70); under a single fused XLA program that would
    destroy the very overlap we rely on, so instead this maps a profiler
    trace's per-op device times back to pipeline stages through the
    named-scope metadata (hlo_op_buckets).

    args are jitted_fn's arguments; the arrays among them are its dynamic
    ones. The traced executable is compiled with XLA's GPU command
    buffers off, so every kernel, library calls included, reports the HLO
    instruction it belongs to; kernel times are those of the normal
    program, launch gaps are not. TOTAL is the sum of all op time on the
    device, OTHER what no bucket claims. Raises if the trace holds no op
    or no op maps to a bucket, rather than report zeros.
    Returns OrderedDict bucket -> ms per call.
    """
    import glob
    import shutil
    import tempfile

    import jax
    import numpy as np

    compiled = jitted_fn.lower(*args).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    meta = hlo_op_buckets(compiled.as_text())
    # a kernel fused from instruction "a_fusion.3" is named "a_fusion_3"
    by_kernel = {k.replace(".", "_"): b for k, b in meta.items()}
    dyn = [a for a in args if isinstance(a, (jax.Array, np.ndarray))]
    jax.block_until_ready(compiled(*dyn))
    trace_dir = tempfile.mkdtemp(prefix="hessgpu_trace_")
    try:
        with jax.profiler.trace(trace_dir):
            for _ in range(runs):
                out = compiled(*dyn)
            jax.block_until_ready(out)
        paths = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
        events = op_events(jax.profiler.ProfileData.from_file(paths[0]))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)

    buckets = OrderedDict((b, 0.0) for b in REFERENCE_BUCKETS)
    for op, kernel, ms in events:
        b = meta.get(op) or by_kernel.get(kernel, "OTHER")
        buckets[b] += ms / runs
        buckets["TOTAL"] += ms / runs
    if not events or buckets["TOTAL"] == buckets["OTHER"]:
        raise RuntimeError(
            f"profiler trace: {len(events)} device ops, none in a "
            f"pipeline stage bucket")
    return buckets
