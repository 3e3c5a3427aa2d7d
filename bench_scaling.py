"""Scaling-efficiency benchmark: 1 device -> N devices (SURVEY.md section 7
item 7; BASELINE.json asks for >=80% 2-host scaling efficiency).

Weak scaling of the sharded detect+describe batch (parallel/batch.py
`detect_batch` over a 1-D 'batch' mesh): per-device batch is held fixed
while the mesh grows 1 -> 2 -> 4 -> ... -> N, reporting frames/s and
efficiency = fps(N) / (N * fps(1)).

Two facts make the >=80% target structurally safe on real hardware, and
both are verified here rather than asserted:

* The compiled sharded program contains ZERO inter-device collectives --
  detection is data-parallel over images, so each device runs its full
  local pipeline with no inter-device traffic (the translation of the
  reference's one-process-per-GPU pattern, ServerSiftGPU.cpp:156-194 /
  MultiThreadSIFT.cpp:83-149, which scaled the same way for the same
  reason). The script inspects the StableHLO for collective ops and
  reports `communication_free`.
* Input images are device_put to their home shard before timing, so
  there is no host fan-out inside the measured region.

By default the script measures the mesh on N virtual CPU devices.
Virtual devices share the same host cores -- the measured "efficiency"
then reflects host-core contention, not device scaling, and is reported
with `virtual: true` so it is not mistaken for a hardware number. With
--real on a host of several GPUs the same script measures true weak
scaling.

Prints ONE JSON line.
"""

import json
import os
import sys
import time

if __name__ == "__main__" and "--real" not in sys.argv:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

PER_DEVICE_B = 4
WARMUP = 1
ITERS = 3

# matched as HLO op lines ("  %x = all-reduce(...)" / "x = f32[...] all-reduce("),
# not bare substrings -- metadata/source-path strings can contain the words
COLLECTIVE_RE = (r"=\s*(\w+\[[^\]]*\]\s+)?"
                 r"(all-reduce|all-gather|all-to-all|collective-permute|"
                 r"reduce-scatter)\b")


def main():
    import jax

    virtual = "--real" not in sys.argv
    if virtual:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hessgpu_tpu.config import SiftConfig
    from hessgpu_tpu.parallel.batch import data_parallel_mesh
    from hessgpu_tpu.pyramid import _CfgKey, make_plan, run_pipeline_batched
    from hessgpu_tpu.sfm.synthetic import scene_views
    from hessgpu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n_dev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]

    g = scene_views(0, 480, 640)[0]
    h, w = g.shape
    cfg = SiftConfig()
    plan = make_plan(h, w, cfg)
    ckey = _CfgKey(cfg)

    def local_fn(local_imgs):
        return run_pipeline_batched(local_imgs, plan, ckey.cfg)[0]

    results = {}
    comm_free = None
    for n in sizes:
        mesh = data_parallel_mesh(n)
        b = PER_DEVICE_B * n
        batch = jnp.asarray(np.stack([g] * b))
        spec = P(mesh.axis_names[0])
        out_spec = jax.tree.map(
            lambda _: spec,
            jax.eval_shape(local_fn,
                           jax.ShapeDtypeStruct((PER_DEVICE_B, h, w),
                                                jnp.float32)))
        fn = jax.jit(jax.shard_map(local_fn, mesh=mesh, in_specs=spec,
                                   out_specs=out_spec))
        batch = jax.device_put(batch, NamedSharding(mesh, spec))
        if n == max(sizes):
            import re
            hlo = fn.lower(batch).compile().as_text()
            comm_free = re.search(COLLECTIVE_RE, hlo) is None
        for _ in range(WARMUP):
            jax.block_until_ready(fn(batch).valid)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            table = fn(batch)
        jax.block_until_ready(table)
        results[n] = b * ITERS / (time.perf_counter() - t0)

    base = results[sizes[0]]
    eff = {n: results[n] / (n * base) for n in sizes}
    two = 2 if 2 in eff else sizes[-1]
    print(json.dumps({
        "metric": "weak_scaling_efficiency_2dev",
        "value": round(eff[two], 3),
        "unit": "fraction",
        "vs_baseline": round(eff[two] / 0.80, 2),
        "fps": {str(n): round(results[n], 1) for n in sizes},
        "efficiency": {str(n): round(eff[n], 3) for n in sizes},
        "per_device_batch": PER_DEVICE_B,
        "communication_free": comm_free,
        "virtual": virtual,
        "devices": str(jax.devices()[0]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
