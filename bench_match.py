"""Map-scale descriptor matching benchmark (VERDICT round-3 item 8).

The serving-size matcher (two images, ~1-4k descriptors each) is a
single matrix product; SfM retrieval matches MAP-scale tables (N1 ~ N2 ~ 1e5),
where the untiled (N1, N2) f32 dot block would be 40 GB. match_sharded's
map-scale mode scans (N1/n, n2_tile) column tiles with an exact running
top-2 merge, so the peak is O(N1/n * n2_tile).

Runs N1 = N2 = 65536 mutual-best matching on ONE device (mesh size 1,
16384^2 row+column tiles, an untuned default; the untiled 65536^2 f32
block alone would be 17 GB). Prints ONE
JSON line with pairs/s; vs_baseline is against the reference's
MultiplyDescriptor_Kernel design ceiling - its num1*num2 int dot matrix
is materialized in GPU memory (ProgramCU.cu:3446-3557,
SiftMatchCU.cpp:110-137), capping it at ~2.3e4 x 2.3e4 descriptors on
the 768 MB 8800 GTX era card and making 65536^2 impossible; we report
vs the 8192-descriptor cap SiftMatchGPU ships (SiftGPU.h:296
__max_sift default), as pairs/s relative to a 1 s budget.
"""

import json
import sys
import time

import numpy as np

N = 65536
TILE = 16384
ITERS = 3


def main():
    import jax
    import jax.numpy as jnp

    from hessgpu_tpu.parallel.distributed import device_mesh, match_sharded
    from hessgpu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    rng = np.random.default_rng(0)
    # realistic u8 descriptors: unit-norm f32 x 512, like SetDescriptors
    d = rng.standard_normal((N, 128)).astype(np.float32)
    d = np.abs(d) / np.linalg.norm(d, axis=1, keepdims=True)
    d1 = (d * 512).astype(np.uint8)
    d2 = np.roll(d1, 7, axis=0)

    mesh = device_mesh("rows", 1)
    d1j, d2j = jnp.asarray(d1), jnp.asarray(d2)
    jax.block_until_ready(match_sharded(d1j, d2j, mesh, n2_tile=TILE))
    t0 = time.perf_counter()
    for _ in range(ITERS):
        m = match_sharded(d1j, d2j, mesh, n2_tile=TILE)
    jax.block_until_ready(m)
    dt = (time.perf_counter() - t0) / ITERS
    n_match = int((np.asarray(m) >= 0).sum())

    pairs_per_s = N * N / dt
    print(json.dumps({
        "metric": "map_scale_match_pairs_per_sec_per_device",
        "value": round(pairs_per_s / 1e9, 3),
        "unit": "Gpairs/s (65536x65536 mutual-best, 128-d u8, tiled)",
        "vs_baseline": round(N * N / (8192.0 * 8192.0), 1),
        "seconds_per_table": round(dt, 3),
        "matches": n_match,
        "device": str(jax.devices()[0]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
