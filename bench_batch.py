"""Secondary benchmark: BASELINE.json config 2 - batched detect+describe
over a list of five 640x480 images (data/list640.txt in the reference;
seeded renders here) with top-K 2048 selection.

Prints one JSON line (same schema as bench.py). Not run by the driver
automatically; kept for apples-to-apples tracking of the batched+topk
workload.
"""

import json
import sys
import time

import numpy as np

REFERENCE_HZ = 14.3


def main():
    import jax
    import jax.numpy as jnp

    from hessgpu_tpu.config import SiftConfig, TRUNCATE_TOP_K
    from hessgpu_tpu.parallel.batch import _batched_pipeline
    from hessgpu_tpu.pyramid import _CfgKey, make_plan
    from hessgpu_tpu.sfm.synthetic import scene_views
    from hessgpu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    batch = jnp.asarray(scene_views(0, 480, 640,
                                    positions=np.linspace(0, 1, 5)))

    cfg = SiftConfig(truncate_method=TRUNCATE_TOP_K,
                     feature_count_threshold=2048)
    plan = make_plan(batch.shape[1], batch.shape[2], cfg)
    ckey = _CfgKey(cfg)

    for _ in range(2):
        table = _batched_pipeline(batch, plan, ckey)
        jax.block_until_ready(table.valid)

    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        table = _batched_pipeline(batch, plan, ckey)
    jax.block_until_ready(table.valid)
    dt = time.perf_counter() - t0

    fps = batch.shape[0] * iters / dt
    counts = np.asarray(table.count())
    print(json.dumps({
        "metric": "list640_batch_topk2048_frames_per_sec_per_device",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / REFERENCE_HZ, 2),
        "features_per_frame": counts.tolist(),
    }))


if __name__ == "__main__":
    sys.exit(main())
