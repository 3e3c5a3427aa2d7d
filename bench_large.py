"""Large-image benchmarks (VERDICT round-2 item 8).

The reference's published per-stage numbers are 1024x768 (statistics.pdf
Experiment #1, BASELINE.md rows 1-8) and a 2048x1500 code comment; every
round-2 repo benchmark was 640x480. This bench times detect+describe on:

  - 1024x768  (the statistics.pdf Experiment-1 shape)
  - 2048x1536 (the size of the reference's data/1600.jpg, its largest
    image: just under the -maxd 3200 ceiling and larger than the
    2048x1500 shape in the ProgramCU.cu:481-484 pyramid-time comment)

single image per run (the realistic large-frame serving shape), on
seeded renders (sfm/synthetic.scene_views). Prints ONE JSON line.
vs_baseline: 1024x768 fps against the reference's 14.3 Hz on the same
shape (doc/statistics.pdf Exp #1 overall; feature count there was ~3082
on an unusually feature-dense image, ours is whatever the render yields
at default settings).
"""

import json
import sys
import time

import numpy as np

ITERS = 20
REFERENCE_HZ = 14.3


def _time_shape(img_gray: np.ndarray, cfg):
    import jax
    import jax.numpy as jnp

    from hessgpu_tpu.pyramid import _CfgKey, make_plan, run_pipeline_jit

    h, w = img_gray.shape
    plan = make_plan(h, w, cfg)
    g = jnp.asarray(img_gray)
    table, _aux = run_pipeline_jit(g, plan, _CfgKey(cfg))
    jax.block_until_ready(table.x)
    n = int(jnp.sum(table.valid))
    t0 = time.perf_counter()
    for _ in range(ITERS):
        table, _aux = run_pipeline_jit(g, plan, _CfgKey(cfg))
    jax.block_until_ready(table)
    dt = (time.perf_counter() - t0) / ITERS
    return 1.0 / dt, n


def main():
    import jax

    from hessgpu_tpu.config import SiftConfig
    from hessgpu_tpu.sfm.synthetic import scene_views
    from hessgpu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = SiftConfig()
    fps1024, n1024 = _time_shape(scene_views(0, 768, 1024)[0], cfg)
    fps2048, n2048 = _time_shape(scene_views(0, 1536, 2048)[0], cfg)

    print(json.dumps({
        "metric": "large_image_fps_per_device",
        "value": round(fps1024, 1),
        "unit": "frames/s at 1024x768 (single seeded image)",
        "vs_baseline": round(fps1024 / REFERENCE_HZ, 1),
        "features_1024": n1024,
        "fps_2048x1536": round(fps2048, 1),
        "features_2048": n2048,
        "device": str(jax.devices()[0]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
