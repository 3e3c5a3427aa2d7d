"""Headline benchmark: single-device 640x480 detect+describe frames/s.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
vs_baseline compares against the reference's best published overall speed,
14.3 Hz on a GeForce 8800 GTX (doc/statistics.pdf Experiment #1 - the only
end-to-end frames/s the reference repo publishes; see BASELINE.md).
The frame is a seeded render (sfm/synthetic.scene_views), repeated BATCH
times.
"""

import json
import sys
import time

import numpy as np

REFERENCE_HZ = 14.3  # doc/statistics.pdf Exp #1, new packed, ~3082 features
BATCH = 16
WARMUP = 2
ITERS = 32
SEED = 0


def main():
    import jax
    import jax.numpy as jnp

    from hessgpu_tpu.config import SiftConfig
    from hessgpu_tpu.parallel.batch import _batched_pipeline
    from hessgpu_tpu.pyramid import _CfgKey, make_plan
    from hessgpu_tpu.sfm.synthetic import scene_views
    from hessgpu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    g = scene_views(SEED, 480, 640)[0]
    h, w = g.shape
    dev = jax.devices()[0]
    batch = jax.device_put(jnp.asarray(np.stack([g] * BATCH)), dev)

    def time_cfg(cfg):
        plan = make_plan(h, w, cfg)
        ckey = _CfgKey(cfg)
        for _ in range(WARMUP):
            table = _batched_pipeline(batch, plan, ckey)
        jax.block_until_ready(table)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            table = _batched_pipeline(batch, plan, ckey)
        jax.block_until_ready(table)
        fps = BATCH * ITERS / (time.perf_counter() - t0)
        return fps, int(np.asarray(table.count()).mean())

    fps, n_feats = time_cfg(SiftConfig())
    # DoG personality (-dog): the same pipeline with a different response
    # function; at the default threshold it finds more features, so the
    # matched-threshold run (t=0.028) separates workload from structure
    dog_fps, dog_n = time_cfg(SiftConfig(detector="dog"))
    dog_m_fps, dog_m_n = time_cfg(SiftConfig(detector="dog", threshold=0.028))

    print(json.dumps({
        "metric": "640x480_detect_describe_frames_per_sec_per_device",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / REFERENCE_HZ, 2),
        "features_per_frame": n_feats,
        "dog_fps": round(dog_fps, 2),
        "dog_features_per_frame": dog_n,
        "dog_matched_fps": round(dog_m_fps, 2),
        "dog_matched_features_per_frame": dog_m_n,
        "device": str(dev),
    }))


if __name__ == "__main__":
    sys.exit(main())
