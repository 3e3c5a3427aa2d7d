"""North-star SfM benchmark (BASELINE.json config 5).

Renders a synthetic TUM-layout sequence (no network access for real
TUM/KITTI; sfm/synthetic.py documents the stand-in), then runs the full
stack end-to-end: detect -> match -> incremental SfM (lookback PnP
registration, Cauchy BA, outlier pruning) -> loop closure (descriptor
retrieval + pose graph) -> distributed bundle adjustment over an
8-device mesh -> ATE vs exact ground truth.

Prints ONE JSON line: {"metric", "value" (ATE RMSE in scene units),
"unit", "registered", "frames"}.
"""

import json
import os
import sys
import tempfile
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

N_FRAMES = 40


def main():
    import jax
    # full pipeline on the virtual 8-device CPU mesh (distributed BA
    # needs a mesh)
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from hessgpu_tpu.parallel.batch import data_parallel_mesh
    from hessgpu_tpu.sfm.datasets import (evaluate_sequence_ate,
                                          load_tum_sequence)
    from hessgpu_tpu.sfm.synthetic import write_tum_sequence
    from hessgpu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    t0 = time.time()
    root = os.path.join(tempfile.gettempdir(), "hessgpu_synth_tum")
    meta = write_tum_sequence(root, n_frames=N_FRAMES, h=480, w=640)
    seq = load_tum_sequence(root)
    assert len(seq["image_paths"]) == N_FRAMES

    from hessgpu_tpu.config import SiftConfig
    cfg = SiftConfig()
    # denser detections than the default threshold: SfM accuracy is
    # track-limited on this scene (0.003 -> ~1.5k points, ATE 0.0014 vs
    # 736 points / ATE 0.23 at the default detection threshold)
    cfg.threshold = 0.003
    mesh = data_parallel_mesh(8)
    res = evaluate_sequence_ate(
        seq["image_paths"], seq["gt_centers"], K=meta["K"],
        cfg=cfg, mesh=mesh, verbose=False)
    print(json.dumps({
        "metric": "synthetic_tum40_ate_rmse",
        "value": round(float(res["ate"]), 4),
        "unit": "scene_units (scene ~4x4x3)",
        "registered": res["registered"],
        "frames": N_FRAMES,
        "points": res.get("points", 0),
        "wall_s": round(time.time() - t0, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
