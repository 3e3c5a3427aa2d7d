"""Pairwise cross-scale matching benchmark (BASELINE.json config 3:
type-aware matching + two-view geometry on the reference's data/ pairs,
where 640-N.jpg is 800-N.jpg downsampled by exactly 1.25x).

Each of four seeded scenes (sfm/synthetic.scene_views) is rendered at
640x480 and at 800x600 from the same camera, which gives matching an
EXACT ground truth: a correct match satisfies x_800 = 1.25 * x_640 to
within a couple of pixels. For each scene this benchmark runs detect+describe on both
scales, type-aware mutual-best matching, and reports the fraction of
matches consistent with the known scale map (<= 3 px) -- a true
precision number, not a RANSAC self-consistency score. It also runs the
guided matcher (H = diag(1.25, 1.25, 1), reference GetGuidedSiftMatch
semantics with F=None) to exercise the guided path.

Two-view *pose* recovery is deliberately not run here: same-center
image pairs have zero baseline, so F/E estimation is degenerate by
construction -- pose and triangulation are exercised on the synthetic
sequence (bench_sfm.py) where ground-truth extrinsics exist.

Prints ONE JSON line; vs_baseline is mean precision against a 0.9 floor
(at least 90 % of accepted matches must be geometrically correct for a
matcher someone would build SfM on).
"""

import json
import sys
import time

SCALE = 800.0 / 640.0
TOL_PX = 3.0


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from hessgpu_tpu import HessianSift, SiftConfig, SiftMatcher
    from hessgpu_tpu.sfm.incremental import _match_pair
    from hessgpu_tpu.sfm.synthetic import scene_views
    from hessgpu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    t0 = time.time()
    sift = HessianSift(SiftConfig())
    matcher = SiftMatcher()
    H = np.diag([SCALE, SCALE, 1.0]).astype(np.float32)

    scenes = []
    for n in (1, 2, 3, 4):
        # one seeded scene rendered at both sizes from the same camera
        f_lo = sift.run(scene_views(n, 480, 640)[0])
        f_hi = sift.run(scene_views(n, 600, 800)[0])
        m = _match_pair(f_lo, f_hi, matcher)

        p_lo = np.stack([f_lo["x"][m[:, 0]], f_lo["y"][m[:, 0]]], 1)
        p_hi = np.stack([f_hi["x"][m[:, 1]], f_hi["y"][m[:, 1]]], 1)
        err = np.linalg.norm(p_lo * SCALE - p_hi, axis=1)
        good = int((err <= TOL_PX).sum())

        matcher.set_descriptors(0, f_lo["desc"])
        matcher.set_descriptors(1, f_hi["desc"])
        matcher.set_feature_location(
            0, np.stack([f_lo["x"], f_lo["y"]], 1))
        matcher.set_feature_location(
            1, np.stack([f_hi["x"], f_hi["y"]], 1))
        gm = matcher.get_guided_sift_match(H=H, F=None, hdistmax=8.0)
        gp_lo = np.stack([f_lo["x"][gm[:, 0]], f_lo["y"][gm[:, 0]]], 1)
        gp_hi = np.stack([f_hi["x"][gm[:, 1]], f_hi["y"][gm[:, 1]]], 1)
        gerr = np.linalg.norm(gp_lo * SCALE - gp_hi, axis=1)
        ggood = int((gerr <= TOL_PX).sum())

        scenes.append({
            "scene": n, "features_640": int(f_lo["x"].shape[0]),
            "features_800": int(f_hi["x"].shape[0]),
            "matches": int(len(m)), "correct": good,
            "precision": round(good / max(len(m), 1), 3),
            "guided_matches": int(len(gm)), "guided_correct": ggood,
        })

    mean_prec = float(np.mean([s["precision"] for s in scenes]))
    print(json.dumps({
        "metric": "crossscale_match_precision_640v800",
        "value": round(mean_prec, 3),
        "unit": "fraction of matches within 3px of exact 1.25x map",
        "vs_baseline": round(mean_prec / 0.9, 2),
        "scenes": scenes,
        "wall_s": round(time.time() - t0, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
