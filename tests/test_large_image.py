"""Large-image / -maxd path regression: the auto-downscale under the
working-dimension cap (io_image.limit_working_size + the coordinate
scale-back in detector._run) must report features in the ORIGINAL image
frame, matching what full-resolution detection finds at the shifted
octave.

Reference semantics: PyramidCU.cpp:153-191 skips octaves under -maxd so
downstream consumers see consistent full-frame coordinates; GlobalUtil
-maxd default 3200 (GlobalUtil.cpp:82).
"""

import numpy as np
import pytest

from hessgpu_tpu import HessianSift, SiftConfig


@pytest.fixture(scope="module")
def img1024():
    # a seeded 1024x768 view: big enough to exercise multiple octaves,
    # small enough for the CPU-backend CI budget
    from hessgpu_tpu.sfm.synthetic import scene_views
    return scene_views(seed=2, h=768, w=1024)[0]


def _detect(img, max_dim):
    cfg = SiftConfig()
    cfg.max_dim = max_dim
    return HessianSift(cfg).run(img)


def test_maxd_coordinates_land_on_fullres_features(img1024):
    """Features detected under the cap (ds=1) must align with the
    full-resolution run's features in the shared original frame: each
    capped feature within scale*2 px of some full-res feature, and sigma
    doubled. This is a cross-scale repeatability gate on the coordinate
    mapping, not an identity check."""
    full = _detect(img1024, 3200)     # no downscale
    capped = _detect(img1024, 600)    # forces ds=1 (1024 -> 512)
    assert len(capped["x"]) > 20

    # capped coordinates must span the ORIGINAL frame, not the working one
    assert capped["x"].max() > 512.0

    fx, fy = full["x"], full["y"]
    hits = 0
    for x, y in zip(capped["x"], capped["y"]):
        d2 = (fx - x) ** 2 + (fy - y) ** 2
        if d2.size and d2.min() < (2.0 * 2.0) ** 2:
            hits += 1
    # octave-1 full-res features correspond to octave-0 capped ones; the
    # capped run also sees content the full run assigns to higher octaves
    assert hits / len(capped["x"]) > 0.6, hits / len(capped["x"])

    # sigmas come back in original-frame units (scaled by 2^ds)
    assert capped["sigma"].min() > full["sigma"].min() * 1.9


def test_maxd_no_cap_is_identity(img1024):
    a = _detect(img1024, 3200)
    b = _detect(img1024, 1024)  # exactly at the cap: no downscale
    np.testing.assert_array_equal(a["x"], b["x"])
    np.testing.assert_array_equal(a["desc"], b["desc"])
