"""Keypoint-list re-entry path (descriptor service)."""

import numpy as np
import pytest

from hessgpu_tpu import HessianSift, SiftConfig
from hessgpu_tpu.describe import describe_keypoints


@pytest.fixture(scope="module")
def detected(gray_small):
    sift = HessianSift(SiftConfig())
    return sift.run(gray_small)


def test_describe_given_orientation_matches_pipeline(gray_small, detected):
    """Feeding detected keypoints (x, y, sigma, theta) back through the
    descriptor service must reproduce the pipeline's descriptors."""
    n = min(40, detected["x"].shape[0])
    sel = np.arange(n)
    keys = np.stack([detected["x"][sel], detected["y"][sel],
                     detected["sigma"][sel], detected["theta"][sel]], axis=1)
    out = describe_keypoints(gray_small, keys, SiftConfig(),
                             has_orientation=True)
    # descriptors should match the pipeline's (same math, same windows)
    dots = np.sum(out["desc"] * detected["desc"][sel], axis=1)
    assert (dots > 0.999).mean() > 0.9, f"desc agreement too low: {dots}"


def test_describe_computes_orientation(gray_small, detected):
    """Without orientations the service computes the strongest one, which
    should usually agree with one of the pipeline's orientations."""
    n = min(40, detected["x"].shape[0])
    sel = np.arange(n)
    keys = np.stack([detected["x"][sel], detected["y"][sel],
                     detected["sigma"][sel]], axis=1)
    out = describe_keypoints(gray_small, keys, SiftConfig(),
                             has_orientation=False)
    dth = np.abs(out["theta"][sel] - detected["theta"][sel])
    dth = np.minimum(dth, 2 * np.pi - dth)
    # multi-orientation entries may pick a different peak; most should agree
    # within the 8-bit quantization step (2*pi/255)
    assert (dth < 0.06).mean() > 0.6, dth


def test_describe_preserves_input_order(gray_small, detected):
    n = min(30, detected["x"].shape[0])
    perm = np.random.RandomState(0).permutation(n)
    keys = np.stack([detected["x"][:n], detected["y"][:n],
                     detected["sigma"][:n], detected["theta"][:n]], axis=1)
    out_f = describe_keypoints(gray_small, keys, SiftConfig())
    out_p = describe_keypoints(gray_small, keys[perm], SiftConfig())
    np.testing.assert_allclose(out_p["desc"], out_f["desc"][perm], atol=1e-5)
    np.testing.assert_array_equal(out_p["x"], out_f["x"][perm])


def test_facade_run_with_keypoints(gray_small, detected):
    """HessianSift.run_with_keypoints / set_keypoint_list round-trip."""
    from hessgpu_tpu import HessianSift, SiftConfig
    n = min(20, detected["x"].shape[0])
    keys = np.stack([detected["x"][:n], detected["y"][:n],
                     detected["sigma"][:n], detected["theta"][:n]], axis=1)
    sift = HessianSift(SiftConfig())
    out = sift.run_with_keypoints(gray_small, keys)
    assert out["desc"].shape == (n, 128)
    dots = np.sum(out["desc"] * detected["desc"][:n], axis=1)
    assert (dots > 0.999).mean() > 0.85

    sift.run(gray_small)          # loads the image
    sift.set_keypoint_list(keys)
    out2 = sift.run_on_current()
    np.testing.assert_allclose(out2["desc"], out["desc"], atol=1e-5)
