"""Golden-fixture regression vs the reference's shipped output.

The reference repo ships doc/evaluation/box.siftgpu - the original SiftGPU
(DoG) detector's output on box.pgm with `-w 3 -fo -1 -loweo`
(demos/evaluation-box.bat). Our DoG personality is an independent
implementation, so we check cross-implementation repeatability and
descriptor agreement rather than bitwise equality.
"""

import os

import numpy as np
import pytest

from hessgpu_tpu import HessianSift, SiftConfig
from hessgpu_tpu.formats import load_sift_text


@pytest.fixture(scope="module")
def box_dir():
    """doc/evaluation of a reference checkout named by
    HESSGPU_REFERENCE_DIR; the fixture is not part of this repository."""
    d = os.path.join(os.environ.get("HESSGPU_REFERENCE_DIR", ""),
                     "doc", "evaluation")
    if not os.path.exists(os.path.join(d, "box.siftgpu")):
        pytest.skip("reference golden fixture absent: set "
                    "HESSGPU_REFERENCE_DIR to a sloup/hessgpu checkout")
    return d


@pytest.fixture(scope="module")
def golden(box_dir):
    return load_sift_text(os.path.join(box_dir, "box.siftgpu"))


@pytest.fixture(scope="module")
def ours(box_dir):
    cfg = SiftConfig.parse_args(["-w", "3", "-fo", "-1", "-loweo"])
    cfg.detector = "dog"
    return HessianSift(cfg).run(os.path.join(box_dir, "box.pgm"))


def test_feature_count_comparable(golden, ours):
    # measured 678 vs 673 after the corner-aligned upsample fix
    ratio = ours["x"].shape[0] / golden["x"].shape[0]
    assert 0.95 < ratio < 1.1, ratio


def test_repeatability_vs_golden(golden, ours):
    gx, gy, gs = golden["x"], golden["y"], golden["sigma"]
    ox, oy, osg = ours["x"], ours["y"], ours["sigma"]
    d2 = (gx[:, None] - ox[None, :]) ** 2 + (gy[:, None] - oy[None, :]) ** 2
    sr = np.maximum(gs[:, None], osg[None, :]) / \
        np.minimum(gs[:, None] + 1e-9, osg[None, :] + 1e-9)
    strict = ((d2 < 4.0) & (sr < 1.5)).any(axis=1).mean()
    loose = ((d2 < 9.0) & (sr < 2.0)).any(axis=1).mean()
    # measured 99.55% strict after the corner-aligned upsample fix
    # (ops/resize.upsample docstring): 670/673 golden keypoints match to
    # <0.1 px. The golden's sigma ladder predates the reference's own
    # "bug fix 9/12/2007" (SiftGPU.cpp:1425) - our labels follow the
    # current reference formula and still pass the 1.5x scale gate.
    # Slack below covers backend float noise only.
    assert strict > 0.97, f"strict repeatability {strict}"
    assert loose > 0.97, f"loose repeatability {loose}"


def test_descriptor_agreement(golden, ours):
    """Descriptors of spatially matched keypoints should correlate."""
    gx, gy, gs = golden["x"], golden["y"], golden["sigma"]
    ox, oy = ours["x"], ours["y"]
    d2 = (gx[:, None] - ox[None, :]) ** 2 + (gy[:, None] - oy[None, :]) ** 2
    nn = d2.argmin(axis=1)
    close = d2[np.arange(len(gx)), nn] < 1.0
    gd = golden["desc"][close]
    od = ours["desc"][nn[close]]
    gd = gd / (np.linalg.norm(gd, axis=1, keepdims=True) + 1e-9)
    od = od / (np.linalg.norm(od, axis=1, keepdims=True) + 1e-9)
    cos = (gd * od).sum(1)
    # measured 0.982 over 670 <1px matches after the upsample fix
    assert np.median(cos) > 0.95, np.median(cos)
