"""chip_smoke.py's phases and comparisons at tiny sizes on the CPU.

On the CPU the "reference device" is the device under test itself, so
every comparison must come out exact; the tests then check that the
comparisons do catch a difference.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def vo(smoke, cpu):
    return smoke.phase_vo_frame(0, 180, 240, cpu)


def test_main_refuses_cpu_backend(smoke, capsys):
    assert smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err


def test_phase_vo_frame(vo):
    for name in ("hessian", "dog"):
        assert len(vo[name]["x"]) > 0
        np.testing.assert_array_equal(vo[name]["x"], vo[name + "_ref"]["x"])


def test_compare_features_catches_differences(smoke, vo):
    ref = vo["hessian_ref"]
    obs = smoke.compare_features(ref, ref, "same")
    assert obs["matched_frac"] == 1.0 and obs["max_desc_l2"] == 0.0
    moved = dict(ref, x=ref["x"] + 0.05)
    with pytest.raises(smoke.SmokeFailure, match="keypoints"):
        smoke.compare_features(moved, ref, "moved")
    turned = dict(ref, theta=ref["theta"] + 0.01)
    with pytest.raises(smoke.SmokeFailure, match="agreement"):
        smoke.compare_features(turned, ref, "turned")
    fewer = {k: v[:-2] for k, v in ref.items()}
    with pytest.raises(smoke.SmokeFailure, match="count"):
        smoke.compare_features(fewer, ref, "fewer")


def test_phase_batch(smoke, vo):
    out = smoke.phase_batch(0, 180, 240, 2, vo["frame"], vo["hessian_ref"])
    assert out["imgs"].shape == (2, 180, 240)


def test_phase_photo(smoke, cpu):
    feats = smoke.phase_photo(0, 180, 240, cpu, breakdown=False)
    assert len(feats["x"]) > 0


def test_phase_describe(smoke, vo, cpu):
    out = smoke.phase_describe(vo["frame"], vo["hessian"], cpu)
    assert out["desc"].shape == (len(vo["hessian"]["x"]), 128)


def test_phase_match(smoke):
    out = smoke.phase_match(0, 180, 240)
    assert len(out["matches"]) > 0


def test_match_numpy_equals_sift_matcher(smoke, rng):
    """The NumPy brute-force matcher is the plain reference for
    SiftMatcher: identical pairs, including rows the ratio or mutual
    test rejects."""
    from hessgpu_tpu import SiftMatcher
    from hessgpu_tpu.matcher import quantize_descriptors

    unit = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)
    base = rng.rand(40, 128) ** 3
    d1 = quantize_descriptors(unit(base[:30]))
    d2 = quantize_descriptors(unit(base[10:] + 0.15 * rng.rand(30, 128)))
    m = SiftMatcher()
    m.set_descriptors(0, d1)
    m.set_descriptors(1, d2)
    want = m.get_sift_match()
    got = smoke.match_numpy(d1, d2)
    assert 0 < len(want) < len(d1)
    np.testing.assert_array_equal(got, want)


def test_phase_ba(smoke, cpu):
    obs = smoke.phase_ba("tiny", cams=8, pts=256, see_every=2, iters=2,
                         ref_device=cpu)
    assert obs["cost_rel"] == 0.0 and obs["rmse_rel"] == 0.0


def test_run_four_on_virtual_devices(smoke):
    """The --four paths (data-parallel detect, observation-sharded BA,
    row-sharded matching) on 4 of the 8 virtual CPU devices, each against
    its one-device result."""
    smoke.run_four(0, 180, 240, 4,
                   {"tiny": dict(cams=8, pts=256, see_every=2)})
