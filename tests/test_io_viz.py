"""Image I/O (PGM/PPM parser) and visualization dumps."""

import os

import numpy as np
import pytest

from hessgpu_tpu.io_image import limit_working_size, load_image, load_pnm


def test_pgm_binary_roundtrip(tmp_path, rng):
    arr = (rng.rand(37, 53) * 255).astype(np.uint8)
    p = str(tmp_path / "t.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# comment line\n53 37\n255\n")
        f.write(arr.tobytes())
    back = load_pnm(p)
    np.testing.assert_array_equal(back, arr)


def test_pgm_ascii(tmp_path):
    p = str(tmp_path / "t.pgm")
    with open(p, "w") as f:
        f.write("P2\n3 2\n255\n0 128 255\n10 20 30\n")
    back = load_pnm(p)
    np.testing.assert_array_equal(back, [[0, 128, 255], [10, 20, 30]])


def test_ppm_binary(tmp_path, rng):
    arr = (rng.rand(5, 7, 3) * 255).astype(np.uint8)
    p = str(tmp_path / "t.ppm")
    with open(p, "wb") as f:
        f.write(b"P6\n7 5\n255\n")
        f.write(arr.tobytes())
    np.testing.assert_array_equal(load_pnm(p), arr)


def test_load_reference_box_pgm(tmp_path):
    """load_image reads a binary PGM the size of the reference's
    doc/evaluation/box.pgm (324x223) as u8."""
    from hessgpu_tpu.sfm.synthetic import scene_views
    arr = (scene_views(seed=1, h=223, w=324)[0] * 255).astype(np.uint8)
    p = str(tmp_path / "box.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n324 223\n255\n")
        f.write(arr.tobytes())
    img = load_image(p)
    assert img.shape == (223, 324)
    assert img.dtype == np.uint8
    np.testing.assert_array_equal(img, arr)


def test_limit_working_size():
    img = np.zeros((1000, 1600), np.float32)
    out, ds = limit_working_size(img, 800)
    assert ds == 1 and out.shape == (500, 800)
    out, ds = limit_working_size(img, 4000)
    assert ds == 0 and out.shape == (1000, 1600)


def test_viz_keypoint_render(gray_small):
    from hessgpu_tpu.utils.viz import draw_keypoints
    feats = {
        "x": np.array([50.0, 100.0]), "y": np.array([40.0, 80.0]),
        "sigma": np.array([2.0, 4.0]), "theta": np.array([0.5, 2.0]),
        "ftype": np.array([0, 2]),
    }
    out = draw_keypoints(gray_small, feats)
    assert out.shape == gray_small.shape + (3,)
    assert out.max() <= 1.0 and (out != np.stack([gray_small] * 3, -1)).any()


def test_native_io_available_and_consistent(tmp_path, rng):
    """Native decode/write (libhessio) matches the Python implementations."""
    import subprocess
    from hessgpu_tpu import native
    if not native.available():
        # the library builds from csrc/hessio.cpp in about a second
        csrc = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "csrc")
        subprocess.run(["make", "-C", csrc, "build/libhessio.so"],
                       check=True, capture_output=True, timeout=300)
        native._TRIED = False
    assert native.available(), "libhessio.so must be built (make -C csrc)"

    arr = (rng.rand(17, 23) * 255).astype(np.uint8)
    p = str(tmp_path / "t.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n23 17\n255\n")
        f.write(arr.tobytes())
    got = native.decode_pnm_gray(p)
    np.testing.assert_array_equal(got, arr)

    n = 5
    feats = {
        "x": rng.rand(n).astype(np.float32) * 100,
        "y": rng.rand(n).astype(np.float32) * 100,
        "sigma": rng.rand(n).astype(np.float32) + 1,
        "theta": rng.rand(n).astype(np.float32),
        "response": rng.randn(n).astype(np.float32) * 0.01,
        "ftype": np.arange(n, dtype=np.int32) % 3,
        "level": np.arange(n, dtype=np.int32),
        "desc": np.abs(rng.randn(n, 128).astype(np.float32)) * 0.1,
    }
    from hessgpu_tpu.formats import load_sift_text
    pn = str(tmp_path / "native.sift")
    assert native.write_sift_text(pn, feats)
    back = load_sift_text(pn)
    np.testing.assert_allclose(back["x"], feats["x"], atol=0.01)
    np.testing.assert_allclose(back["desc"], feats["desc"], atol=0.5 / 512)
    np.testing.assert_array_equal(back["ftype"], feats["ftype"])


def test_dump_views_end_to_end(tmp_path, gray_small):
    """The 7-view dump (reference viewer parity) runs and writes files."""
    from hessgpu_tpu.utils.viz import dump_views
    out = str(tmp_path / "views")
    dump_views((gray_small * 255).astype(np.uint8), out_dir=out)
    names = set(os.listdir(out))
    assert "0_input.png" in names
    assert "6_keypoints.png" in names
    assert any(n.startswith("1_gauss") for n in names)
    assert any(n.startswith("3_resp") for n in names)
    assert any(n.startswith("4_grad") for n in names)
