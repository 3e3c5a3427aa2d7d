"""hess CLI end-to-end."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "hessgpu_tpu.cli.hess"] + args,
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_cli_detect_and_save(tmp_path, gray_small):
    from PIL import Image
    img_path = str(tmp_path / "img.png")
    Image.fromarray((gray_small * 255).astype(np.uint8)).save(img_path)

    r = _run_cli(["-i", img_path, "-v", "1", "-time"], str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "#Features:" in r.stdout
    assert os.path.exists(str(tmp_path / "img.sift"))
    assert os.path.exists(str(tmp_path / "img.timings"))

    # the sift file parses back
    from hessgpu_tpu.formats import load_sift_text
    feats = load_sift_text(str(tmp_path / "img.sift"))
    assert feats["x"].shape[0] > 0


def test_cli_image_list(tmp_path, gray_small):
    from PIL import Image
    p1 = str(tmp_path / "a.png")
    p2 = str(tmp_path / "b.png")
    Image.fromarray((gray_small * 255).astype(np.uint8)).save(p1)
    Image.fromarray((gray_small.T * 255).astype(np.uint8)).save(p2)
    lst = str(tmp_path / "list.txt")
    with open(lst, "w") as f:
        f.write("a.png\nb.png\n")
    r = _run_cli(["-il", lst, "-topk", "64"], str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(str(tmp_path / "a.sift"))
    assert os.path.exists(str(tmp_path / "b.sift"))
