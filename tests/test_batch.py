"""Batched detection and shape bucketing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hessgpu_tpu import HessianSift, SiftConfig
from hessgpu_tpu.parallel.batch import (bucket_images, data_parallel_mesh,
                                        detect_batch)


def test_detect_batch_matches_single(gray_small):
    imgs = np.stack([gray_small, gray_small[::-1].copy()])
    table = detect_batch(imgs, SiftConfig())
    counts = np.asarray(table.count())
    assert counts.shape == (2,)

    single = HessianSift(SiftConfig()).run(imgs[0])
    assert counts[0] == single["x"].shape[0]
    # same features in slot order
    valid0 = np.asarray(table.valid[0])
    np.testing.assert_allclose(np.asarray(table.x[0])[valid0],
                               single["x"], atol=1e-5)


def test_detect_batch_sharded(gray_small):
    mesh = data_parallel_mesh(8)
    imgs = np.stack([np.roll(gray_small, s, axis=1) for s in range(8)])
    table = detect_batch(imgs, SiftConfig(), mesh=mesh)
    counts = np.asarray(table.count())
    assert counts.shape == (8,)
    assert (counts > 0).all()
    # shifting columns shouldn't radically change feature counts
    assert counts.max() < counts.min() * 2 + 50


def test_run_pipeline_batched_equals_single(gray_small):
    """run_pipeline_batched (one program, flat in B) == per-image
    run_pipeline, field for field, including the aux count reports."""
    from hessgpu_tpu.pyramid import (make_plan, run_pipeline,
                                     run_pipeline_batched)

    imgs = np.stack([gray_small, gray_small[::-1].copy(),
                     gray_small[:, ::-1].copy()])
    cfg = SiftConfig()
    plan = make_plan(*gray_small.shape, cfg)
    bt, baux = run_pipeline_batched(jnp.asarray(imgs), plan, cfg)
    for i in range(imgs.shape[0]):
        st, saux = run_pipeline(jnp.asarray(imgs[i]), plan, cfg)
        for f in st._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(bt, f)[i]), np.asarray(getattr(st, f)),
                err_msg=f"field {f}, image {i}")
        np.testing.assert_array_equal(np.asarray(baux["level_counts"][i]),
                                      np.asarray(saux["level_counts"]))
        assert int(baux["pre_count"][i]) == int(saux["pre_count"])


def test_bucket_images():
    imgs = [np.ones((100, 150), np.float32),
            np.ones((240, 320), np.float32),
            np.ones((90, 140), np.float32)]
    out = bucket_images(imgs, buckets=[(120, 160), (240, 320)])
    assert set(out.keys()) == {(120, 160), (240, 320)}
    arr, idxs, shapes = out[(120, 160)]
    assert arr.shape == (2, 120, 160)
    assert sorted(idxs) == [0, 2]
    arr2, idxs2, _ = out[(240, 320)]
    assert idxs2 == [1]
