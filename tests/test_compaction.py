"""Stream compaction and top-K selection."""

import numpy as np
import jax.numpy as jnp

from hessgpu_tpu.ops.compaction import FeatureList, compact_mask
from hessgpu_tpu.pyramid import GlobalTable, _recompact, _topk_mask


def test_compact_preserves_raster_order(rng):
    mask = rng.rand(16, 20) < 0.1
    vals = np.arange(320, dtype=np.float32).reshape(16, 20)
    count, (out,), slot_valid = compact_mask(
        jnp.asarray(mask), [jnp.asarray(vals)], capacity=64)
    n = int(count)
    assert n == mask.sum()
    want = vals[mask]  # raster order
    np.testing.assert_array_equal(np.asarray(out)[:n], want)
    assert np.asarray(slot_valid).sum() == n


def test_compact_overflow_drops_tail():
    mask = np.ones((4, 4), bool)
    vals = np.arange(16, dtype=np.float32).reshape(4, 4)
    count, (out,), slot_valid = compact_mask(
        jnp.asarray(mask), [jnp.asarray(vals)], capacity=8)
    assert int(count) == 8
    np.testing.assert_array_equal(np.asarray(out), np.arange(8))


def _make_table(responses, levels, cap=None):
    """GlobalTable with given responses/level ids (valid prefix)."""
    n = len(responses)
    cap = cap or n
    r = np.zeros(cap, np.float32)
    r[:n] = responses
    lid = np.zeros(cap, np.int32)
    lid[:n] = levels
    v = np.zeros(cap, bool)
    v[:n] = True
    z = jnp.zeros(cap, jnp.float32)
    return GlobalTable(
        x=jnp.arange(cap, dtype=jnp.float32), y=z,
        sigma=jnp.ones(cap, jnp.float32), theta=z,
        response=jnp.asarray(r), ftype=jnp.zeros(cap, jnp.int32),
        level_id=jnp.asarray(lid), valid=jnp.asarray(v))


def test_topk_selects_largest_abs_response():
    t = _make_table([0.5, -0.9, 0.1, 0.3, 0.7, 0.2, -0.6],
                    [0, 0, 0, 0, 1, 1, 1], cap=16)
    out = _recompact(t, _topk_mask(t, 3), 16)
    # global top-3 by |response|: -0.9 (lvl 0), 0.7 and -0.6 (lvl 1)
    assert int(out.count()) == 3
    # order preserved (level-major, original within-level order)
    assert np.asarray(out.x)[:3].tolist() == [1.0, 4.0, 6.0]
    assert float(out.response[0]) == np.float32(-0.9)


def test_topk_tie_break_by_order():
    t = _make_table([0.5, 0.5, 0.5, 0.5], [0, 0, 0, 0], cap=8)
    out = _recompact(t, _topk_mask(t, 2), 8)
    assert int(out.count()) == 2
    # first two in global order survive
    assert np.asarray(out.x)[:2].tolist() == [0.0, 1.0]


def test_topk_k_larger_than_count():
    t = _make_table([0.5, 0.4], [0, 0], cap=8)
    out = _recompact(t, _topk_mask(t, 100), 8)
    assert int(out.count()) == 2


def test_compact_sorted_equals_compact_mask(rng):
    """compact_sorted is the production path; compact_mask is the readable
    oracle - pin them equivalent (flat and batched, under/overflow)."""
    from hessgpu_tpu.ops.compaction import compact_sorted

    for cap in (8, 64, 500):
        mask = rng.rand(400) < 0.15
        vals = np.arange(400, dtype=np.float32) * 0.5
        lvls = (np.arange(400) % 7).astype(np.int32)
        cm = compact_mask(jnp.asarray(mask),
                          [jnp.asarray(vals), jnp.asarray(lvls)], cap)
        cs = compact_sorted(jnp.asarray(mask),
                            [jnp.asarray(vals), jnp.asarray(lvls)], cap)
        assert int(cm[0]) == int(cs[0])
        for a, b in zip(cm[1], cs[1]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(cm[2]), np.asarray(cs[2]))

    # batched: compact_sorted vectorizes over the leading dim
    maskb = rng.rand(3, 128) < 0.2
    valsb = rng.rand(3, 128).astype(np.float32)
    csb = compact_sorted(jnp.asarray(maskb), [jnp.asarray(valsb)], 32)
    for b in range(3):
        cm = compact_mask(jnp.asarray(maskb[b]), [jnp.asarray(valsb[b])], 32)
        assert int(cm[0]) == int(csb[0][b])
        np.testing.assert_array_equal(np.asarray(cm[1][0]),
                                      np.asarray(csb[1][0][b]))


def test_row_cap_scales_with_width_dense_flood():
    """Saddle-flood parity (VERDICT r4 #8): a 2048-wide row holding more
    detections than the old fixed per-row cap of 32 must compact with
    membership identical to the uncapped raster-order reference policy
    (the reference only drops at the per-level area cap,
    PyramidCU.cpp:443-451). 51 valid columns per flooded row exercises
    the width-scaled cap (_row_cap(2048) = 64 > 51 > 32)."""
    from hessgpu_tpu.ops.compaction import _row_cap, compact_octave_keypoints
    from hessgpu_tpu.ops.keypoint import KeypointMaps

    assert _row_cap(640) == 32 and _row_cap(2048) == 64

    h, w = 64, 2048
    valid = np.zeros((1, h, w), bool)
    valid[0, 2:h - 2:4, 2:w - 2:40] = True       # 51 per flooded row
    per_row = valid[0].sum(axis=1).max()
    assert per_row > 32, per_row                 # exceeds the old cap
    rng = np.random.RandomState(7)
    maps = KeypointMaps(
        valid=jnp.asarray(valid),
        response=jnp.asarray(rng.randn(1, h, w).astype(np.float16)
                             .astype(np.float32)),
        dx=jnp.zeros((1, h, w), jnp.float32),   # zero offsets so
        dy=jnp.zeros((1, h, w), jnp.float32),   # floor(x), floor(y)
        ds=jnp.zeros((1, h, w), jnp.float32),   # recover (row, col)
        ftype=jnp.asarray(rng.randint(0, 3, (1, h, w)), jnp.int32),
    )
    cap = 1024
    assert valid.sum() <= cap                    # under the area cap
    fl = compact_octave_keypoints(maps, [1.6], 1.26, cap)
    n = int(np.asarray(fl.count())[0])
    assert n == valid.sum()
    rows, cols = np.nonzero(valid[0])            # raster order
    np.testing.assert_array_equal(
        np.floor(np.asarray(fl.y[0][:n])).astype(int), rows)
    np.testing.assert_array_equal(
        np.floor(np.asarray(fl.x[0][:n])).astype(int), cols)

