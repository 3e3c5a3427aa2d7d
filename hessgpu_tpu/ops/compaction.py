"""Stream compaction with static shapes.

Replacement for the reference's atomic list generation
(GFL_*/ListGen_Kernel, ProgramCU.cu:922-1217): a dense boolean keypoint map
is compacted into a fixed-capacity list of coordinates. Where CUDA uses warp
ballots + atomicAdd (nondeterministic block order), we use sorted-key
selection - deterministic raster order, identical membership.

Capacity policy mirrors the reference: per-level cap
min(0.5% of pixels, 4096) (PyramidCU.cpp:443-451, GlobalUtil.cpp:67-68);
overflowing keypoints are dropped in raster order (the reference drops by
atomic arrival order instead - membership may differ only when a level
overflows its cap).

Design notes:
  * lax.top_k lowers to a stable TWO-operand sort (keys + iota payload);
    since our keys already encode the position, a single-operand unstable
    lax.sort moves half the data for the same selection;
  * the payload pickup packs {dx, dy} and {response, ds} into one int32
    each (s16 fixed point / f16 bits) and rides ftype in the sort key's
    low bits - two gathers + free type bits instead of five gathers.
    Valid keypoints guarantee |dx|,|dy|,|ds| < 1 (ops/keypoint.py offset
    test) and the response is already fp16-quantized (ProgramCU.cu:865
    parity), so the f16 response bits are lossless and the s16 offsets
    keep ~6e-5 px.
  * A prefix-sum/scatter compaction (the reference's design) has not been
    timed against these sorts on the GPU yet.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

# Per-row candidate floor for the dense two-stage compaction below (the
# effective cap scales with width, _row_cap). 32 is far above observed
# densities at bench widths (the reference's own saddle-flood demo,
# checkerboard.png at -t 0.000001, peaks at 10 detections in a row), and
# the stage-2 raster sort's size is proportional to it.
_ROW_CAP = 32


def _row_cap(w: int) -> int:
    """Per-row candidate cap for a w-wide level: max(32, w/32), <= 256.

    The 3x3 NMS admits up to w/2 survivors per row, so a fixed cap can
    truncate where the reference (per-level area cap only,
    PyramidCU.cpp:443-451) would not. Scaling with width bounds the
    divergence: truncation requires ONE row of ONE level to sustain more
    than 1 NMS survivor per 32 px across its whole extent while the level
    is still under its 0.5%-of-pixels cap - e.g. >64 survivors in a
    single 2048-px row. tests/test_compaction.py pins membership parity
    vs the uncapped scatter path on a synthetic saddle flood whose rows
    exceed the old fixed cap of 32."""
    return max(_ROW_CAP, min(256, w // 32))

_Q = 16384.0   # s16 fixed-point scale for subpixel offsets in (-1, 1)


class FeatureList(NamedTuple):
    """Fixed-capacity SoA keypoint list for one level (or a concatenation).

    Replaces the reference's packed float4 feature textures
    (ProgramCU.cu:1562-1604) with plain arrays.
    """
    x: jnp.ndarray         # f32 (K,) column + 0.5 + dx (level pixel coords)
    y: jnp.ndarray         # f32 (K,) row + 0.5 + dy
    sigma: jnp.ndarray     # f32 (K,) scale in level coords
    theta: jnp.ndarray     # f32 (K,) orientation (device frame, radians)
    response: jnp.ndarray  # f32 (K,)
    ftype: jnp.ndarray     # i32 (K,)
    valid: jnp.ndarray     # bool (K,)

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)


def _first_k_ascending(keys: jnp.ndarray, k: int) -> jnp.ndarray:
    """Smallest k keys of the last axis, ascending (single-operand sort)."""
    return jax.lax.sort(keys, dimension=keys.ndim - 1,
                        is_stable=False)[..., :k]


def _q14(a: jnp.ndarray) -> jnp.ndarray:
    """f32 in (-2, 2) -> s16 fixed-point bits, in an i32."""
    return jnp.round(a * _Q).astype(jnp.int32)


def _unq14_low(p: jnp.ndarray) -> jnp.ndarray:
    """Sign-extended low 16 bits of i32 -> f32."""
    return ((p << 16) >> 16).astype(jnp.float32) / _Q


def _pack_payload(maps) -> tuple:
    """KeypointMaps -> two i32 planes: (dx|dy), (f16(response)|ds)."""
    p1 = (_q14(maps.dx) << 16) | (_q14(maps.dy) & 0xFFFF)
    rbits = jax.lax.bitcast_convert_type(
        maps.response.astype(jnp.float16), jnp.uint16).astype(jnp.int32)
    p2 = (rbits << 16) | (_q14(maps.ds) & 0xFFFF)
    return p1, p2


def _unpack_payload(g1: jnp.ndarray, g2: jnp.ndarray):
    """Inverse of _pack_payload on gathered slots -> (dx, dy, resp, ds)."""
    dx = (g1 >> 16).astype(jnp.float32) / _Q
    dy = _unq14_low(g1)
    resp = jax.lax.bitcast_convert_type(
        ((g2 >> 16) & 0xFFFF).astype(jnp.uint16), jnp.float16
    ).astype(jnp.float32)
    ds = _unq14_low(g2)
    return dx, dy, resp, ds


def compact_mask(valid: jnp.ndarray, values: Sequence[jnp.ndarray], capacity: int):
    """Compact elements where valid into fixed-size arrays (raster order).

    valid: bool (...,) mask, flattened internally.
    values: arrays shaped like valid, gathered alongside.
    Returns (count, [compacted values...], compacted_valid) where each output
    has shape (capacity,).

    This is the readable reference twin: production paths use
    compact_sorted (payloads ride one variadic sort instead of per-field
    gathers), and tests/test_compaction.py pins the two equivalent.
    """
    src, slot_valid, count = compact_indices(valid, capacity)
    outs = [val.reshape(-1)[src] for val in values]
    outs = [jnp.where(slot_valid, o, jnp.zeros_like(o)) for o in outs]
    return count, outs, slot_valid


def compact_sorted(valid: jnp.ndarray, values: Sequence[jnp.ndarray],
                   capacity: int):
    """compact_mask twin that rides payloads through ONE variadic sort.

    For small tables (a few thousand slots) the payload operands move
    through the sorting network instead of one gather per field;
    selection is identical: keys = flat index where valid else n,
    ascending.

    Equal (invalid) keys may permute arbitrarily among themselves, so
    every output is masked to zero past `count` - same contract as
    compact_mask. Supports a leading batch dim on valid/values (the sort
    runs along the last axis).

    Returns (count, [compacted values...], slot_valid).
    """
    n = valid.shape[-1]
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), valid.shape)
    keys = jnp.where(valid, idx, n)
    outs = jax.lax.sort((keys,) + tuple(values), num_keys=1,
                        dimension=valid.ndim - 1, is_stable=False)
    k = min(capacity, n)
    sel = outs[0][..., :k] < n
    count = jnp.minimum(jnp.sum(valid.astype(jnp.int32), axis=-1), capacity)
    res = []
    for o in outs[1:]:
        o = jnp.where(sel, o[..., :k], jnp.zeros_like(o[..., :k]))
        if k < capacity:
            o = jnp.pad(o, ((0, 0),) * (o.ndim - 1) + ((0, capacity - k),))
        res.append(o)
    slot_valid = jnp.arange(capacity) < count[..., None] \
        if valid.ndim > 1 else jnp.arange(capacity) < count
    return count, res, slot_valid


def compact_indices(valid: jnp.ndarray, capacity: int):
    """First-`capacity` valid flat indices, in index order.

    One single-operand ascending lax.sort over keys = flat index where
    valid else n (so the smallest k = leftmost valid); lax.top_k would
    lower to a two-operand stable sort.

    Returns (src (capacity,) i32 indices into the flattened input,
    slot_valid (capacity,) bool, count)."""
    vflat = valid.reshape(-1)
    n = vflat.shape[0]
    keys = jnp.where(vflat, jnp.arange(n, dtype=jnp.int32), n)
    k = min(capacity, n)
    top = _first_k_ascending(keys, k)
    src = jnp.where(top < n, top, 0)
    if k < capacity:
        src = jnp.pad(src, (0, capacity - k))
    count = jnp.minimum(jnp.sum(vflat.astype(jnp.int32)), capacity)
    slot_valid = jnp.arange(capacity) < count
    return src, slot_valid, count


def compact_octave_keypoints(maps, sigmas, sigma_step: float,
                             capacity: int) -> FeatureList:
    """Dense KeypointMaps for ALL key levels of one octave -> one blocked
    FeatureList with (NK, capacity) leaves (row k = key level k).

    Same per-level result as compact_level_keypoints, but everything
    batches over the level dimension - one sort / gather / where call on
    (NK, ...) operands instead of NK each.

    Two-stage selection (both single-operand ascending sorts):
      1. per row, the leftmost _ROW_CAP valid columns - key = col<<2|ftype
         where valid else sentinel (the 2 type bits ride for free);
      2. over the (H * _ROW_CAP) candidates, the first `capacity` in
         raster order - key = (row*W+col)<<2|ftype.
    Membership equals the scatter path exactly unless a single row holds
    > _ROW_CAP detections (then overflow drops right-of-row instead of
    end-of-raster - both beyond the reference's 0.5%-of-pixels saturation).
    """
    if isinstance(maps, list):
        # legacy per-level list -> stacked leaves (KeypointMaps itself is
        # a NamedTuple, so only a plain list means "per level")
        maps = jax.tree.map(lambda *xs: jnp.stack(xs), *maps)
    valid3 = maps.valid                                  # (NK, H, W)
    nk, h, w = valid3.shape
    n = h * w

    kpr = min(w, _row_cap(w))
    col = jax.lax.broadcasted_iota(jnp.int32, (nk, h, w), 2)
    key1 = jnp.where(valid3, (col << 2) | (maps.ftype & 3), w << 2)
    if (w << 2) < 0xFFFF:
        # row keys fit u16 - halves the full-map sort's data movement
        # (this sort is the largest op in GENERATE_FEATURE_LIST)
        cand = _first_k_ascending(key1.astype(jnp.uint16), kpr) \
            .astype(jnp.int32)
    else:
        cand = _first_k_ascending(key1, kpr)             # (NK, H, kpr)
    cand_valid = cand < (w << 2)
    row = jax.lax.broadcasted_iota(jnp.int32, (nk, h, kpr), 1)
    # global key: (row*w + col)<<2 | ftype; invalid -> n<<2 sentinel
    key2 = jnp.where(cand_valid, ((row * w) << 2) + cand, n << 2)

    p1, p2 = _pack_payload(maps)
    return _finish_octave_compact(key2, cand_valid, p1, p2, sigmas,
                                  sigma_step, w, n, capacity)


def _finish_octave_compact(key2, cand_valid, p1, p2, sigmas,
                           sigma_step: float, w: int, n: int,
                           capacity: int) -> FeatureList:
    """Shared stage-2 selection + payload pickup: global raster sort of
    the per-row candidates, gather of the packed payload planes, unpack
    to the FeatureList fields."""
    nk = key2.shape[0]
    h_kpr = key2.shape[1] * key2.shape[2]
    k2 = min(capacity, h_kpr)
    sel = _first_k_ascending(key2.reshape(nk, -1), k2)   # (NK, k2)
    sv2 = sel < (n << 2)
    src = jnp.where(sv2, sel >> 2, 0)
    t = jnp.where(sv2, sel & 3, 0)
    if k2 < capacity:
        src = jnp.pad(src, ((0, 0), (0, capacity - k2)))
        t = jnp.pad(t, ((0, 0), (0, capacity - k2)))
    count = jnp.minimum(
        jnp.sum(cand_valid.astype(jnp.int32), axis=(1, 2)), capacity)
    sv = jnp.arange(capacity)[None, :] < count[:, None]  # (NK, cap)

    take = lambda a: jnp.take_along_axis(a.reshape(nk, -1), src, axis=1)
    dx, dy, r, ds = _unpack_payload(take(p1), take(p2))
    x = (src % w).astype(jnp.float32) + 0.5 + dx
    y = (src // w).astype(jnp.float32) + 0.5 + dy
    sig = jnp.asarray(sigmas, jnp.float32)[:, None] \
        * jnp.power(sigma_step, ds)
    return FeatureList(
        x=jnp.where(sv, x, 0.0), y=jnp.where(sv, y, 0.0),
        sigma=jnp.where(sv, sig, 0.0),
        theta=jnp.zeros((nk, capacity), jnp.float32),
        response=jnp.where(sv, r, 0.0),
        ftype=jnp.where(sv, t, jnp.zeros_like(t)),
        valid=sv,
    )


def compact_level_keypoints(maps, sigma: float, sigma_step: float, capacity: int) -> FeatureList:
    """Dense KeypointMaps -> fixed-capacity FeatureList for one level.

    Coordinates follow the reference convention: x = col + 0.5 + dx
    (ComputeOrientation_Kernel, ProgramCU.cu:1281-1298), scale =
    level_sigma * sigma_step**ds. Thin wrapper over the blocked octave
    compaction so membership AND payload quantization are identical
    everywhere (parallel/spatial.py merges per-shard lists from here
    against pipeline lists from compact_octave_keypoints).
    """
    stacked = jax.tree.map(lambda a: a[None], maps)
    fl = compact_octave_keypoints(stacked, [sigma], sigma_step, capacity)
    return jax.tree.map(lambda a: a[0], fl)
