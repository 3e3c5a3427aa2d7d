"""Spatially sharded filtering: images split across devices with halo
exchange.

The reference caps its working dimension at 3200 px and downsamples anything
larger (GlobalUtil.cpp:82, PyramidCU.cpp:153-191). The answer here to
"image larger than one device" is row-sharding the image across the mesh
and exchanging convolution halos with ppermute - structurally the same
communication pattern as ring attention (SURVEY.md section 5.7).

The stencil math is identical to the single-device ops so results match
bit-for-bit up to edge handling.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import gaussian_taps


def _exchange_halo(block: jnp.ndarray, halo: int, axis_name: str):
    """Fetch `halo` edge rows from both ring neighbours.

    block: (Hs, W) this device's row shard. Returns (top_halo, bot_halo)
    each (halo, W): rows that belong logically above/below this shard.
    Edge devices receive the wrapped-around rows but replace them with edge
    replication (matching the single-chip clamp-to-edge semantics).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)

    # my bottom rows -> next device's top halo
    down = [(i, (i + 1) % n) for i in range(n)]
    up = [(i, (i - 1) % n) for i in range(n)]

    top_halo = jax.lax.ppermute(block[-halo:], axis_name, down)
    bot_halo = jax.lax.ppermute(block[:halo], axis_name, up)

    # clamp-to-edge at the global borders
    first_rep = jnp.repeat(block[:1], halo, axis=0)
    last_rep = jnp.repeat(block[-1:], halo, axis=0)
    top_halo = jnp.where(idx == 0, first_rep, top_halo)
    bot_halo = jnp.where(idx == n - 1, last_rep, bot_halo)
    return top_halo, bot_halo


def _blur_block(block, taps, axis_name):
    """Separable blur of a row shard with halo exchange for the vertical
    pass (the horizontal pass is shard-local).

    Both passes run through the same XLA convolution as the single-chip
    path (ops.gaussian.conv1d_clamped / conv1d_valid), so each output
    element is the identical reduction and results match the single-chip
    pipeline bit-for-bit."""
    from ..ops.gaussian import conv1d_clamped, conv1d_valid

    r = len(taps) // 2
    # horizontal: local, clamp-to-edge
    out = conv1d_clamped(block, taps, axis=1)
    # vertical: halo rows replace the edge padding, then a valid conv
    top, bot = _exchange_halo(out, r, axis_name)
    return conv1d_valid(jnp.concatenate([top, out, bot], axis=0), taps,
                        axis=0)


def sharded_blur(img: jnp.ndarray, sigma: float, mesh: Mesh,
                 filter_width_factor: float = 4.0) -> jnp.ndarray:
    """Gaussian blur of a row-sharded image over a 1-D mesh.

    img: (H, W) with H divisible by the mesh size.
    """
    taps = gaussian_taps(sigma, filter_width_factor)
    axis = mesh.axis_names[0]

    fn = jax.shard_map(
        functools.partial(_blur_block, taps=tuple(taps), axis_name=axis),
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=P(axis, None),
    )
    sharding = NamedSharding(mesh, P(axis, None))
    return fn(jax.device_put(img, sharding))


def sharded_hessian_response(img: jnp.ndarray, sigmas: Sequence[float],
                             norms: Sequence[float], mesh: Mesh,
                             filter_width_factor: float = 4.0):
    """Row-sharded scale-space responses for one octave of a huge image.

    Builds the Gaussian chain and the det-of-Hessian response with all
    stencils exchanging 1-row halos. Returns (levels+1, H, W) gauss stack
    and (levels+1, H, W) responses, sharded over rows.
    """
    axis = mesh.axis_names[0]
    taps_list = tuple(tuple(gaussian_taps(s, filter_width_factor))
                      for s in sigmas)

    def block_fn(block):
        levels = [block]
        for taps in taps_list:
            levels.append(_blur_block(levels[-1], taps, axis))
        stack = jnp.stack(levels)

        # 3x3 stencil with a 1-row halo, exchanged per level
        resps = []
        for li in range(stack.shape[0]):
            lv = stack[li]
            t, b = _exchange_halo(lv, 1, axis)
            ext = jnp.concatenate([t, lv, b], axis=0)
            xp = jnp.pad(ext, ((0, 0), (1, 1)), mode="edge")
            c = xp[1:-1, 1:-1]
            lxx = xp[1:-1, :-2] - 2 * c + xp[1:-1, 2:]
            lyy = xp[:-2, 1:-1] - 2 * c + xp[2:, 1:-1]
            lxy = 0.25 * (xp[:-2, :-2] + xp[2:, 2:] - xp[2:, :-2] - xp[:-2, 2:])
            resps.append((lxx * lyy - lxy * lxy) * norms[li])
        return stack, jnp.stack(resps)

    fn = jax.shard_map(block_fn, mesh=mesh,
                       in_specs=P(axis, None),
                       out_specs=(P(None, axis, None), P(None, axis, None)))
    sharding = NamedSharding(mesh, P(axis, None))
    return fn(jax.device_put(img, sharding))


# ---------------------------------------------------------------------------
# end-to-end sharded detection
# ---------------------------------------------------------------------------

def _orient_describe_level(fl, gbuf, rbuf, win_fn, cfg, w_o, ho, grow0,
                           oss, owin, dwin, single, MO, type_none):
    """Shard-local orientations + descriptors for one key level's
    compacted keypoint list.

    Runs the single-chip jnp helpers (_histogram36 / _descriptor_one) in
    GLOBAL octave coordinates over the shard's band+halo buffers, so
    thetas/descriptors match the single-chip pipeline bit-for-bit (see
    sharded_detect_and_describe)."""
    from ..ops.descriptor import _descriptor_one, normalize_descriptors
    from ..ops.orientation import (_histogram36, _multi_peaks,
                                   _single_peak, _smooth6)

    TWO_PI = 2.0 * np.pi
    ky_g = fl.y + grow0
    kx_g = fl.x

    if cfg.fixed_orientation:
        thetas = jnp.zeros((fl.x.shape[0], MO))
        tvalid = jnp.zeros((fl.x.shape[0], MO), bool).at[:, 0].set(True)
    else:
        def orient_one(kx, ky, ks):
            gwin, y0, x0 = win_fn(gbuf, ky, kx, owin)
            rwin, _, _ = win_fn(rbuf, ky, kx, owin)
            votes = _histogram36(
                kx, ky, ks, gwin, rwin,
                x0.astype(jnp.float32), y0.astype(jnp.float32),
                owin, float(w_o), float(ho),
                cfg.orientation_gaussian_factor,
                cfg.orientation_window_factor)
            votes = _smooth6(votes)
            if cfg.half_sift:
                votes = votes.at[:18].add(votes[18:]).at[18:].set(0.0)
            if single:
                return (jnp.stack([_single_peak(votes)]),
                        jnp.array([True]))
            return _multi_peaks(votes, cfg.multi_orientation_threshold,
                                min(4, cfg.max_orientations))

        thetas, tvalid = jax.vmap(orient_one)(kx_g, ky_g, fl.sigma)

    vslot = (fl.valid[:, None] & tvalid).reshape(-1)
    rep = lambda a: jnp.repeat(a, MO)
    th_flat = thetas.reshape(-1)

    if cfg.compute_descriptors:
        def desc_one(kx, ky, ks, kt):
            gwin, y0, x0 = win_fn(gbuf, ky, kx, dwin)
            rwin, _, _ = win_fn(rbuf, ky, kx, dwin)
            return _descriptor_one(
                kx, ky, ks, kt, gwin, rwin,
                x0.astype(jnp.float32), y0.astype(jnp.float32),
                float(w_o), float(ho), cfg.descriptor_window_factor)

        K = vslot.shape[0]
        chunk = 128
        if K <= chunk:
            desc = jax.vmap(desc_one)(rep(kx_g), rep(ky_g),
                                      rep(fl.sigma), th_flat)
        else:
            padn = (-K) % chunk
            args = [jnp.pad(a, (0, padn)).reshape(-1, chunk)
                    for a in (rep(kx_g), rep(ky_g), rep(fl.sigma),
                              th_flat)]
            desc = jax.lax.map(lambda t: jax.vmap(desc_one)(*t),
                               tuple(args)).reshape(-1, 128)[:K]
        desc = jnp.where(vslot[:, None], desc, 0.0)
        if cfg.half_sift:
            d = desc.reshape(-1, 16, 8)
            desc = (d[..., :4] + d[..., 4:]).reshape(-1, 64)
        if cfg.normalized_sift:
            desc = normalize_descriptors(desc, vslot)
    else:
        desc = jnp.zeros((vslot.shape[0],
                          64 if cfg.half_sift else 128), jnp.float32)

    return dict(
        x=jnp.where(vslot, oss * (rep(kx_g) - 0.5) + 0.5, 0.0),
        y=jnp.where(vslot, oss * (rep(ky_g) - 0.5) + 0.5, 0.0),
        sigma=jnp.where(vslot, oss * rep(fl.sigma), 0.0),
        theta=jnp.where(vslot, jnp.mod(TWO_PI - th_flat, TWO_PI), 0.0),
        response=jnp.where(vslot, rep(fl.response), 0.0),
        ftype=jnp.where(vslot, rep(fl.ftype), type_none),
        valid=vslot,
        desc=desc)

def sharded_detect_keypoints(img: jnp.ndarray, cfg, mesh: Mesh):
    """Full multi-octave keypoint detection on a row-sharded image."""
    return _sharded_detect_impl(img, cfg, mesh, describe=False)


def _global_keep(fls, cfg, axis_name: str, G: int):
    """Cross-shard global-cap + truncation mask for the sharded pipeline.

    Mirrors the single-chip pyramid stages exactly: the globalize cap
    (first G valid slots in level-major raster order), then
    LimitFeatureCount (-topk / -tc1 / -tc2, SiftPyramid.cpp:201-278 via
    pyramid._topk_mask / _level_trunc_mask). The per-shard (level, slot)
    tables are all_gathered - they are a few KB - so every shard computes
    the identical global mask and slices out its own block.

    fls: per-global-level FeatureLists (local shard, cap slots each).
    Returns (L, cap) bool: this shard's keep mask.
    """
    from ..config import (TRUNCATE_KEEP_HIGHEST_LEVELS,
                          TRUNCATE_KEEP_LOWEST_LEVELS, TRUNCATE_TOP_K)

    L = len(fls)
    cap = fls[0].valid.shape[0]
    n = jax.lax.axis_size(axis_name)
    shard = jax.lax.axis_index(axis_name)
    lv = jnp.stack([fl.valid for fl in fls])                 # (L, cap)
    la = jnp.stack([jnp.abs(fl.response) for fl in fls])
    av = jax.lax.all_gather(lv, axis_name)                   # (n, L, cap)
    aa = jax.lax.all_gather(la, axis_name)
    # (n, L, cap) -> level-major, shard-major, slot-major = the global
    # raster order within each level (shard s covers rows [s*hloc, ...))
    av = jnp.transpose(av, (1, 0, 2)).reshape(-1)
    aa = jnp.transpose(aa, (1, 0, 2)).reshape(-1)

    rank = jnp.cumsum(av.astype(jnp.int32)) - 1
    keep = av & (rank < G)

    k = cfg.feature_count_threshold
    if k > 0:
        if cfg.truncate_method == TRUNCATE_TOP_K:
            absr = jnp.where(keep, aa, -jnp.inf)
            kk = min(k, absr.shape[0])
            vk = jax.lax.top_k(absr, kk)[0][-1]
            above = absr > vk
            n_above = jnp.sum(above.astype(jnp.int32))
            ties = absr == vk
            tie_rank = jnp.cumsum(ties.astype(jnp.int32))
            keep &= above | (ties & (tie_rank <= (kk - n_above)))
        elif cfg.truncate_method in (TRUNCATE_KEEP_LOWEST_LEVELS,
                                     TRUNCATE_KEEP_HIGHEST_LEVELS):
            counts = jnp.sum(keep.reshape(L, -1).astype(jnp.int32), axis=1)
            if cfg.truncate_method == TRUNCATE_KEEP_LOWEST_LEVELS:
                cum = jnp.cumsum(counts)
                keep_level = (cum - counts) < k
            else:
                total = jnp.sum(counts)
                suffix = total - (jnp.cumsum(counts) - counts)
                keepable = suffix <= k
                first_keep = jnp.argmax(keepable)
                first_keep = jnp.where(jnp.any(keepable), first_keep, L - 1)
                keep_level = jnp.arange(L) >= first_keep
            keep &= jnp.repeat(keep_level, n * cap)

    keep3 = keep.reshape(L, n, cap)
    return jax.lax.dynamic_index_in_dim(keep3, shard, axis=1,
                                        keepdims=False)


def sharded_detect_and_describe(img: jnp.ndarray, cfg, mesh: Mesh):
    """Full detect+describe on a row-sharded image: the complete
    replacement for the reference's -maxd ceiling (GlobalUtil.cpp:82).

    Orientation/descriptor windows read a band+halo gradient buffer: each
    shard computes its band's gradient/rotation maps (1-row halo), then
    exchanges `pad` halo rows with its ring neighbours via ppermute - the
    same pattern as the blur halos - so every keypoint's full window is
    shard-local. Window gathers, histogram masks, and descriptor math are
    performed in GLOBAL octave coordinates, so thetas and descriptors
    match the single-chip pipeline bit-for-bit.

    Full single-chip API parity: the global feature cap and the
    -topk/-tc1/-tc2 truncation modes apply ACROSS shards before the
    orientation/descriptor work (all_gather of the per-shard response
    heads + the same mask math as pyramid._topk_mask, see _global_keep),
    and the result is a FeatureTable exactly like detect_and_describe's
    (capacity G in single-orientation mode, G * expansion_factor after
    multi-orientation expansion). Membership can differ from the
    single-chip run only when one shard's per-level cap overflows
    (cap/n + 8 slots per shard vs cap globally).

    Octaves whose shard band is shorter than the halo are computed
    replicated (shard 0 reports), like small octaves in
    sharded_detect_keypoints.
    """
    res, G = _sharded_detect_impl(img, cfg, mesh, describe=True)
    single = cfg.max_orientations <= 1 or cfg.fixed_orientation
    G_out = G if single else \
        int(G * cfg.expansion_factor + 7) // 8 * 8
    return _assemble_feature_table(res, G_out)


@functools.partial(jax.jit, static_argnums=(1,))
def _assemble_feature_table(res: dict, G: int):
    """Compact the sharded per-level slot dict into one FeatureTable.

    res leaves are (L_total, n * cap * MO) in level-major, shard-major,
    keypoint-major, orientation-slot order - the same relative order as
    the single-chip global table after multi-orientation expansion, so
    the compacted table matches detect_and_describe's row for row (when
    no per-shard cap overflows). G: output capacity (the pipeline's G in
    single-orientation mode, G * expansion_factor after expansion).
    """
    from ..features import FeatureTable
    from ..ops.compaction import compact_indices

    L, S = res["valid"].shape
    G = min(G, L * S)

    valid = res["valid"].reshape(-1)
    src, slot_valid, _cnt = compact_indices(valid, G)
    lid = jnp.repeat(jnp.arange(L, dtype=jnp.int32), S)

    def take(a, fill=0):
        g = a.reshape(-1)[src]
        return jnp.where(slot_valid, g, jnp.asarray(fill, g.dtype))

    desc = res["desc"].reshape(L * S, -1)[src]
    desc = jnp.where(slot_valid[:, None], desc, 0.0)
    return FeatureTable(
        x=take(res["x"]), y=take(res["y"]), sigma=take(res["sigma"]),
        theta=take(res["theta"]), response=take(res["response"]),
        level=jnp.where(slot_valid, lid[src], 0),
        ftype=take(res["ftype"]), valid=slot_valid, desc=desc)


def _sharded_detect_impl(img: jnp.ndarray, cfg, mesh: Mesh,
                         describe: bool):
    """Cached-dispatch wrapper: the compiled shard_map program is built
    once per (shape, config, mesh, mode) by _build_sharded_fn and reused
    - building jit(shard_map(...)) per call recompiled the whole sharded
    pipeline EVERY invocation."""
    from ..pyramid import _CfgKey

    axis = mesh.axis_names[0]
    fn, G = _build_sharded_fn(img.shape, _CfgKey(cfg), mesh, describe)
    sharding = NamedSharding(mesh, P(axis, None))
    res = fn(jax.device_put(img, sharding))
    return (res, G) if describe else res


@functools.lru_cache(maxsize=32)
def _build_sharded_fn(HW, ckey, mesh: Mesh, describe: bool):
    """Full multi-octave keypoint detection on a row-sharded image.

    Replaces the reference's hard -maxd working-size ceiling
    (GlobalUtil.cpp:82): an image too tall for one chip is split into row
    bands across the mesh; blurs and the 3x3x3 NMS stencil exchange 1-row
    halos with ppermute, each shard compacts its own detections
    (scatter-free), and coordinates are reported in the global image frame.
    Detection membership, subpixel refinement, response, sigma, and type
    match the single-chip pipeline at ULP level (blurs and stencils reuse
    the same XLA reductions; see _blur_block).

    Octaves stay row-sharded while each shard's band is at least
    MIN_SHARD_ROWS tall (the halo exchange reaches only ring neighbours,
    so the band must cover the widest blur radius); smaller octaves are
    all-gathered and computed replicated - they are a vanishing fraction
    of the work, and this removes any constraint tying the image height
    to the octave count.

    img: (H, W) f32 with H divisible by mesh.size.
    Returns a dict of (L_total, n_shards * cap) arrays:
    x, y, sigma, response, ftype (i32), valid (bool) - level-major like
    the single-chip path; within a level, shard-major raster order
    (replicated octaves report on shard 0).
    """
    import math as _math

    cfg = ckey.cfg
    from ..ops.compaction import compact_level_keypoints
    from ..ops.keypoint import TYPE_NONE, detect_keypoints_level
    from ..ops.resize import downsample
    from ..params import (max_features_per_level, octave_shapes,
                          required_octaves)

    p = cfg.scale_params()
    axis = mesh.axis_names[0]
    n = mesh.size
    H, W = HW

    noct = required_octaves(min(H, W), cfg.min_dim)
    if cfg.num_octaves > 0:
        noct = min(noct, cfg.num_octaves)
    shapes = octave_shapes(H, W, noct)
    # widest filter is 33 taps (params.gaussian_taps clamp) -> radius 16;
    # a sharded band must cover it, and its rows must stay even for the
    # next local downsample
    MIN_SHARD_ROWS = 32
    owin = dwin = halo = 0
    single = True
    MO = 1
    if describe:
        from ..ops.descriptor import descriptor_window_size
        max_sigma = p.key_level_sigma(p.key_levels[-1]) * \
            (p.sigmak if cfg.subpixel else 1.0)
        owin = 2 * int(_math.ceil(
            abs(max_sigma) * cfg.orientation_gaussian_factor
            * cfg.orientation_window_factor + 1.0)) + 1
        dwin = descriptor_window_size(max_sigma,
                                      cfg.descriptor_window_factor)
        # orientation/descriptor windows must be shard-local: the band
        # must cover the widest window's halo
        halo = (max(owin, dwin) - 1) // 2 + 2
        single = cfg.max_orientations <= 1 or cfg.fixed_orientation
        MO = 1 if single else 4
    min_rows = max(MIN_SHARD_ROWS, halo)
    sharded_oct = []
    for (h, w) in shapes:
        # 2n | h keeps every shard's band even for the local downsample
        ok = (h % (2 * n) == 0) and (h // n >= min_rows) and \
            (not sharded_oct or sharded_oct[-1])
        sharded_oct.append(ok)

    taps_init = tuple(gaussian_taps(p.initial_blur_sigma(0),
                                    p.filter_width_factor)) \
        if p.initial_blur_sigma(0) > 0 else ()
    taps_inc = tuple(tuple(gaussian_taps(s, p.filter_width_factor))
                     for s in p.incremental_sigmas())
    taps_skip = tuple(gaussian_taps(p.octave_restart_sigma(),
                                    p.filter_width_factor)) \
        if p.octave_restart_sigma() > 0 else ()
    norms = tuple((p.level_sigma(l) ** 4)
                  for l in range(p.level_min, p.level_max + 1))
    full_caps = [max_features_per_level(
        h, w, cfg.max_feature_percent, cfg.max_level_features)
        for (h, w) in shapes]
    caps = [max(8, c // n + 8) for c in full_caps]
    cap = max(caps)
    # the single-chip pipeline's global cap (run_pipeline: G =
    # min(global_feature_cap, sum of all per-level caps))
    G = min(cfg.global_feature_cap,
            sum(full_caps) * len(p.key_levels))
    sigma_step = p.sigmak

    def _ext(x):
        t, b = _exchange_halo(x, 1, axis)
        return jnp.concatenate([t, x, b], axis=0)

    def _blur_full(x, taps):
        # replicated small octave: exactly the single-chip separable blur
        from ..ops.gaussian import conv1d_clamped
        x = conv1d_clamped(x, taps, axis=1)
        return conv1d_clamped(x, taps, axis=0)

    def block_fn(block):
        shard = jax.lax.axis_index(axis)
        out = []
        per_level = []
        base = block
        if not sharded_oct[0]:
            base = jax.lax.all_gather(base, axis).reshape(H, W)
        if taps_init:
            base = _blur_block(base, taps_init, axis) if sharded_oct[0] \
                else _blur_full(base, taps_init)
        levels = None
        for o in range(len(shapes)):
            shd = sharded_oct[o]
            blur_o = (lambda x, t: _blur_block(x, t, axis)) if shd \
                else _blur_full
            if o > 0:
                # next octave restarts from the previous octave's level_ds
                # (reference PyramidCU.cpp:1486-1558 via _build_pyramid)
                base = downsample(levels[p.level_ds - p.level_min])
                if sharded_oct[o - 1] and not shd:
                    # sharded -> replicated transition: gather the rows
                    base = jax.lax.all_gather(base, axis) \
                        .reshape(-1, base.shape[1])
                if taps_skip:
                    base = blur_o(base, taps_skip)
            levels = [base]
            for taps in taps_inc:
                levels.append(blur_o(levels[-1], taps))
            hloc = base.shape[0]
            # global octave height (downsample keeps ceil-halved dims,
            # matching the single-chip pipeline, not the floor of shapes)
            ho = hloc * n if shd else hloc

            # det-of-Hessian responses (3x3 stencil; 1-row halo if sharded).
            # The expression tree mirrors ops.hessian.
            # hessian_response_and_gradient term-for-term so float
            # accumulation order (and hence subpixel refinement downstream)
            # matches the single-chip pipeline bit-for-bit.
            resps = []
            for li, lv in enumerate(levels):
                lvx = _ext(lv) if shd else lv
                ext = jnp.pad(lvx, ((0 if shd else 1, 0 if shd else 1),
                                    (1, 1)), mode="edge")
                c = ext[1:-1, 1:-1]
                up, down = ext[:-2, 1:-1], ext[2:, 1:-1]
                left, right = ext[1:-1, :-2], ext[1:-1, 2:]
                tl, tr = ext[:-2, :-2], ext[:-2, 2:]
                bl, br = ext[2:, :-2], ext[2:, 2:]
                lxx = left - 2.0 * c + right
                lyy = up - 2.0 * c + down
                lxy = (tr - tl + bl - br) * 0.25
                resps.append((lxx * lyy - lxy * lxy) * norms[li])

            if shd:
                grow0 = shard * hloc
                row_ok = ((grow0 + jnp.arange(hloc)) > 0) \
                    & ((grow0 + jnp.arange(hloc)) < ho - 1)
            else:
                # replicated: every shard sees the full octave; only
                # shard 0 reports, the others emit empty slots
                grow0 = 0
                row_ok = jnp.broadcast_to(shard == 0, (hloc,))

            w_o = base.shape[1]
            gbufs, rbufs = {}, {}
            if describe:
                # band gradient/rotation per key level (the 1-row stencil
                # halo comes from the ring neighbour, so band rows match
                # the single-chip ops.hessian maps bit-for-bit), extended
                # by `halo` rows each side for shard-local windows
                for kl in p.key_levels:
                    lv = levels[kl]
                    lvx = _ext(lv) if shd else jnp.pad(
                        lv, ((1, 1), (0, 0)), mode="edge")
                    xl = jnp.pad(lvx, ((0, 0), (1, 1)), mode="edge")
                    dxv = xl[1:-1, 2:] - xl[1:-1, :-2]
                    dyv = lvx[2:, :] - lvx[:-2, :]
                    gmag = 0.5 * jnp.sqrt(dxv * dxv + dyv * dyv)
                    grot = jnp.where(gmag == 0.0, 0.0,
                                     jnp.arctan2(dyv, dxv))
                    if shd:
                        tg, bg = _exchange_halo(gmag, halo, axis)
                        tr_, br_ = _exchange_halo(grot, halo, axis)
                        gbufs[kl] = jnp.concatenate([tg, gmag, bg], 0)
                        rbufs[kl] = jnp.concatenate([tr_, grot, br_], 0)
                    else:
                        gbufs[kl] = gmag
                        rbufs[kl] = grot
            # buffer row 0 = global octave row `off`
            off = (grow0 - halo) if shd else 0

            def _win(buf, ky, kx, wsize, ho=ho, w_o=w_o, off=off):
                # mirror ops.gather.window_gather exactly, in GLOBAL
                # octave coordinates: unclamped origin, per-index clamp
                # to the octave extent, reads translated into the local
                # band+halo buffer (ho/w_o/off bound per octave - this
                # closure outlives the loop iteration in describe mode)
                r = (wsize - 1) // 2
                y0 = jnp.floor(ky).astype(jnp.int32) - r
                x0 = jnp.floor(kx).astype(jnp.int32) - r
                ys = jnp.clip(y0 + jnp.arange(wsize).reshape(-1, 1),
                              0, ho - 1) - off
                xs = jnp.clip(x0 + jnp.arange(wsize).reshape(1, -1),
                              0, w_o - 1)
                return buf[ys, xs], y0, x0

            for kl in p.key_levels:
                args_ext = [(_ext(a) if shd else jnp.pad(
                    a, ((1, 1), (0, 0)), mode="edge"))
                    for a in (resps[kl - 1], resps[kl], resps[kl + 1],
                              levels[kl])]
                maps = detect_keypoints_level(
                    *args_ext,
                    threshold=p.threshold,
                    edge_threshold=p.edge_threshold,
                    subpixel=cfg.subpixel,
                    hessian=(cfg.detector == "hessian"),
                    darkness_adaption=cfg.darkness_adaption)
                valid = maps.valid[1:-1] & row_ok[:, None]
                if not shd:
                    # un-padded border rows must keep the single-chip
                    # interior rule (rows 0 and ho-1 excluded)
                    edge = jnp.zeros((hloc,), bool).at[0].set(True) \
                        .at[hloc - 1].set(True)
                    valid &= ~edge[:, None]
                maps = maps._replace(
                    valid=valid,
                    response=jnp.where(valid, maps.response[1:-1], 0.0),
                    dx=maps.dx[1:-1], dy=maps.dy[1:-1], ds=maps.ds[1:-1],
                    ftype=jnp.where(valid, maps.ftype[1:-1], TYPE_NONE))
                fl = compact_level_keypoints(
                    maps, p.key_level_sigma(kl), sigma_step, cap)
                # local row band -> global frame; octave -> input frame
                oss = float(1 << o)
                if not describe:
                    out.append(dict(
                        x=jnp.where(fl.valid, oss * (fl.x - 0.5) + 0.5,
                                    0.0),
                        y=jnp.where(fl.valid,
                                    oss * (fl.y + grow0 - 0.5) + 0.5, 0.0),
                        sigma=oss * fl.sigma,
                        response=fl.response,
                        ftype=jnp.where(fl.valid, fl.ftype, TYPE_NONE),
                        valid=fl.valid))
                    continue

                per_level.append((fl, gbufs[kl], rbufs[kl], off, w_o,
                                  ho, grow0, oss, _win))

        if describe:
            # single-chip-parity global cap + -topk/-tc* truncation
            # BEFORE the orientation/descriptor work (the reference
            # truncates before GetFeatureOrientations, SiftPyramid.cpp:
            # 131-139); the masks are computed identically on every shard
            keep = _global_keep([t[0] for t in per_level], cfg, axis, G)
            per_level = [(t[0]._replace(valid=t[0].valid & keep[li]),)
                         + t[1:] for li, t in enumerate(per_level)]
            for (fl, gbuf, rbuf, _off, w_o, ho, grow0, oss, winf) \
                    in per_level:
                out.append(_orient_describe_level(
                    fl, gbuf, rbuf, winf, cfg, w_o, ho, grow0,
                    oss, owin, dwin, single, MO, TYPE_NONE))
        return jax.tree.map(lambda *xs: jnp.stack(xs), *out)

    keys = ["x", "y", "sigma", "response", "ftype", "valid"]
    ospec = {k: P(None, axis) for k in keys}
    if describe:
        ospec["theta"] = P(None, axis)
        ospec["desc"] = P(None, axis, None)
    fn = jax.jit(jax.shard_map(
        block_fn, mesh=mesh,
        in_specs=P(axis, None),
        out_specs=ospec))
    return fn, (G if describe else None)
