"""End-to-end detection pipeline: Gaussian pyramid -> Hessian response ->
keypoints -> top-K -> orientations -> descriptors.

JAX re-architecture of SiftPyramid::RunSIFT's template method
(SiftPyramid.cpp:53-198) + PyramidCU stage implementations. Differences by
design (SURVEY.md section 7):
  * the whole pipeline is one jitted function per static (H, W, octaves)
    bucket - no per-stage host round-trips (the reference does 4+ PCIe
    transfers per image, PyramidCU.cpp:720-924);
  * feature lists are fixed-capacity SoA arrays with validity masks instead
    of atomically-compacted textures;
  * global top-K selection is a threshold select over the concatenated
    response vector instead of an 850-line bitonic-sort subsystem
    (ProgramCU.cu:2205-3053);
  * multi-orientation expansion happens on device (the reference's
    ReshapeFeatureListCPU is a host round-trip, PyramidCU.cpp:720-924).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import (SiftConfig, TRUNCATE_KEEP_HIGHEST_LEVELS,
                     TRUNCATE_KEEP_LOWEST_LEVELS, TRUNCATE_TOP_K)
from .features import FeatureTable
from .ops import gaussian, hessian, keypoint, resize
from .ops.compaction import (FeatureList, compact_octave_keypoints,
                             compact_sorted)
from .ops.descriptor import (compute_descriptors_flat,
                             descriptor_window_size)
from .ops.orientation import compute_orientations_flat

TWO_PI = 2.0 * math.pi


class PipelinePlan(NamedTuple):
    """Static shape plan for one (H, W) input bucket."""
    height: int
    width: int
    num_octaves: int
    octave_shapes: Tuple[Tuple[int, int], ...]
    level_caps: Tuple[int, ...]          # per (octave, key_level) capacity
    expanded_caps: Tuple[int, ...]       # after multi-orientation expansion


def make_plan(height: int, width: int, cfg: SiftConfig) -> PipelinePlan:
    """Compute the static octave/capacity layout for an input size.

    Mirrors SiftGPU::RunSIFT pyramid sizing: octaves until the smaller
    working dimension reaches min_dim (SiftPyramid.cpp:305-311), capped by
    num_octaves if set.
    """
    from .params import max_features_per_level, octave_shapes, required_octaves

    noct = required_octaves(min(height, width), cfg.min_dim)
    if cfg.num_octaves > 0:
        noct = min(noct, cfg.num_octaves)
    shapes = octave_shapes(height, width, noct)
    p = cfg.scale_params()

    caps = []
    ecaps = []
    for (h, w) in shapes:
        cap = max_features_per_level(h, w, cfg.max_feature_percent,
                                     cfg.max_level_features)
        ecap = (int(cap * 1.5) + 7) // 8 * 8
        for _ in p.key_levels:
            caps.append(cap)
            ecaps.append(ecap)
    return PipelinePlan(height, width, noct, tuple(shapes), tuple(caps),
                        tuple(ecaps))


# ---------------------------------------------------------------------------
# stage helpers
# ---------------------------------------------------------------------------

def _build_pyramid(img: jnp.ndarray, plan: PipelinePlan, cfg: SiftConfig):
    """Gaussian stacks for every octave. img: (H, W) f32 [0,1].

    Reference: PyramidCU::BuildPyramid (PyramidCU.cpp:1486-1558). The
    separable blurs are XLA convolutions (ops/gaussian.py), which play
    the part of the reference's FilterH/FilterV shared-memory kernels.
    """
    p = cfg.scale_params()

    def blur(x, sigma):
        return gaussian.blur(x, sigma, p.filter_width_factor)

    build = (gaussian.build_octave_chain if cfg.conv_mode == "chain"
             else gaussian.build_octave_direct)

    octaves = []
    base = blur(img, p.initial_blur_sigma(cfg.first_octave))
    lds = p.level_ds - p.level_min
    for o in range(plan.num_octaves):
        if o > 0:
            base = resize.downsample(octaves[-1][lds], 1)
            # decimation keeps ceil(h/2) rows (even indices of h), but the
            # plan floor-halves like the reference (w>>1, h>>1,
            # PyramidCU.cpp:150): crop so plan and arrays agree for
            # odd-dimension octaves (no-op slice for even dims)
            oh, ow = plan.octave_shapes[o]
            base = base[..., :oh, :ow]
            skip = p.octave_restart_sigma()
            if skip > 0:
                base = blur(base, skip)
        octaves.append(build(base, p))
    return octaves


def _detect_norms(p, cfg: SiftConfig):
    """Per-level response norms: sigma^4 for the Hessian personality
    (the reference's octave term is deliberately disabled,
    PyramidCU.cpp:1569-1589); unused (1.0) for DoG."""
    if cfg.detector == "hessian":
        return [(p.level_sigma(l) ** 4)
                for l in range(p.level_min, p.level_max + 1)]
    return [1.0] * p.num_levels


def _detect_octave(gauss_oct: jnp.ndarray, plan: PipelinePlan,
                   cfg: SiftConfig):
    """Response + gradients + keypoint maps for one octave.

    Returns (maps, grad_k, rot_k): maps is a KeypointMaps with leaves
    stacked over key levels ((NK, H, W) - row i = key level
    p.key_levels[i]), grad_k/rot_k are the per-KEY-level gradient maps."""
    p = cfg.scale_params()
    if cfg.detector == "hessian":
        resp, grad, rot = hessian.hessian_response_and_gradient(
            gauss_oct, _detect_norms(p, cfg), grad_levels=p.key_levels)
    else:
        resp, grad, rot = hessian.dog_response_and_gradient(gauss_oct)

    maps = []
    for kl in p.key_levels:
        m = keypoint.detect_keypoints_level(
            resp[kl - 1], resp[kl], resp[kl + 1], gauss_oct[kl],
            threshold=p.threshold, edge_threshold=p.edge_threshold,
            subpixel=cfg.subpixel, hessian=(cfg.detector == "hessian"),
            darkness_adaption=cfg.darkness_adaption,
        )
        maps.append(m)
    if cfg.detector != "hessian":
        # DoG gradients come from gauss[1:], so grad[i] belongs to gauss
        # level i+1; re-align so grad[kl] is the keypoint level's gradient
        grad = jnp.concatenate([grad[:1], grad], axis=0)
        rot = jnp.concatenate([rot[:1], rot], axis=0)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *maps)
    grad_k = jnp.stack([grad[kl] for kl in p.key_levels])
    rot_k = jnp.stack([rot[kl] for kl in p.key_levels])
    return stacked, grad_k, rot_k


class GlobalTable(NamedTuple):
    """Cross-level compacted keypoint table (level coordinates)."""
    x: jnp.ndarray
    y: jnp.ndarray
    sigma: jnp.ndarray
    theta: jnp.ndarray
    response: jnp.ndarray
    ftype: jnp.ndarray
    level_id: jnp.ndarray   # i32 flattened (octave * s + key_level - 1)
    valid: jnp.ndarray

    def count(self):
        return jnp.sum(self.valid.astype(jnp.int32))


def _globalize(lists: List[FeatureList], cap: int) -> GlobalTable:
    """Concatenate per-level (or per-octave blocked, with (NK, cap_o)
    leaves) lists and compact into one global table.

    Keeps level-major order (= the reference's output order). Level ids
    per slot are static, so the id vector is a compile-time constant."""
    def cat(field):
        return jnp.concatenate(
            [getattr(fl, field).reshape(-1) for fl in lists])

    lid_np = []
    base = 0
    for fl in lists:
        v = fl.valid
        if v.ndim == 2:       # blocked: rows are consecutive levels
            nk, c = v.shape
            lid_np.append(np.repeat(base + np.arange(nk), c))
            base += nk
        else:
            lid_np.append(np.full(v.shape[0], base))
            base += 1
    lid = jnp.asarray(np.concatenate(lid_np), jnp.int32)
    valid = cat("valid")
    # payloads ride one variadic sort (theta is still all-zero here, and
    # level_id packs with the 2-bit type)
    lidft = (lid << 2) | (cat("ftype") & 3)
    cnt, outs, slot_valid = compact_sorted(
        valid,
        [cat("x"), cat("y"), cat("sigma"), cat("response"), lidft],
        cap,
    )
    x, y, s, r, lf = outs
    return GlobalTable(x=x, y=y, sigma=s, theta=jnp.zeros_like(x),
                       response=r, ftype=jnp.where(slot_valid, lf & 3, 0),
                       level_id=lf >> 2, valid=slot_valid)


def _recompact(table: GlobalTable, keep: jnp.ndarray, cap: int) -> GlobalTable:
    lidft = (table.level_id << 2) | (table.ftype & 3)
    cnt, outs, slot_valid = compact_sorted(
        keep & table.valid,
        [table.x, table.y, table.sigma, table.theta, table.response, lidft],
        cap,
    )
    x, y, s, t, r, lf = outs
    return GlobalTable(x=x, y=y, sigma=s, theta=t, response=r,
                       ftype=jnp.where(slot_valid, lf & 3, 0),
                       level_id=lf >> 2, valid=slot_valid)


def _topk_mask(table: GlobalTable, k: int) -> jnp.ndarray:
    """Selection mask for the k largest |response| (ties by global order).

    Behavior-equivalent to PyramidCU::SelectTopK (PyramidCU.cpp:1881-1989)."""
    absr = jnp.where(table.valid, jnp.abs(table.response), -jnp.inf)
    kk = min(k, absr.shape[0])
    vk = jax.lax.top_k(absr, kk)[0][-1]
    above = absr > vk
    n_above = jnp.sum(above.astype(jnp.int32))
    ties = absr == vk
    tie_rank = jnp.cumsum(ties.astype(jnp.int32))
    return above | (ties & (tie_rank <= (kk - n_above)))


def _level_trunc_mask(table: GlobalTable, k: int, num_levels: int,
                      keep_lowest: bool) -> jnp.ndarray:
    """-tc1/-tc2 level-dropping masks (SiftPyramid.cpp:224-277)."""
    ones = table.valid.astype(jnp.int32)
    counts = jax.ops.segment_sum(ones, table.level_id, num_levels)
    if keep_lowest:
        cum = jnp.cumsum(counts)
        keep_level = (cum - counts) < k
    else:
        total = jnp.sum(counts)
        suffix = total - (jnp.cumsum(counts) - counts)
        keepable = suffix <= k
        first_keep = jnp.argmax(keepable)
        first_keep = jnp.where(jnp.any(keepable), first_keep, num_levels - 1)
        keep_level = jnp.arange(num_levels) >= first_keep
    return keep_level[table.level_id]


def run_pipeline(img: jnp.ndarray, plan: PipelinePlan, cfg: SiftConfig) -> FeatureTable:
    """Full detect+describe for one grayscale image (static shapes).

    img: (H, W) f32 in [0, 1].
    Returns a FeatureTable in image coordinates (reference download frame:
    x_img = 2^octave * (x_level - 0.5) + offset, orientation mirrored -
    PyramidCU.cpp:890-903).
    """
    p = cfg.scale_params()
    sigma_step = p.sigmak
    s = p.num_scales

    # named scopes carry the reference TIMINGS_* bucket names (config.h:
    # 17-31) into the compiled HLO's op metadata; utils.timing.
    # device_stage_breakdown maps profiler trace ops back through them.
    with jax.named_scope("BUILD_PYRAMID"):
        octaves = _build_pyramid(img, plan, cfg)

    NKEY = len(p.key_levels)
    max_sigma = p.key_level_sigma(p.key_levels[-1]) * \
        (sigma_step if cfg.subpixel else 1.0)
    owin = 2 * int(math.ceil(
        abs(max_sigma) * cfg.orientation_gaussian_factor
        * cfg.orientation_window_factor + 1.0)) + 1
    dwin = descriptor_window_size(max_sigma, cfg.descriptor_window_factor)

    # ---- detection + per-octave compaction --------------------------------
    all_lists: List[FeatureList] = []
    grads: List[jnp.ndarray] = []
    rots: List[jnp.ndarray] = []
    sigmas = [p.key_level_sigma(kl) for kl in p.key_levels]
    for o, gauss_oct in enumerate(octaves):
        with jax.named_scope("DETECT_KEYPOINTS"):
            maps, grad, rot = _detect_octave(gauss_oct, plan, cfg)
        with jax.named_scope("GENERATE_FEATURE_LIST"):
            # one blocked list per octave ((NK, cap) leaves)
            all_lists.append(compact_octave_keypoints(
                maps, sigmas, sigma_step, plan.level_caps[o * NKEY]))
        grads.extend(grad[li] for li in range(NKEY))
        rots.extend(rot[li] for li in range(NKEY))

    # ---- global table + flattened pyramid buffers -----------------------------
    # per-(octave, level) counts for the -v report (reference
    # PyramidCU.cpp:1327-1343) and the pre-reduction total (reference
    # "#Features Reduced" report, SiftPyramid.cpp:219-247)
    with jax.named_scope("GENERATE_FEATURE_LIST"):
        level_counts = jnp.concatenate(
            [fl.count() for fl in all_lists], axis=-1)
        G = min(cfg.global_feature_cap, sum(plan.level_caps))
        table = _globalize(all_lists, G)
        pre_count = table.count()

    # flattened pyramid buffers for the orientation/descriptor gathers
    flat_grad = jnp.concatenate([g.reshape(-1) for g in grads])
    flat_rot = jnp.concatenate([r.reshape(-1) for r in rots])
    sizes = [g.shape for g in grads]
    bases = np.cumsum([0] + [h * w for (h, w) in sizes[:-1]])
    level_base = jnp.asarray(bases, jnp.int32)
    level_h = jnp.asarray([h for (h, _) in sizes], jnp.int32)
    level_w = jnp.asarray([w for (_, w) in sizes], jnp.int32)

    # ---- truncation (reference LimitFeatureCount, SiftPyramid.cpp:201-278)
    if cfg.feature_count_threshold > 0:
        k = cfg.feature_count_threshold
        with jax.named_scope("FEATURES_REDUCTION"):
            if cfg.truncate_method == TRUNCATE_TOP_K:
                table = _recompact(table, _topk_mask(table, k), G)
            elif cfg.truncate_method == TRUNCATE_KEEP_LOWEST_LEVELS:
                table = _recompact(
                    table, _level_trunc_mask(table, k, len(plan.level_caps),
                                             True),
                    G)
            elif cfg.truncate_method == TRUNCATE_KEEP_HIGHEST_LEVELS:
                table = _recompact(
                    table, _level_trunc_mask(table, k, len(plan.level_caps),
                                             False),
                    G)

    # ---- orientations (one pass over all levels) ------------------------------
    single = cfg.max_orientations <= 1 or cfg.fixed_orientation

    if cfg.fixed_orientation:
        table = table._replace(theta=jnp.zeros_like(table.theta))
    else:
        with jax.named_scope("COMPUTE_ORIENTATIONS"):
            ores = compute_orientations_flat(
                table.x, table.y, table.sigma, table.valid,
                table.level_id, flat_grad, flat_rot,
                level_base, level_h, level_w,
                wsize=owin,
                num_orientations=cfg.max_orientations,
                gaussian_factor=cfg.orientation_gaussian_factor,
                window_factor=cfg.orientation_window_factor,
                peak_threshold=cfg.multi_orientation_threshold,
                half_sift=cfg.half_sift,
                single=single,
            )
            o_thetas, o_valid = ores.thetas, ores.valid
        if single:
            table = table._replace(theta=o_thetas[:, 0])
        else:
            with jax.named_scope("MULTI_ORIENTATIONS"):
                G_exp = int(G * cfg.expansion_factor + 7) // 8 * 8
                mask = (o_valid & table.valid[:, None]).reshape(-1)
                rep = lambda a: jnp.repeat(a, 4)
                lidft = (table.level_id << 2) | (table.ftype & 3)
                cnt, outs, slot_valid = compact_sorted(
                    mask,
                    [rep(table.x), rep(table.y), rep(table.sigma),
                     o_thetas.reshape(-1), rep(table.response),
                     rep(lidft)],
                    G_exp,
                )
                x, y, sg, th, r, lf = outs
                table = GlobalTable(
                    x=x, y=y, sigma=sg, theta=th, response=r,
                    ftype=jnp.where(slot_valid, lf & 3, 0),
                    level_id=lf >> 2, valid=slot_valid)

    # ---- descriptors (separate pass) ----------------------------------
    if cfg.compute_descriptors:
        with jax.named_scope("COMPUTE_DESCRIPTORS"):
            desc = compute_descriptors_flat(
                table.x, table.y, table.sigma, table.theta, table.valid,
                table.level_id, flat_grad, flat_rot,
                level_base, level_h, level_w,
                wsize=dwin,
                window_factor=cfg.descriptor_window_factor,
                half_sift=cfg.half_sift,
                normalize=cfg.normalized_sift,
            )
    else:
        desc = jnp.zeros((table.x.shape[0], cfg.descriptor_dim),
                         jnp.float32)

    # ---- convert to image coordinates -----------------------------------------
    offset = 0.0 if cfg.lowe_origin else 0.5
    octave_id = table.level_id // s
    oss = jnp.exp2(octave_id.astype(jnp.float32) + cfg.first_octave)

    out = FeatureTable(
        x=oss * (table.x - 0.5) + offset,
        y=oss * (table.y - 0.5) + offset,
        sigma=oss * table.sigma,
        theta=jnp.where(table.valid,
                        jnp.mod(TWO_PI - table.theta, TWO_PI), 0.0),
        response=table.response,
        level=table.level_id,
        ftype=table.ftype,
        valid=table.valid,
        desc=desc,
    )
    aux = {"level_counts": level_counts, "pre_count": pre_count}
    return out, aux


def run_pipeline_batched(imgs: jnp.ndarray, plan: PipelinePlan,
                         cfg: SiftConfig):
    """Full detect+describe for a batch (B, H, W): run_pipeline under
    vmap, so one traced program serves every B.

    Returns (FeatureTable with leading dim B, aux dict with
    level_counts (B, n_levels) and pre_count (B,)).
    """
    return jax.vmap(lambda im: run_pipeline(im, plan, cfg))(imgs)


@functools.partial(jax.jit, static_argnums=(1, 2))
def run_pipeline_jit(img, plan: PipelinePlan, cfg_key):
    """Jitted wrapper keyed by the static plan + a hashable config.

    Returns (FeatureTable, aux) where aux carries the verbose-report
    scalars (per-level pre-reduction counts and the pre-reduction total).
    """
    return run_pipeline(img, plan, cfg_key.cfg)


class _CfgKey:
    """Hashable wrapper so SiftConfig (mutable dataclass) can be static."""

    def __init__(self, cfg: SiftConfig):
        self.cfg = cfg
        self._key = tuple(sorted(
            (k, v) for k, v in cfg.__dict__.items()
        ))

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, _CfgKey) and self._key == other._key


def prepare_input(img_np: np.ndarray, cfg: SiftConfig):
    """Normalize the input + compute the static plan: returns
    (arr (H, W) f32, plan, cfg_key) - the exact args of run_pipeline_jit."""
    from .ops.resize import rgb_to_gray, to_float

    arr = jnp.asarray(img_np)
    arr = to_float(arr)
    if arr.ndim == 3:
        arr = rgb_to_gray(arr)
    if cfg.detector == "hessian" and cfg.first_octave < 0:
        cfg = dataclasses.replace(cfg, first_octave=0)
    if cfg.first_octave > 0:
        # reference: SampleImageD of the input before octave 0
        arr = arr[:: 1 << cfg.first_octave, :: 1 << cfg.first_octave]
    elif cfg.first_octave < 0:
        # octave -1: bilinear upsample (reference SampleImageU,
        # ProgramCU.cu:233-310; SIFT personality only)
        from .ops.resize import upsample
        arr = upsample(arr, -cfg.first_octave)
    h, w = arr.shape
    plan = make_plan(h, w, cfg)
    return arr, plan, _CfgKey(cfg)


def detect_and_describe(img_np: np.ndarray, cfg: SiftConfig):
    """Host entry: NumPy image (H, W) or (H, W, C), any uint8/float dtype.

    Returns (FeatureTable, aux) - see run_pipeline_jit."""
    arr, plan, ckey = prepare_input(img_np, cfg)
    return run_pipeline_jit(arr, plan, ckey)
