"""Descriptor service for externally supplied keypoints.

JAX equivalent of RunSIFT(num, keys, has_orientation) - the keypoint-list
re-entry path (reference SiftGPU.cpp:307-315, SiftPyramid::SetKeypointList
SiftPyramid.cpp:326-355, PyramidCU::GenerateFeatureListTex
PyramidCU.cpp:555-718). COLMAP-style SfM systems use this to compute
descriptors at externally detected/tracked locations.

The reference bins keypoints to (octave, level) by scale on the CPU and
uploads per-level lists; we do the same host-side binning (it is inherently
data-dependent) and run jitted per-level orientation/descriptor stages with
bucketed list sizes.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import SiftConfig
from .ops import hessian
from .ops.descriptor import compute_descriptors, descriptor_window_size
from .ops.orientation import compute_orientations
from .pyramid import PipelinePlan, _CfgKey, _build_pyramid, make_plan

TWO_PI = 2.0 * math.pi


@functools.partial(jax.jit, static_argnums=(1, 2))
def _pyramid_gradients(img, plan: PipelinePlan, cfg_key):
    """Build the pyramid and return per-(octave,key_level) gradient maps.

    Reference: BuildPyramid + ComputeGradient (PyramidCU.cpp:1736-1790).
    """
    cfg = cfg_key.cfg
    p = cfg.scale_params()
    octaves = _build_pyramid(img, plan, cfg)
    grads, rots = [], []
    for gauss_oct in octaves:
        if cfg.detector == "hessian":
            _, grad, rot = hessian.hessian_response_and_gradient(
                gauss_oct, [1.0] * gauss_oct.shape[0],
                grad_levels=p.key_levels)
            shift = 0
        else:
            # DoG gradients come from gauss[1:] (see pyramid._detect_octave)
            _, grad, rot = hessian.dog_response_and_gradient(gauss_oct)
            shift = 1
        for kl in p.key_levels:
            grads.append(grad[kl - shift])
            rots.append(rot[kl - shift])
    return grads, rots


@functools.partial(jax.jit, static_argnums=(6, 7, 8))
def _orient_and_describe_level(x, y, sigma, theta, valid, grad_rot,
                               wsize: int, dwin: int, cfg_key):
    """Single-level: optional strongest-orientation + descriptors."""
    cfg, skip_orientation = cfg_key
    cfg = cfg.cfg
    grad, rot = grad_rot
    if not skip_orientation:
        ores = compute_orientations(
            x, y, sigma, valid, grad, rot, wsize=wsize,
            gaussian_factor=cfg.orientation_gaussian_factor,
            window_factor=cfg.orientation_window_factor,
            half_sift=cfg.half_sift,
            single=True,  # existing keypoints keep only the strongest
        )
        theta = ores.thetas[:, 0]
    desc = compute_descriptors(
        x, y, sigma, theta, valid, grad, rot, wsize=dwin,
        window_factor=cfg.descriptor_window_factor,
        half_sift=cfg.half_sift, normalize=cfg.normalized_sift)
    return theta, desc


def describe_rectangles(
    image: np.ndarray,
    rects: np.ndarray,
    cfg: Optional[SiftConfig] = None,
) -> Dict[str, np.ndarray]:
    """Axis-aligned rectangle description (reference RECT mode:
    SetKeypointList(..., skip_orientation=-1), ComputeDescriptorRECT).

    rects: (N, 4) columns x, y (top-left), width, height in image coords.
    Rectangles are binned to levels by min(w, h)/12 (the reference's rect
    scale proxy, PyramidCU.cpp:598-599).
    """
    from .ops.descriptor import compute_descriptors_rect
    from .ops.resize import rgb_to_gray, to_float

    cfg = cfg or SiftConfig()
    p = cfg.scale_params()

    arr = jnp.asarray(image)
    arr = to_float(arr)
    if arr.ndim == 3:
        arr = rgb_to_gray(arr)
    h, w = arr.shape
    plan = make_plan(h, w, cfg)
    grads, rots = _pyramid_gradients(arr, plan, _CfgKey(cfg))

    rects = np.asarray(rects, np.float32)
    n = rects.shape[0]
    out_desc = np.zeros((n, cfg.descriptor_dim), np.float32)

    shalf = 2.0 ** (0.5 / p.num_scales)
    s = p.num_scales
    sigma_proxy = np.minimum(rects[:, 2], rects[:, 3]) / 12.0

    assigned = np.full(n, -1, np.int32)
    octave_sigma = float(1 << cfg.first_octave)
    offset = 0.0 if cfg.lowe_origin else 0.5
    for o in range(plan.num_octaves):
        for li, kl in enumerate(p.key_levels):
            idx = o * s + li
            level_sigma = p.key_level_sigma(kl) * octave_sigma
            smin, smax = level_sigma / shalf, level_sigma * shalf
            sel = (sigma_proxy >= smin) & (sigma_proxy < smax)
            if o == 0 and li == 0:
                sel |= sigma_proxy < smin
            if o == plan.num_octaves - 1 and li == s - 1:
                sel |= sigma_proxy >= smax
            sel &= assigned < 0
            assigned[sel] = idx
        octave_sigma *= 2.0

    octave_sigma = float(1 << cfg.first_octave)
    for o in range(plan.num_octaves):
        for li, kl in enumerate(p.key_levels):
            idx = o * s + li
            members = np.nonzero(assigned == idx)[0]
            if len(members) == 0:
                continue
            fx = (rects[members, 0] - offset) / octave_sigma + 0.5
            fy = (rects[members, 1] - offset) / octave_sigma + 0.5
            frw = rects[members, 2] / octave_sigma
            frh = rects[members, 3] / octave_sigma

            cap = max(8, 1 << int(math.ceil(math.log2(len(members)))))
            padn = cap - len(members)
            valid = np.zeros(cap, bool)
            valid[: len(members)] = True
            fx = np.pad(fx, (0, padn))
            fy = np.pad(fy, (0, padn))
            frw = np.pad(frw, (0, padn), constant_values=4.0)
            frh = np.pad(frh, (0, padn), constant_values=4.0)

            wsize = int(math.ceil(max(frw[: len(members)].max(),
                                      frh[: len(members)].max()))) + 4
            desc = compute_descriptors_rect(
                jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(frw),
                jnp.asarray(frh), jnp.asarray(valid),
                grads[idx], rots[idx], wsize=wsize,
                half_sift=cfg.half_sift, normalize=cfg.normalized_sift)
            out_desc[members] = np.asarray(desc)[: len(members)]
        octave_sigma *= 2.0

    return {"x": rects[:, 0], "y": rects[:, 1], "w": rects[:, 2],
            "h": rects[:, 3], "desc": out_desc}


def describe_keypoints(
    image: np.ndarray,
    keys: np.ndarray,
    cfg: Optional[SiftConfig] = None,
    has_orientation: bool = True,
) -> Dict[str, np.ndarray]:
    """Compute SIFT descriptors (and optionally orientations) for given
    keypoints on an image.

    image: grayscale (H, W) float/uint8 or RGB (H, W, 3).
    keys: (N, >=3) columns x, y, sigma[, theta] in image coordinates.
    has_orientation: if False (or no theta column), the strongest
    orientation is computed per keypoint (reference: SKIP_ORIENTATION unset).

    Returns dict with x, y, sigma, theta, desc in the ORIGINAL input order
    (reference restores order via _keypoint_index, PyramidCU.cpp:537-549).
    """
    from .ops.resize import rgb_to_gray, to_float

    cfg = cfg or SiftConfig()
    p = cfg.scale_params()

    arr = jnp.asarray(image)
    arr = to_float(arr)
    if arr.ndim == 3:
        arr = rgb_to_gray(arr)
    h, w = arr.shape
    plan = make_plan(h, w, cfg)
    grads, rots = _pyramid_gradients(arr, plan, _CfgKey(cfg))

    keys = np.asarray(keys, np.float32)
    n = keys.shape[0]
    kx, ky, ks = keys[:, 0], keys[:, 1], keys[:, 2]
    kt = keys[:, 3] if (keys.shape[1] > 3 and has_orientation) \
        else np.zeros(n, np.float32)
    skip_orientation = has_orientation and keys.shape[1] > 3

    offset = 0.0 if cfg.lowe_origin else 0.5
    shalf = 2.0 ** (0.5 / p.num_scales)
    s = p.num_scales

    out_theta = np.zeros(n, np.float32)
    out_desc = np.zeros((n, cfg.descriptor_dim), np.float32)

    # ---- host-side binning by scale (GenerateFeatureListTex semantics) ----
    assigned = np.full(n, -1, np.int32)
    octave_sigma = float(1 << cfg.first_octave)
    for o in range(plan.num_octaves):
        for li, kl in enumerate(p.key_levels):
            idx = o * s + li
            level_sigma = p.key_level_sigma(kl) * octave_sigma
            smin, smax = level_sigma / shalf, level_sigma * shalf
            sel = (ks >= smin) & (ks < smax)
            if o == 0 and li == 0:
                sel |= ks < smin
            if o == plan.num_octaves - 1 and li == s - 1:
                sel |= ks >= smax
            sel &= assigned < 0
            assigned[sel] = idx
        octave_sigma *= 2.0

    octave_sigma = float(1 << cfg.first_octave)
    for o in range(plan.num_octaves):
        for li, kl in enumerate(p.key_levels):
            idx = o * s + li
            members = np.nonzero(assigned == idx)[0]
            if len(members) == 0:
                continue
            # level-frame coordinates (PyramidCU.cpp:616-626)
            fx = (kx[members] - offset) / octave_sigma + 0.5
            fy = (ky[members] - offset) / octave_sigma + 0.5
            fs = ks[members] / octave_sigma
            ft = np.mod(TWO_PI - kt[members], TWO_PI)

            # bucket the list length to limit recompiles
            cap = max(8, 1 << int(math.ceil(math.log2(len(members)))))
            pad = cap - len(members)
            valid = np.zeros(cap, bool)
            valid[: len(members)] = True
            fx = np.pad(fx, (0, pad)); fy = np.pad(fy, (0, pad))
            fs = np.pad(fs, (0, pad), constant_values=1.0)
            ft = np.pad(ft, (0, pad))

            max_sigma = float(fs[: len(members)].max())
            owin = 2 * int(math.ceil(
                max_sigma * cfg.orientation_gaussian_factor
                * cfg.orientation_window_factor + 1.0)) + 1
            dwin = descriptor_window_size(max_sigma,
                                          cfg.descriptor_window_factor)
            theta_dev, desc = _orient_and_describe_level(
                jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(fs),
                jnp.asarray(ft), jnp.asarray(valid),
                (grads[idx], rots[idx]), owin, dwin,
                (_CfgKey(cfg), skip_orientation))
            theta_img = np.mod(TWO_PI - np.asarray(theta_dev[: len(members)]),
                               TWO_PI)
            out_theta[members] = kt[members] if skip_orientation else theta_img
            out_desc[members] = np.asarray(desc)[: len(members)]
        octave_sigma *= 2.0

    return {"x": kx, "y": ky, "sigma": ks, "theta": out_theta,
            "desc": out_desc}
