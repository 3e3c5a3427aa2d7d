"""SIFT descriptor computation: rotated 4x4 cell grid, 8 orientation bins.

Vectorized equivalent of ComputeDescriptor_Kernel
(ProgramCU.cu:1650-1948) + NormalizeDescriptor (ProgramCU.cu:1950-2103).

The CUDA kernel runs 16 threads per keypoint (one per cell), each scanning
its own window. Here each keypoint gathers ONE static window covering all 16
cells and every pixel's contribution is distributed to cells/bins by
bilinear weights - mathematically identical because the per-cell Gaussian
weight exp(-0.125*(dnx^2+dny^2)) depends only on the pixel's position in the
descriptor frame (dnx = nx + offset_x is the same value for every cell that
accepts the pixel), and the per-cell window bound |nx|,|ny| < 1 plus the
interior clamp [1, dim-2] are per-pixel conditions.

Semantics preserved:
  * cell spacing spt = |sigma * window_factor|, window_factor = 3.0
    (GlobalUtil.cpp:63: _DescriptorWindowFactor).
  * rotated sampling frame via (cos, sin) of the keypoint orientation.
  * spatial bilinear over cell coords, trilinear over 8 orientation bins
    with circular wrap (des[0] += des[8], ProgramCU.cu:1776).
  * half-SIFT folds 8 bins to 4 (ProgramCU.cu:1779-1790).
  * normalization: L2 -> clamp 0.2 -> L2 (ProgramCU.cu:1983-2008).
  * rect (unrotated) variant for rectangle description
    (ComputeDescriptorRECT_Kernel, ProgramCU.cu:1811-1948).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

PI = math.pi


def descriptor_window_size(max_sigma: float, window_factor: float = 3.0) -> int:
    """Static gather window size covering the full 4x4 descriptor support.

    Support half-extent: cells span [-2, 2]*spt in the rotated frame; the
    union bounding box of per-cell windows is <= 2.5*sqrt(2)*spt + 1.
    """
    spt = abs(max_sigma * window_factor)
    r = int(math.ceil(2.5 * math.sqrt(2.0) * spt + 1.0)) + 1
    return 2 * r + 1


def _descriptor_one(kx, ky, sigma, theta, grad_win, rot_win, x0, y0,
                    width, height, window_factor):
    """128-d unnormalized descriptor for one keypoint from its window.

    grad_win/rot_win: (W, W) window gathered at integer offset (y0, x0).
    """
    wsize = grad_win.shape[0]
    iy = y0 + jnp.arange(wsize, dtype=jnp.float32).reshape(-1, 1)
    ix = x0 + jnp.arange(wsize, dtype=jnp.float32).reshape(1, -1)
    px = (ix + 0.5)
    py = (iy + 0.5)
    dx = px - kx
    dy = py - ky

    spt = jnp.abs(sigma * window_factor)
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    crspt = c / spt
    srspt = s / spt
    # cell-frame coords: u along descriptor x, v along descriptor y
    u = crspt * dx + srspt * dy
    v = crspt * dy - srspt * dx
    anglef = jnp.where(theta > PI, theta - 2.0 * PI, theta)
    gauss_w = jnp.exp(-0.125 * (u * u + v * v))

    # cell coordinates in [ -0.5, 3.5 ]: cell ix accepts |cu - ix| < 1
    cu = u + 1.5
    cv = v + 1.5

    interior = (
        (ix >= 1.0) & (ix <= width - 2.0) & (iy >= 1.0) & (iy <= height - 2.0)
    )
    in_support = (cu > -1.0) & (cu < 4.0) & (cv > -1.0) & (cv < 4.0)
    base_mask = interior & in_support

    mag = grad_win
    theta_pix = (anglef - rot_win) * (4.0 / PI)
    theta_pix = jnp.where(theta_pix < 0, theta_pix + 8.0, theta_pix)
    fo = jnp.floor(theta_pix)
    ob = jnp.clip(fo.astype(jnp.int32), 0, 7)   # 0..7 (guard fp edge at 8.0)
    w2 = theta_pix - fo                # weight for bin ob+1
    w1 = 1.0 - w2

    weight = jnp.where(base_mask, gauss_w * mag, 0.0)

    cells = jnp.arange(4, dtype=jnp.float32)
    # (P, 4) bilinear cell weights; |cu - cell| < 1 guard = reference |nx|<1
    ax = jnp.maximum(0.0, 1.0 - jnp.abs(cu.reshape(-1, 1) - cells.reshape(1, -1)))
    ay = jnp.maximum(0.0, 1.0 - jnp.abs(cv.reshape(-1, 1) - cells.reshape(1, -1)))

    # orientation: scatter w1 -> bin ob, w2 -> bin (ob+1) mod 8
    bins = jnp.arange(8, dtype=jnp.int32)
    obf = ob.reshape(-1, 1)
    o_mat = (w1.reshape(-1, 1) * (obf == bins.reshape(1, -1))
             + w2.reshape(-1, 1) * (((obf + 1) % 8) == bins.reshape(1, -1)))
    o_mat = o_mat * weight.reshape(-1, 1)  # (P, 8)

    # desc[cy, cx, b] = sum_p ay[p,cy] * ax[p,cx] * o_mat[p,b]
    spatial = (ay[:, :, None] * ax[:, None, :]).reshape(-1, 16)  # (P, 16)
    desc = jnp.dot(spatial.T, o_mat, preferred_element_type=jnp.float32)
    return desc.reshape(-1)  # (128,) ordered [cy, cx, bin]


def compute_descriptors(
    x, y, sigma, theta, kvalid,
    grad: jnp.ndarray, rot: jnp.ndarray,
    wsize: int,
    window_factor: float = 3.0,
    half_sift: bool = False,
    normalize: bool = True,
    chunk: int = 256,
) -> jnp.ndarray:
    """Descriptors for a level's keypoint list. Returns (K, 128) (or (K, 64))."""
    height, width = grad.shape
    wsize = min(wsize, height, width)  # tiny octaves: window = whole image
    K = x.shape[0]

    def per_kp(kx, ky, ks, kt):
        y0 = jnp.floor(ky - (wsize - 1) / 2.0).astype(jnp.int32)
        x0 = jnp.floor(kx - (wsize - 1) / 2.0).astype(jnp.int32)
        y0 = jnp.clip(y0, 0, max(height - wsize, 0))
        x0 = jnp.clip(x0, 0, max(width - wsize, 0))
        gwin = jax.lax.dynamic_slice(grad, (y0, x0), (wsize, wsize))
        rwin = jax.lax.dynamic_slice(rot, (y0, x0), (wsize, wsize))
        return _descriptor_one(kx, ky, ks, kt, gwin, rwin,
                               x0.astype(jnp.float32), y0.astype(jnp.float32),
                               width, height, window_factor)

    if K <= chunk:
        desc = jax.vmap(per_kp)(x, y, sigma, theta)
    else:
        # chunk the keypoint axis to bound the gathered-window working set
        pad = (-K) % chunk
        xs = [jnp.pad(a, (0, pad)) for a in (x, y, sigma, theta)]
        xs = [a.reshape(-1, chunk) for a in xs]
        desc = jax.lax.map(lambda t: jax.vmap(per_kp)(*t), tuple(xs))
        desc = desc.reshape(-1, 128)[:K]

    desc = jnp.where(kvalid[:, None], desc, 0.0)
    if half_sift:
        d = desc.reshape(-1, 16, 8)
        desc = (d[..., :4] + d[..., 4:]).reshape(-1, 64)
    if normalize:
        desc = normalize_descriptors(desc, kvalid)
    return desc


def _descriptor_rect_one(kx, ky, rw, rh, grad_win, rot_win, x0, y0,
                         width, height):
    """Unrotated rectangle descriptor (ComputeDescriptorRECT_Kernel,
    ProgramCU.cu:1811-1948): 4x4 cells tile the rectangle whose top-left
    corner is (kx, ky) and size is (rw, rh); no Gaussian weighting, no
    rotation; orientation bins relative to angle 0.
    """
    wsize = grad_win.shape[0]
    iy = y0 + jnp.arange(wsize, dtype=jnp.float32).reshape(-1, 1)
    ix = x0 + jnp.arange(wsize, dtype=jnp.float32).reshape(1, -1)
    px = ix + 0.5
    py = iy + 0.5

    sptx = rw * 0.25
    spty = rh * 0.25
    # cell coords: cell i accepts |(p - pt_i)/spt| < 1 with
    # pt_i = k + (i + 0.5) * spt  =>  cu = (px - kx)/sptx - 0.5
    # (broadcast the separable coords to the full window grid)
    cu = jnp.broadcast_to((px - kx) / sptx - 0.5, (wsize, wsize))
    cv = jnp.broadcast_to((py - ky) / spty - 0.5, (wsize, wsize))

    interior = (ix >= 1.0) & (ix <= width - 2.0) & \
        (iy >= 1.0) & (iy <= height - 2.0)
    in_support = (cu > -1.0) & (cu < 4.0) & (cv > -1.0) & (cv < 4.0)
    base_mask = interior & in_support

    theta_pix = (-rot_win) * (4.0 / PI)
    theta_pix = jnp.where(theta_pix < 0, theta_pix + 8.0, theta_pix)
    fo = jnp.floor(theta_pix)
    ob = jnp.clip(fo.astype(jnp.int32), 0, 7)
    w2 = theta_pix - fo
    w1 = 1.0 - w2

    weight = jnp.where(base_mask, grad_win, 0.0)

    cells = jnp.arange(4, dtype=jnp.float32)
    ax = jnp.maximum(0.0, 1.0 - jnp.abs(cu.reshape(-1, 1) - cells.reshape(1, -1)))
    ay = jnp.maximum(0.0, 1.0 - jnp.abs(cv.reshape(-1, 1) - cells.reshape(1, -1)))

    bins = jnp.arange(8, dtype=jnp.int32)
    obf = ob.reshape(-1, 1)
    o_mat = (w1.reshape(-1, 1) * (obf == bins.reshape(1, -1))
             + w2.reshape(-1, 1) * (((obf + 1) % 8) == bins.reshape(1, -1)))
    o_mat = o_mat * weight.reshape(-1, 1)

    spatial = (ay[:, :, None] * ax[:, None, :]).reshape(-1, 16)
    desc = jnp.dot(spatial.T, o_mat, preferred_element_type=jnp.float32)
    return desc.reshape(-1)


def compute_descriptors_rect(
    x, y, rect_w, rect_h, kvalid,
    grad: jnp.ndarray, rot: jnp.ndarray,
    wsize: int,
    half_sift: bool = False,
    normalize: bool = True,
) -> jnp.ndarray:
    """Rect descriptors for a level's keypoint list ((K,) rect geometry).

    The gather window is centered on the rectangle center (kx + rw/2,
    ky + rh/2).
    """
    height, width = grad.shape
    wsize = min(wsize, height, width)

    def per_kp(kx, ky, rw, rh):
        cx = kx + rw * 0.5
        cy = ky + rh * 0.5
        y0 = jnp.floor(cy - (wsize - 1) / 2.0).astype(jnp.int32)
        x0 = jnp.floor(cx - (wsize - 1) / 2.0).astype(jnp.int32)
        y0 = jnp.clip(y0, 0, max(height - wsize, 0))
        x0 = jnp.clip(x0, 0, max(width - wsize, 0))
        gwin = jax.lax.dynamic_slice(grad, (y0, x0), (wsize, wsize))
        rwin = jax.lax.dynamic_slice(rot, (y0, x0), (wsize, wsize))
        return _descriptor_rect_one(kx, ky, rw, rh, gwin, rwin,
                                    x0.astype(jnp.float32),
                                    y0.astype(jnp.float32),
                                    width, height)

    desc = jax.vmap(per_kp)(x, y, rect_w, rect_h)
    desc = jnp.where(kvalid[:, None], desc, 0.0)
    if half_sift:
        d = desc.reshape(-1, 16, 8)
        desc = (d[..., :4] + d[..., 4:]).reshape(-1, 64)
    if normalize:
        desc = normalize_descriptors(desc, kvalid)
    return desc


def compute_descriptors_flat(
    x, y, sigma, theta, kvalid, level_id,
    flat_grad: jnp.ndarray, flat_rot: jnp.ndarray,
    level_base, level_h, level_w,
    wsize: int,
    window_factor: float = 3.0,
    half_sift: bool = False,
    normalize: bool = True,
    chunk: int = 256,
) -> jnp.ndarray:
    """Cross-level descriptor pass: one call for ALL keypoints.

    Same math as compute_descriptors, gathering each keypoint's window from
    the flattened pyramid via its level geometry. Returns (G, 128)/(G, 64).
    """
    from .gather import window_gather

    K = x.shape[0]

    def per_kp(kx, ky, ks, kt, lid):
        base = level_base[lid]
        h = level_h[lid]
        w = level_w[lid]
        gwin, y0, x0 = window_gather(flat_grad, base, h, w, ky, kx, wsize)
        rwin, _, _ = window_gather(flat_rot, base, h, w, ky, kx, wsize)
        return _descriptor_one(kx, ky, ks, kt, gwin, rwin,
                               x0.astype(jnp.float32), y0.astype(jnp.float32),
                               w.astype(jnp.float32), h.astype(jnp.float32),
                               window_factor)

    if K <= chunk:
        desc = jax.vmap(per_kp)(x, y, sigma, theta, level_id)
    else:
        pad = (-K) % chunk
        xs = [jnp.pad(a, (0, pad)) for a in (x, y, sigma, theta)]
        xs.append(jnp.pad(level_id, (0, pad)))
        xs = [a.reshape(-1, chunk) for a in xs]
        desc = jax.lax.map(lambda t: jax.vmap(per_kp)(*t), tuple(xs))
        desc = desc.reshape(-1, 128)[:K]

    desc = jnp.where(kvalid[:, None], desc, 0.0)
    if half_sift:
        d = desc.reshape(-1, 16, 8)
        desc = (d[..., :4] + d[..., 4:]).reshape(-1, 64)
    if normalize:
        desc = normalize_descriptors(desc, kvalid)
    return desc


def normalize_descriptors(desc: jnp.ndarray, kvalid=None) -> jnp.ndarray:
    """L2-normalize -> clamp at 0.2 -> renormalize (ProgramCU.cu:1983-2008)."""
    eps = 1e-12
    n1 = jax.lax.rsqrt(jnp.sum(desc * desc, axis=-1, keepdims=True) + eps)
    d = jnp.minimum(0.2, desc * n1)
    n2 = jax.lax.rsqrt(jnp.sum(d * d, axis=-1, keepdims=True) + eps)
    out = d * n2
    if kvalid is not None:
        out = jnp.where(kvalid[:, None], out, 0.0)
    return out
