"""Per-keypoint orientation assignment: 36-bin gradient histograms.

Vectorized equivalent of ComputeOrientation_Kernel
(ProgramCU.cu:1221-1645). The CUDA kernel walks a per-keypoint dynamic
window; here every keypoint gathers a static, level-sized window (vmapped
dynamic slices) and invalid pixels are masked - identical vote sets.

Semantics preserved:
  * window radius win = |sigma| * (OrientationGaussianFactor *
    OrientationWindowFactor), Gaussian weight exp(-0.5 d^2 / (1.5 sigma)^2),
    vote cut at squared distance win^2 + 0.5 (ProgramCU.cu:1324-1361).
  * pixel range [max(1.5, floor(p-win)+0.5), min(dim-1.5, floor(p+win)+0.5)]
    - i.e. integer pixels floor(p-win)..floor(p+win) clamped to [1, dim-2].
  * 6 rounds of circular [1/3 1/3 1/3] smoothing (ProgramCU.cu:1363-1379).
  * half-SIFT folds bins 18..35 into 0..17 (ProgramCU.cu:1383-1392).
  * single-orientation path: first-max argmax + parabolic refinement
    (ProgramCU.cu:1398-1419), full-precision theta.
  * multi-orientation path: up to 4 strict local maxima >= 0.8*max, sorted by
    vote (stable), each quantized to 8 bits: theta = floor(frac*255) * 2pi/255
    (ProgramCU.cu:1424-1489 + ReshapeFeatureListCPU PyramidCU.cpp:764-791).
    A keypoint whose histogram has no strict local max yields zero
    orientations and is dropped - reference behavior.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

TWO_PI = 6.283185307179586
BINS_PER_RADIAN = 36.0 / TWO_PI  # 5.729577951308232


class OrientationResult(NamedTuple):
    thetas: jnp.ndarray  # f32 (K, 4) device-frame orientations
    valid: jnp.ndarray   # bool (K, 4)


def _gather_window(img: jnp.ndarray, y0: jnp.ndarray, x0: jnp.ndarray, wsize: int):
    """Dynamic (wsize, wsize) window starting at integer (y0, x0), clamped."""
    h, w = img.shape
    y0 = jnp.clip(y0, 0, max(h - wsize, 0))
    x0 = jnp.clip(x0, 0, max(w - wsize, 0))
    return jax.lax.dynamic_slice(img, (y0, x0), (wsize, wsize))


def _histogram36(kx, ky, sigma, grad_win, rot_win, x0, y0, wsize, width, height,
                 gaussian_factor, window_factor):
    """36-bin weighted orientation histogram for one keypoint."""
    gsigma = sigma * gaussian_factor
    win = jnp.abs(sigma) * (gaussian_factor * window_factor)
    dist_threshold = win * win + 0.5
    factor = -0.5 / (gsigma * gsigma)

    iy = y0 + jnp.arange(wsize, dtype=jnp.float32).reshape(-1, 1)
    ix = x0 + jnp.arange(wsize, dtype=jnp.float32).reshape(1, -1)
    px = ix + 0.5  # pixel centers
    py = iy + 0.5

    dx = px - kx
    dy = py - ky
    sq = dx * dx + dy * dy

    in_range = (
        (ix >= jnp.maximum(1.0, jnp.floor(kx - win)))
        & (ix <= jnp.minimum(width - 2.0, jnp.floor(kx + win)))
        & (iy >= jnp.maximum(1.0, jnp.floor(ky - win)))
        & (iy <= jnp.minimum(height - 2.0, jnp.floor(ky + win)))
        & (sq < dist_threshold)
    )

    obin = jnp.floor(rot_win * BINS_PER_RADIAN).astype(jnp.int32)
    obin = jnp.where(obin < 0, obin + 36, obin)
    obin = jnp.clip(obin, 0, 35)
    weight = jnp.where(in_range, grad_win * jnp.exp(sq * factor), 0.0)

    onehot = (obin.reshape(-1, 1) == jnp.arange(36).reshape(1, -1))
    return jnp.sum(weight.reshape(-1, 1) * onehot, axis=0)


def _smooth6(votes: jnp.ndarray) -> jnp.ndarray:
    for _ in range(6):
        votes = (jnp.roll(votes, 1) + votes + jnp.roll(votes, -1)) / 3.0
    return votes


def _single_peak(votes: jnp.ndarray) -> jnp.ndarray:
    """First-max argmax + parabolic refinement -> theta in radians."""
    imax = jnp.argmax(votes)  # ties: lowest index, same as reference
    vmax = votes[imax]
    pre = votes[(imax - 1) % 36]
    nxt = votes[(imax + 1) % 36]
    off = 0.5 * (nxt - pre) / (vmax + vmax - nxt - pre)
    return (imax.astype(jnp.float32) + 0.5 + off) / BINS_PER_RADIAN


def _multi_peaks(votes: jnp.ndarray, peak_threshold: float, max_peaks: int):
    """Up to max_peaks strict local maxima above threshold*max, by vote desc.

    Returns (thetas (4,), valid (4,)); 8-bit quantized like the reference.
    """
    pre = jnp.roll(votes, 1)
    nxt = jnp.roll(votes, -1)
    vmax = jnp.max(votes)
    is_peak = (votes > peak_threshold * vmax) & (votes > pre) & (votes > nxt)

    score = jnp.where(is_peak, votes, -jnp.inf)
    top_v, top_i = jax.lax.top_k(score, 4)
    valid = jnp.isfinite(top_v)
    if max_peaks < 4:
        valid = valid & (jnp.arange(4) < max_peaks)

    prei = pre[top_i]
    nxti = nxt[top_i]
    vi = votes[top_i]
    di = 0.5 * (nxti - prei) / (vi + vi - nxti - prei)
    rot = top_i.astype(jnp.float32) + di + 0.5  # in bins

    frac = rot / 36.0
    frac = jnp.where(frac < 0, frac + 1.0, frac)
    q = jnp.floor(frac * 255.0)
    thetas = q * (TWO_PI / 255.0)
    return jnp.where(valid, thetas, 0.0), valid


def compute_orientations(
    x: jnp.ndarray, y: jnp.ndarray, sigma: jnp.ndarray, kvalid: jnp.ndarray,
    grad: jnp.ndarray, rot: jnp.ndarray,
    wsize: int,
    num_orientations: int = 2,
    gaussian_factor: float = 1.5,
    window_factor: float = 2.0,
    peak_threshold: float = 0.8,
    half_sift: bool = False,
    max_peaks: int = 4,
    single: bool = False,
) -> OrientationResult:
    """Assign orientations to a level's keypoint list.

    x, y, sigma, kvalid: (K,) keypoint list in level coordinates.
    grad, rot: (H, W) gradient magnitude / orientation for this level.
    wsize: static window size >= 2*ceil(max win)+1 for this level.
    single: force single-orientation path (existing keypoints / -m 1).
    """
    height, width = grad.shape
    wsize = min(wsize, height, width)  # tiny octaves: window = whole image

    def per_kp(kx, ky, ks):
        y0 = jnp.floor(ky - (wsize - 1) / 2.0).astype(jnp.int32)
        x0 = jnp.floor(kx - (wsize - 1) / 2.0).astype(jnp.int32)
        h, w = grad.shape
        y0 = jnp.clip(y0, 0, max(h - wsize, 0))
        x0 = jnp.clip(x0, 0, max(w - wsize, 0))
        gwin = jax.lax.dynamic_slice(grad, (y0, x0), (wsize, wsize))
        rwin = jax.lax.dynamic_slice(rot, (y0, x0), (wsize, wsize))
        votes = _histogram36(kx, ky, ks, gwin, rwin,
                             x0.astype(jnp.float32), y0.astype(jnp.float32),
                             wsize, width, height, gaussian_factor, window_factor)
        votes = _smooth6(votes)
        if half_sift:
            votes = votes.at[:18].add(votes[18:]).at[18:].set(0.0)
        if single or num_orientations <= 1:
            theta = _single_peak(votes)
            thetas = jnp.stack([theta, 0.0, 0.0, 0.0])
            valid = jnp.array([True, False, False, False])
        else:
            # -m <1..4> caps peaks per keypoint (GlobalUtil._MaxOrientation,
            # consumed in ProgramCU.cu:1424-1489)
            thetas, valid = _multi_peaks(
                votes, peak_threshold, min(max_peaks, num_orientations))
        return thetas, valid

    thetas, valid = jax.vmap(per_kp)(x, y, sigma)
    valid = valid & kvalid[:, None]
    return OrientationResult(thetas=thetas, valid=valid)


def compute_orientations_flat(
    x, y, sigma, kvalid, level_id,
    flat_grad: jnp.ndarray, flat_rot: jnp.ndarray,
    level_base, level_h, level_w,
    wsize: int,
    num_orientations: int = 2,
    gaussian_factor: float = 1.5,
    window_factor: float = 2.0,
    peak_threshold: float = 0.8,
    half_sift: bool = False,
    max_peaks: int = 4,
    single: bool = False,
) -> OrientationResult:
    """Cross-level orientation pass: one call for ALL keypoints.

    x, y, sigma, kvalid, level_id: (G,) global compacted keypoint table
    (level coordinates). flat_grad/flat_rot: flattened pyramid buffers;
    level_base/h/w: (L,) per-level geometry (i32).
    """
    from .gather import window_gather

    def per_kp(kx, ky, ks, lid):
        base = level_base[lid]
        h = level_h[lid]
        w = level_w[lid]
        gwin, y0, x0 = window_gather(flat_grad, base, h, w, ky, kx, wsize)
        rwin, _, _ = window_gather(flat_rot, base, h, w, ky, kx, wsize)
        votes = _histogram36(kx, ky, ks, gwin, rwin,
                             x0.astype(jnp.float32), y0.astype(jnp.float32),
                             wsize, w.astype(jnp.float32),
                             h.astype(jnp.float32),
                             gaussian_factor, window_factor)
        votes = _smooth6(votes)
        if half_sift:
            votes = votes.at[:18].add(votes[18:]).at[18:].set(0.0)
        if single or num_orientations <= 1:
            theta = _single_peak(votes)
            thetas = jnp.stack([theta, 0.0, 0.0, 0.0])
            valid = jnp.array([True, False, False, False])
        else:
            thetas, valid = _multi_peaks(
                votes, peak_threshold, min(max_peaks, num_orientations))
        return thetas, valid

    thetas, valid = jax.vmap(per_kp)(x, y, sigma, level_id)
    valid = valid & kvalid[:, None]
    return OrientationResult(thetas=thetas, valid=valid)
