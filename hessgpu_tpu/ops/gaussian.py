"""Separable Gaussian filtering and pyramid construction.

Equivalent of the reference's FilterH/FilterV CUDA kernels
(ProgramCU.cu:117-512): separable 1-D convolution with clamp-to-edge
boundaries and per-level tap widths. Tap vectors are Python-time constants
baked into the trace, and XLA compiles the convolutions for the device
(cuDNN or its own generated kernels on a GPU).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..params import ScaleSpaceParams, gaussian_taps


def conv1d_clamped(x: jnp.ndarray, taps: Sequence[float], axis: int) -> jnp.ndarray:
    """1-D convolution along `axis` with clamp-to-edge padding.

    Matches the reference filter kernels' boundary handling
    (ProgramCU.cu:117-231: indices clamped to the row/column range).
    x: (..., H, W) float array.
    """
    taps = np.asarray(taps, dtype=np.float32)
    r = len(taps) // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = jnp.pad(x, pad, mode="edge")
    return conv1d_valid(xp, taps, axis)


def conv1d_valid(x: jnp.ndarray, taps: Sequence[float], axis: int) -> jnp.ndarray:
    """1-D VALID convolution along `axis` (output shrinks by len(taps)-1).

    Callers that need custom boundary rows (e.g. the spatially sharded
    pipeline's halo exchange, parallel/spatial.py) concatenate them and use
    this so each output element is the exact same XLA conv reduction as
    conv1d_clamped - results stay bit-identical to the single-chip path.
    """
    taps = np.asarray(taps, dtype=np.float32)
    # XLA's native convolution: reshape to NCHW with a single channel.
    shape = x.shape
    batch = int(np.prod(shape[:-2])) if x.ndim > 2 else 1
    xp4 = x.reshape((batch, 1) + shape[-2:])
    if axis % x.ndim == x.ndim - 1:
        rhs = jnp.asarray(taps).reshape(1, 1, 1, len(taps))
        out_hw = (shape[-2], shape[-1] - len(taps) + 1)
    else:
        rhs = jnp.asarray(taps).reshape(1, 1, len(taps), 1)
        out_hw = (shape[-2] - len(taps) + 1, shape[-1])
    out = jax.lax.conv_general_dilated(
        xp4, rhs,
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape(shape[:-2] + out_hw)


def blur(x: jnp.ndarray, sigma: float, filter_width_factor: float = 4.0) -> jnp.ndarray:
    """Separable Gaussian blur of a single image (H, W)."""
    if sigma <= 0.0:
        return x
    taps = gaussian_taps(sigma, filter_width_factor)
    x = conv1d_clamped(x, taps, axis=x.ndim - 1)
    x = conv1d_clamped(x, taps, axis=x.ndim - 2)
    return x


def build_octave_chain(base: jnp.ndarray, params: ScaleSpaceParams) -> jnp.ndarray:
    """Build one octave's Gaussian stack by chained incremental blurs.

    Reference behavior (PyramidCU::BuildPyramid, PyramidCU.cpp:1542-1548):
    level i+1 = blur(level i, incremental_sigma[i]).
    base: (H, W) already blurred to level_min.
    Returns (num_levels, H, W).
    """
    levels = [base]
    for s in params.incremental_sigmas():
        levels.append(blur(levels[-1], s, params.filter_width_factor))
    # axis -3 keeps an optional leading batch dim in front of the levels
    return jnp.stack(levels, axis=-3)


def build_octave_direct(base: jnp.ndarray, params: ScaleSpaceParams) -> jnp.ndarray:
    """Build one octave's Gaussian stack with independent blurs from the base.

    TPU-friendly alternative to the sequential chain: every level is computed
    directly from the octave base with the combined sigma, so all levels'
    convolutions are independent and can be batched. Numerically close to
    (not bit-identical with) the chained reference schedule.
    """
    sigmas = params.direct_sigmas()
    max_taps = max(
        len(gaussian_taps(s, params.filter_width_factor)) if s > 0 else 1
        for s in sigmas
    )
    # Pad every level's taps to a common width so the per-level convolutions
    # batch into one grouped convolution.
    taps_mat = np.zeros((len(sigmas), max_taps), dtype=np.float32)
    for i, s in enumerate(sigmas):
        if s <= 0:
            taps_mat[i, max_taps // 2] = 1.0
        else:
            t = gaussian_taps(s, params.filter_width_factor)
            off = (max_taps - len(t)) // 2
            taps_mat[i, off:off + len(t)] = t

    r = max_taps // 2
    h, w = base.shape
    nlev = len(sigmas)
    xp = jnp.pad(base, ((r, r), (r, r)), mode="edge")
    x4 = jnp.broadcast_to(xp, (1, nlev) + xp.shape)

    rhs_h = jnp.asarray(taps_mat).reshape(nlev, 1, 1, max_taps)
    out = jax.lax.conv_general_dilated(
        x4, rhs_h, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=nlev,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    rhs_v = jnp.asarray(taps_mat).reshape(nlev, 1, max_taps, 1)
    out = jax.lax.conv_general_dilated(
        out, rhs_v, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=nlev,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape(nlev, h, w)
