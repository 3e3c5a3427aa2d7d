"""Image resampling and input conversion ops.

Equivalents of the reference's sampling kernels:
  * DownsampleKernel / SampleImageD (ProgramCU.cu:312-367): decimation by
    2^k taking every 2^k-th pixel starting at (0, 0).
  * UpsampleKernel / SampleImageU (ProgramCU.cu:233-310): bilinear x2^k
    upsample (used for first_octave < 0; the Hessian personality restricts
    first_octave >= 0, SiftGPU.cpp:1166-1170).
  * ChannelReduce / ConvertByteToFloat (ProgramCU.cu:369-421): RGB(A) ->
    luminance with BT.601 weights and u8 -> f32 scaling.
"""

from __future__ import annotations

import jax.numpy as jnp

# BT.601 luminance weights (reference ProgramCU.cu:381 and
# GLTexImage.cpp DownSamplePixelData*: 0.299 R + 0.587 G + 0.114 B)
_LUMA = (0.299, 0.587, 0.114)


def downsample(x: jnp.ndarray, log_scale: int = 1) -> jnp.ndarray:
    """Decimate (H, W) by 2**log_scale, keeping pixels at multiples of the
    step. A strided slice: XLA fuses it into its consumer."""
    s = 1 << log_scale
    return x[..., ::s, ::s]


def upsample(x: jnp.ndarray, log_scale: int = 1) -> jnp.ndarray:
    """Bilinear upsample by 2**log_scale (for negative first octave).

    Corner-aligned like the reference UpsampleKernel
    (ProgramCU.cu:233-310): dst pixel (2r, 2c) copies src (r, c) exactly
    and odd rows/cols are midpoint blends (src = dst / 2, clamped at the
    edges). jax.image.resize's bilinear uses the half-pixel convention
    (src = dst / 2 - 0.25), which shifted every feature derived from the
    upsampled octave by a constant +0.25 px vs the reference's golden
    output (measured on doc/evaluation/box.siftgpu).
    """
    for _ in range(log_scale):
        h, w = x.shape[-2], x.shape[-1]
        r = jnp.concatenate([x[..., :, 1:], x[..., :, -1:]], axis=-1)
        d = jnp.concatenate([x[..., 1:, :], x[..., -1:, :]], axis=-2)
        dr = jnp.concatenate([d[..., :, 1:], d[..., :, -1:]], axis=-1)
        top = jnp.stack([x, 0.5 * (x + r)],
                        axis=-1).reshape(*x.shape[:-2], h, 2 * w)
        bot = jnp.stack([0.5 * (x + d), 0.25 * (x + r + d + dr)],
                        axis=-1).reshape(*x.shape[:-2], h, 2 * w)
        x = jnp.stack([top, bot], axis=-2).reshape(
            *x.shape[:-2], 2 * h, 2 * w)
    return x


def rgb_to_gray(x: jnp.ndarray) -> jnp.ndarray:
    """(H, W, 3|4) -> (H, W) luminance."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b


def to_float(x: jnp.ndarray) -> jnp.ndarray:
    """u8 [0,255] -> f32 [0,1]; float input passed through as f32."""
    if x.dtype == jnp.uint8:
        return x.astype(jnp.float32) / 255.0
    return x.astype(jnp.float32)
