"""Cross-level window gathers from flattened pyramid buffers.

The answer here to per-keypoint windows that live on different pyramid
levels: all levels' gradient/rotation maps are concatenated into one flat
buffer; each keypoint carries its level's (base offset, height, width) and
gathers a static-size window with one vectorized `take`. This lets a single
orientation/descriptor pass process every keypoint of every octave at once -
the work scales with the number of real features, not with the per-level
capacity grid (compare the reference's per-(octave,level) kernel launches,
PyramidCU.cpp:1815-1857).
"""

from __future__ import annotations

import jax.numpy as jnp


def window_gather(flat: jnp.ndarray, base, h, w, ky, kx, wsize: int):
    """Gather a (wsize, wsize) window around (ky, kx) from a flat level.

    flat: (T,) flattened concatenation of level images.
    base, h, w: scalars (traced) - the keypoint's level geometry.
    ky, kx: float center; the window starts at floor(k) - (wsize-1)//2.
    Returns (window, y0, x0) where y0/x0 are the *unclamped* integer window
    origins (absolute level coordinates - masks downstream use these).
    Out-of-image indices clamp to the border pixel; callers mask them out.
    """
    r = (wsize - 1) // 2
    y0 = jnp.floor(ky).astype(jnp.int32) - r
    x0 = jnp.floor(kx).astype(jnp.int32) - r
    ys = jnp.clip(y0 + jnp.arange(wsize).reshape(-1, 1), 0, h - 1)
    xs = jnp.clip(x0 + jnp.arange(wsize).reshape(1, -1), 0, w - 1)
    idx = base + ys * w + xs
    return jnp.take(flat, idx, axis=0), y0, x0
