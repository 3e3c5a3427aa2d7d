"""Fused det-of-Hessian response + gradient/orientation stencil.

Equivalent of ComputeHessian_Kernel (ProgramCU.cu:518-595) and
ComputeDOG_Kernel (ProgramCU.cu:599-653). One vectorized pass over a whole
(num_levels, H, W) Gaussian stack produces:
  * response: det(Hessian) * sigma^4 per level (or DoG for the "dog" mode)
  * gradient magnitude 0.5*|grad| and orientation atan2(dy, dx)

Boundary semantics: the CUDA kernel reads out-of-row neighbours through a
linear texture (wrapping within the flat buffer) but the detector never
accepts border keypoints, and orientation/descriptor windows are clamped to
[1.5, dim-1.5], so replicate-padding here is behavior-equivalent.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp


def _shift(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """x shifted so result[r, c] = x[r + dy, c + dx], replicated at edges.

    x: (..., H, W). Implemented as one edge-pad + a static slice so XLA can
    fuse the slice into consumers (concatenate-based shifts materialize a
    copy per neighbor).
    """
    h, w = x.shape[-2], x.shape[-1]
    py = abs(dy)
    px = abs(dx)
    if not py and not px:
        return x
    pad = [(0, 0)] * (x.ndim - 2) + [(py, py), (px, px)]
    xp = jnp.pad(x, pad, mode="edge")
    return xp[..., py + dy: py + dy + h, px + dx: px + dx + w]


def hessian_response_and_gradient(
    gauss: jnp.ndarray, norms: Sequence[float],
    grad_levels: Sequence[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Compute per-level normalized det-of-Hessian response and gradients.

    gauss: (L, H, W) Gaussian stack.
    norms: per-level normalization = level_sigma^4 (the reference passes
           sigma^2 and squares it in the kernel, ProgramCU.cu:592).
    grad_levels: level indices needing gradient/orientation maps (the
    expensive sqrt/atan2); None = all. Other levels get zero maps.
    Returns (response, grad_mag, grad_rot), each (L, H, W).
    """
    v12 = _shift(gauss, -1, 0)   # row above
    v32 = _shift(gauss, 1, 0)    # row below
    v21 = _shift(gauss, 0, -1)   # left
    v23 = _shift(gauss, 0, 1)    # right
    v11 = _shift(gauss, -1, -1)
    v13 = _shift(gauss, -1, 1)
    v31 = _shift(gauss, 1, -1)
    v33 = _shift(gauss, 1, 1)

    lxx = v21 - 2.0 * gauss + v23
    lyy = v12 - 2.0 * gauss + v32
    lxy = (v13 - v11 + v31 - v33) * 0.25

    norm = jnp.asarray(list(norms), dtype=gauss.dtype).reshape(-1, 1, 1)
    response = (lxx * lyy - lxy * lxy) * norm

    L = gauss.shape[0]
    levels = set(range(L)) if grad_levels is None \
        else {int(l) for l in grad_levels}
    zeros = jnp.zeros_like(gauss[0])
    grads, rots = [], []
    for l in range(L):
        if l in levels:
            dx = v23[l] - v21[l]
            dy = v32[l] - v12[l]
            g = 0.5 * jnp.sqrt(dx * dx + dy * dy)
            grads.append(g)
            rots.append(jnp.where(g == 0.0, 0.0, jnp.arctan2(dy, dx)))
        else:
            grads.append(zeros)
            rots.append(zeros)
    return response, jnp.stack(grads), jnp.stack(rots)


def dog_response_and_gradient(
    gauss: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """DoG personality: response[l] = gauss[l+1] - gauss[l]; gradients from
    gauss[l+1] (reference ComputeDOG_Kernel, ProgramCU.cu:599-653).

    gauss: (L, H, W); returns (L-1, H, W) arrays.
    """
    cur = gauss[1:]
    dog = cur - gauss[:-1]
    dx = _shift(cur, 0, 1) - _shift(cur, 0, -1)
    dy = _shift(cur, 1, 0) - _shift(cur, -1, 0)
    grad = 0.5 * jnp.sqrt(dx * dx + dy * dy)
    rot = jnp.where(grad == 0.0, 0.0, jnp.arctan2(dy, dx))
    return dog, grad, rot
