"""Keypoint test: threshold, 3x3x3 NMS, edge rejection, subpixel refinement,
and blob-type classification.

Vectorized equivalent of ComputeKEY_Kernel (ProgramCU.cu:657-920). The
CUDA kernel runs per pixel with early-outs; here every test is evaluated for
all pixels and combined with masks — the natural formulation for a vector
machine, with identical accept/reject semantics:

  * |response| must exceed 0.8*T when subpixel localization is on (T else)
    (Tdog1, ProgramCU.cu:897).
  * maxima: strictly greater than left/right neighbours, >= the remaining 24
    neighbours of the 3x3x3 cube, and (Hessian personality) response > 0;
    minima symmetrically with response < 0 (READ_CMP_DOG_DATA,
    ProgramCU.cu:659-700 - note the first comparison is strict, later ones
    allow ties).
  * edge rejection via the 2x2 Hessian of the response map:
    det <= 0 or trace^2 > ((e+1)^2/e) * det rejects (ProgramCU.cu:748-757).
  * subpixel: 3-variable Newton step solved by Gaussian elimination with the
    reference's exact pivoting order (ProgramCU.cu:769-825); the refined
    response must exceed T and |dx|,|dy|,|ds| < 1. Degenerate pivots accept
    the unrefined keypoint with zero offset - same as the reference.
  * type: saddle if response < 0, else dark/bright blob by the sign of Lxx of
    the *Gaussian* image (ProgramCU.cu:827-851).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .hessian import _shift

# Feature types (reference config.h:46-49)
TYPE_DARK_BLOB = 0
TYPE_BRIGHT_BLOB = 1
TYPE_SADDLE = 2
TYPE_NONE = 3


class KeypointMaps(NamedTuple):
    """Dense per-pixel detection results for one level ("key map")."""
    valid: jnp.ndarray      # bool (H, W)
    response: jnp.ndarray   # f32 (H, W) refined response
    dx: jnp.ndarray         # f32 subpixel offsets
    dy: jnp.ndarray
    ds: jnp.ndarray
    ftype: jnp.ndarray      # i32 feature type (TYPE_*)


def _solve3_pivoted(a0, a1, a2):
    """Symmetric 3x3 solve A x = w by adjugate (Cramer).

    Each a* is a tuple of 4 same-shaped arrays (row coefficients + rhs).
    Both call sites pass the symmetric scale-space Hessian system
    (a1[0] is a0[1], a2[0] is a0[2], a2[1] is a1[2]), so the adjugate
    form applies and needs ~half the vector ops of the reference's
    pivoted elimination (ProgramCU.cu:784-824) - the dominant VPU cost
    of the fused detect kernel. The solution is algebraically identical;
    for well-conditioned systems f32 rounding differs from the
    elimination path only in the last bits, far below the q14 offset /
    f16 response quantization the payloads apply.

    Near-singular behavior deliberately differs from the reference's
    pivoted elimination: the reference floors each PIVOT at 1e-10, so an
    ill-conditioned-but-nonzero system is classified degenerate and the
    keypoint is accepted UNREFINED, while this solve still inverts it
    and the resulting huge offsets fail the |dx|,|dy|,|ds| < 1 gate
    downstream - the keypoint is REJECTED. Both policies are arbitrary
    there (the quadratic model is meaningless for such pixels); none of
    the data/ images exercise the gap (feature parity is exact on the
    golden tests), so membership can differ from the reference only at
    near-singular saddle ridges. Returns
    (ok, dx, dy, ds): ok=False marks degenerate
    systems (|det| < 1e-30) - those pixels are accepted unrefined.
    """
    a, b, c, r0 = a0
    d, e, r1 = a1[1], a1[2], a1[3]
    f, r2 = a2[2], a2[3]
    C00 = d * f - e * e
    C01 = c * e - b * f
    C02 = b * e - c * d
    det = a * C00 + b * C01 + c * C02
    ok = jnp.abs(det) >= 1e-30
    rdet = 1.0 / jnp.where(ok, det, 1.0)
    # scale the rhs once instead of each solution: same op count, and
    # det/rdet and each cofactor die as soon as their dot is formed
    s0 = r0 * rdet
    s1 = r1 * rdet
    s2 = r2 * rdet
    dx = C00 * s0 + C01 * s1 + C02 * s2
    C11 = a * f - c * c
    C12 = b * c - a * e
    dy = C01 * s0 + C11 * s1 + C12 * s2
    C22 = a * d - b * b
    ds = C02 * s0 + C12 * s1 + C22 * s2
    zero = jnp.zeros_like(ds)
    return ok, jnp.where(ok, dx, zero), jnp.where(ok, dy, zero), \
        jnp.where(ok, ds, zero)


def detect_keypoints_level(
    resp_prev: jnp.ndarray,
    resp_cur: jnp.ndarray,
    resp_next: jnp.ndarray,
    gauss_cur: jnp.ndarray,
    threshold: float,
    edge_threshold: float,
    subpixel: bool = True,
    hessian: bool = True,
    darkness_adaption: bool = False,
) -> KeypointMaps:
    """Run the keypoint test on one detection level. All inputs (H, W).

    darkness_adaption scales the threshold per pixel by
    min(2*intensity + 0.1, 1) so dark regions keep weaker keypoints
    (reference -da flag, GLSL shader ProgramGLSL.cpp:835-839).
    """
    h, w = resp_cur.shape
    v = resp_cur
    if darkness_adaption:
        threshold = threshold * jnp.minimum(2.0 * gauss_cur + 0.1, 1.0)
    thr0 = (0.8 if subpixel else 1.0) * threshold

    # --- 3x3x3 neighbourhoods -------------------------------------------------
    def ring(x):
        """8 in-plane neighbours of x."""
        return [
            _shift(x, -1, -1), _shift(x, -1, 0), _shift(x, -1, 1),
            _shift(x, 0, -1), _shift(x, 0, 1),
            _shift(x, 1, -1), _shift(x, 1, 0), _shift(x, 1, 1),
        ]

    left = _shift(v, 0, -1)
    right = _shift(v, 0, 1)
    up = _shift(v, -1, 0)
    down = _shift(v, 1, 0)
    tl = _shift(v, -1, -1)
    tr = _shift(v, -1, 1)
    bl = _shift(v, 1, -1)
    br = _shift(v, 1, 1)

    rest = [up, down, tl, tr, bl, br]
    rest += ring(resp_prev) + [resp_prev]
    rest += ring(resp_next) + [resp_next]
    rest_max = rest[0]
    rest_min = rest[0]
    for x in rest[1:]:
        rest_max = jnp.maximum(rest_max, x)
        rest_min = jnp.minimum(rest_min, x)

    lr_max = jnp.maximum(left, right)
    lr_min = jnp.minimum(left, right)

    is_max = (v > lr_max) & (v >= rest_max)
    is_min = (v < lr_min) & (v <= rest_min)
    if hessian:
        # Hessian extrema must be sign-consistent (ProgramCU.cu:663-677)
        is_max &= v >= 0
        is_min &= v <= 0
    extremum = (jnp.abs(v) > thr0) & (is_max | is_min)

    # --- edge rejection on the response map ------------------------------------
    fx = 0.5 * (right - left)
    fy = 0.5 * (down - up)
    vx2 = 2.0 * v
    fxx = left + right - vx2
    fyy = up + down - vx2
    fxy = 0.25 * (br + tl - bl - tr)
    det2 = fxx * fyy - fxy * fxy
    tr2 = (fxx + fyy) ** 2
    te = (edge_threshold + 1.0) ** 2 / edge_threshold
    not_edge = (det2 > 0) & (tr2 <= te * det2)
    extremum &= not_edge

    # --- subpixel refinement ---------------------------------------------------
    if subpixel:
        cn = resp_next
        cp = resp_prev
        fs = 0.5 * (cn - cp)
        fss = cn + cp - vx2
        fxs = 0.25 * (_shift(cn, 0, 1) + _shift(cp, 0, -1)
                      - _shift(cn, 0, -1) - _shift(cp, 0, 1))
        fys = 0.25 * (_shift(cn, 1, 0) + _shift(cp, -1, 0)
                      - _shift(cn, -1, 0) - _shift(cp, 1, 0))

        ok, dx, dy, ds = _solve3_pivoted(
            (fxx, fxy, fxs, -fx),
            (fxy, fyy, fys, -fy),
            (fxs, fys, fss, -fs),
        )
        refined = v + 0.5 * (dx * fx + dy * fy + ds * fs)
        response = jnp.where(ok, refined, v)
        offset_ok = jnp.where(
            ok,
            (jnp.abs(response) > threshold)
            & (jnp.abs(ds) < 1.0) & (jnp.abs(dx) < 1.0) & (jnp.abs(dy) < 1.0),
            True,  # degenerate solve: accept unrefined (reference behavior)
        )
        extremum &= offset_ok
    else:
        dx = dy = ds = jnp.zeros_like(v)
        response = v

    # --- interior-only (row/col in [1, dim-2]) ---------------------------------
    rows = jnp.arange(h).reshape(-1, 1)
    cols = jnp.arange(w).reshape(1, -1)
    interior = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
    valid = extremum & interior

    # --- blob type -------------------------------------------------------------
    if hessian:
        # saddle if response < 0, else dark/bright by Lxx of the Gaussian
        # image (ProgramCU.cu:827-851)
        g_lxx = (_shift(gauss_cur, 0, -1) - 2.0 * gauss_cur
                 + _shift(gauss_cur, 0, 1))
        blob_type = jnp.where(g_lxx > 0, TYPE_DARK_BLOB, TYPE_BRIGHT_BLOB)
        ftype = jnp.where(response < 0, TYPE_SADDLE, blob_type)
    else:
        # DoG personality: maxima are bright blobs, minima dark
        # (GPU_SIFT_MODIFIED branch, ProgramCU.cu:852-853)
        ftype = jnp.where(is_max, TYPE_BRIGHT_BLOB, TYPE_DARK_BLOB)
    ftype = jnp.where(valid, ftype, TYPE_NONE).astype(jnp.int32)

    # Match the reference's half-precision response storage (the key map packs
    # the response as fp16, ProgramCU.cu:865; downstream top-K and file output
    # see this quantized value).
    response = response.astype(jnp.float16).astype(jnp.float32)

    return KeypointMaps(valid=valid, response=jnp.where(valid, response, 0.0),
                        dx=dx, dy=dy, ds=ds, ftype=ftype)
