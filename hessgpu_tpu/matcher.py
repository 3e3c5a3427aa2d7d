"""Descriptor matching as one matrix product.

Equivalent of SiftMatchGPU/SiftMatchCU (reference
SiftMatch.{h,cpp}, SiftMatchCU.{h,cpp}, matcher kernels
ProgramCU.cu:3446-3843). The reference's hand-tiled u8 dot-product kernel +
row/col argmax reductions become one matmul and two argmax/masks:

  * descriptors are quantized u8 = int(512*d + 0.5) (SiftMatchCU.cpp:87-101);
    the integer dot matrix is computed exactly in bf16xbf16->f32
    (u8 values and 128-term dot products are exactly representable).
  * distance is angular: acos(dot / 512^2) (ProgramCU.cu:3790, constant
    0.000003814697265625 = 1/512^2).
  * row i matches col j iff j = argmax_j dot, acos < distmax, and
    acos < ratiomax * acos(second best) (ProgramCU.cu:3790-3793).
  * mutual-best check intersects row and column winners
    (SiftMatchCU.cpp:148-173).
  * guided matching gates pairs by homography distance and fundamental-matrix
    Sampson error before the descriptor test (ProgramCU.cu:3565-3731).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INV_512_SQ = 1.0 / (512.0 * 512.0)


def quantize_descriptors(desc: np.ndarray) -> np.ndarray:
    """float descriptors -> u8, reference quantization int(512*d + 0.5)."""
    return np.clip(np.floor(512.0 * desc + 0.5), 0, 255).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("mutual_best",))
def _match_core(d1, d2, valid1, valid2, distmax, ratiomax, mutual_best=True,
                gate=None):
    """d1 (N1, 128) u8, d2 (N2, 128) u8 -> match index per row (or -1).

    gate: optional (N1, N2) bool mask of geometrically admissible pairs.
    """
    a = d1.astype(jnp.bfloat16)
    b = d2.astype(jnp.bfloat16)
    dots = jnp.dot(a, b.T, preferred_element_type=jnp.float32)  # exact ints

    vmask = valid1[:, None] & valid2[None, :]
    if gate is not None:
        vmask = vmask & gate
    dots = jnp.where(vmask, dots, -1.0)

    def best_two(mat, axis):
        bi = jnp.argmax(mat, axis=axis)
        bv = jnp.max(mat, axis=axis)
        # second best: mask out the argmax position
        n = mat.shape[axis]
        onehot = jax.nn.one_hot(bi, n, dtype=jnp.bool_, axis=axis)
        nv = jnp.max(jnp.where(onehot, -jnp.inf, mat), axis=axis)
        return bi, bv, nv

    def accept(bv, nv):
        dist = jnp.arccos(jnp.minimum(bv * INV_512_SQ, 1.0))
        distn = jnp.arccos(jnp.clip(nv * INV_512_SQ, -1.0, 1.0))
        return (dist < distmax) & (dist < distn * ratiomax)

    ri, rv, rn = best_two(dots, axis=1)
    row_match = jnp.where(accept(rv, rn) & (rv > 0), ri, -1)

    if mutual_best:
        ci, cv, cn = best_two(dots, axis=0)
        col_match = jnp.where(accept(cv, cn) & (cv > 0), ci, -1)
        mutual = col_match[jnp.clip(row_match, 0, d2.shape[0] - 1)] == \
            jnp.arange(d1.shape[0])
        row_match = jnp.where((row_match >= 0) & mutual, row_match, -1)
    return row_match


@jax.jit
def _guided_gate(loc1, loc2, H, hdistmax, F, fdistmax):
    """Geometric admissibility mask (N1, N2).

    Homography: |H*x1 - x2|_inf-style per-coordinate test; fundamental:
    Sampson error x2'Fx1 (ProgramCU.cu:3618-3643).
    """
    ones = jnp.ones((loc1.shape[0], 1), loc1.dtype)
    x1h = jnp.concatenate([loc1, ones], axis=1)          # (N1, 3)
    hx = x1h @ H.T                                        # (N1, 3)
    hx = hx[:, :2] / hx[:, 2:3]
    dh = jnp.abs(hx[:, None, :] - loc2[None, :, :])       # (N1, N2, 2)
    hok = (dh[..., 0] < hdistmax) & (dh[..., 1] < hdistmax)

    fx1 = x1h @ F.T                                       # (N1, 3) rows F*x1
    x2h = jnp.concatenate([loc2, jnp.ones((loc2.shape[0], 1), loc2.dtype)],
                          axis=1)
    ftx2 = x2h @ F                                        # (N2, 3) F'*x2
    x2fx1 = fx1 @ x2h.T                                   # (N1, N2) x2'F x1 (transposed orientation)
    denom = (fx1[:, 0] ** 2 + fx1[:, 1] ** 2)[:, None] + \
            (ftx2[:, 0] ** 2 + ftx2[:, 1] ** 2)[None, :]
    se = (x2fx1 ** 2) / denom
    return hok & (se < fdistmax)


class SiftMatcher:
    """Pairwise descriptor matcher (reference SiftMatchGPU API surface)."""

    def __init__(self, max_sift: int = 32768):
        self.max_sift = max_sift
        self._desc = [None, None]
        self._loc = [None, None]

    # -- reference-style stateful API --------------------------------------
    def set_descriptors(self, index: int, desc: np.ndarray) -> None:
        """desc: (N, 128) float in [0,1] or uint8."""
        index = min(max(index, 0), 1)
        if desc.dtype != np.uint8:
            desc = quantize_descriptors(desc)
        self._desc[index] = desc[: self.max_sift]

    def set_feature_location(self, index: int, loc: np.ndarray) -> None:
        """loc: (N, 2) x, y positions (for guided matching)."""
        index = min(max(index, 0), 1)
        self._loc[index] = np.asarray(loc, np.float32)[: self.max_sift]

    def get_sift_match(self, distmax: float = 0.7, ratiomax: float = 0.8,
                       mutual_best: bool = True) -> np.ndarray:
        """Returns (M, 2) int array of (index1, index2) pairs."""
        return self._run(distmax, ratiomax, mutual_best, gate=None)

    def get_guided_sift_match(self, H: np.ndarray = None,
                              F: np.ndarray = None,
                              distmax: float = 0.7, ratiomax: float = 0.8,
                              hdistmax: float = 32.0, fdistmax: float = 16.0,
                              mutual_best: bool = True) -> np.ndarray:
        """Either matrix may be None to skip its gate: the reference
        substitutes identity with a 1e20 threshold (SiftMatch.cpp:663-675);
        both None degrades to plain matching."""
        if H is None and F is None:
            return self.get_sift_match(distmax, ratiomax, mutual_best)
        if H is None:
            H, hdistmax = np.eye(3, dtype=np.float32), 1.0e20
        if F is None:
            F, fdistmax = np.eye(3, dtype=np.float32), 1.0e20
        assert self._loc[0] is not None and self._loc[1] is not None, \
            "guided matching needs set_feature_location for both images"
        gate = _guided_gate(
            jnp.asarray(self._loc[0]), jnp.asarray(self._loc[1]),
            jnp.asarray(H, jnp.float32), hdistmax,
            jnp.asarray(F, jnp.float32), fdistmax)
        return self._run(distmax, ratiomax, mutual_best, gate=gate)

    def _run(self, distmax, ratiomax, mutual_best, gate) -> np.ndarray:
        d1, d2 = self._desc
        if d1 is None or d2 is None or len(d1) == 0 or len(d2) == 0:
            return np.zeros((0, 2), np.int32)
        n1, n2 = d1.shape[0], d2.shape[0]
        v1 = jnp.ones((n1,), jnp.bool_)
        v2 = jnp.ones((n2,), jnp.bool_)
        rm = _match_core(jnp.asarray(d1), jnp.asarray(d2), v1, v2,
                         distmax, ratiomax, mutual_best=mutual_best,
                         gate=gate)
        rm = np.asarray(rm)
        rows = np.nonzero(rm >= 0)[0]
        return np.stack([rows, rm[rows]], axis=1).astype(np.int32)

    # -- one-shot convenience ----------------------------------------------
    def match(self, feats1: dict, feats2: dict, **kw) -> np.ndarray:
        self.set_descriptors(0, feats1["desc"])
        self.set_descriptors(1, feats2["desc"])
        return self.get_sift_match(**kw)
