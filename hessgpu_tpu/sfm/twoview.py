"""Two-view geometry: fundamental/essential estimation, pose recovery,
triangulation.

North-star extension (SURVEY.md intro + section 7.6): the reference repo has
no SfM code; this layer is designed from scratch. Everything is
vectorized and jittable: RANSAC evaluates all hypotheses as one batched
computation (vmapped minimal solvers + one (H, N) residual matrix) instead
of the classic sequential loop.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# A GPU may run an f32 matmul in TF32 (about three decimal digits); the
# 3x3 and 9-column systems here feed SVDs and inlier thresholds, so every
# product asks for full f32, as in sfm/ba.py.
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


class TwoViewResult(NamedTuple):
    F: jnp.ndarray          # (3, 3) fundamental
    inliers: jnp.ndarray    # (N,) bool
    num_inliers: jnp.ndarray


def _normalize_points(pts):
    """Hartley normalization: zero mean, mean distance sqrt(2)."""
    mean = jnp.mean(pts, axis=0)
    centered = pts - mean
    scale = jnp.sqrt(2.0) / (jnp.mean(jnp.linalg.norm(centered, axis=1)) + 1e-12)
    T = jnp.array([[1, 0, -mean[0]], [0, 1, -mean[1]], [0, 0, 1 / scale]]) * scale
    T = jnp.stack([
        jnp.array([scale, 0.0, -scale * mean[0]]),
        jnp.array([0.0, scale, -scale * mean[1]]),
        jnp.array([0.0, 0.0, 1.0]),
    ])
    return centered * scale, T


def eight_point(p1, p2):
    """Normalized 8-point fundamental estimate from >= 8 correspondences.

    p1, p2: (M, 2). Returns (3, 3) F with rank-2 enforcement.
    """
    n1, T1 = _normalize_points(p1)
    n2, T2 = _normalize_points(p2)
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                   jnp.ones_like(x1)], axis=1)
    # F = eigenvector of A^T A with smallest eigenvalue
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[-1].reshape(3, 3)
    # rank-2 enforcement
    u, s, vt2 = jnp.linalg.svd(F)
    F = _mm(u * s.at[2].set(0.0)[None, :], vt2)
    F = _mm(_mm(T2.T, F), T1)
    return F / (F[2, 2] + jnp.where(jnp.abs(F[2, 2]) < 1e-12, 1e-12, 0.0))


def sampson_error(F, p1, p2):
    """Squared Sampson distance for each correspondence. (N,)"""
    ones = jnp.ones((p1.shape[0], 1), p1.dtype)
    x1 = jnp.concatenate([p1, ones], axis=1)
    x2 = jnp.concatenate([p2, ones], axis=1)
    Fx1 = _mm(x1, F.T)      # (N, 3)
    Ftx2 = _mm(x2, F)       # (N, 3)
    num = jnp.sum(x2 * Fx1, axis=1) ** 2
    den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
    return num / (den + 1e-12)


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
def ransac_fundamental(key, p1, p2, valid, threshold: float = 2.0,
                       num_hypotheses: int = 512) -> TwoViewResult:
    """Batched RANSAC: all hypotheses evaluated in parallel.

    p1, p2: (N, 2) matched points; valid: (N,) mask (static shape, masked
    entries never become inliers and are never sampled with weight).
    threshold: Sampson distance threshold in pixels.
    """
    n = p1.shape[0]
    nvalid = jnp.sum(valid.astype(jnp.int32))

    # sample 8-tuples among valid indices (with replacement; collisions make
    # degenerate hypotheses that simply score poorly)
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.sum(probs)
    idx = jax.random.choice(key, n, shape=(num_hypotheses, 8), p=probs)

    Fs = jax.vmap(lambda i: eight_point(p1[i], p2[i]))(idx)        # (H, 3, 3)
    errs = jax.vmap(lambda F: sampson_error(F, p1, p2))(Fs)        # (H, N)
    thr2 = threshold * threshold
    inl = (errs < thr2) & valid[None, :]
    scores = jnp.sum(inl.astype(jnp.int32), axis=1)
    best = jnp.argmax(scores)

    # refit on the best hypothesis' inliers (weighted by mask)
    best_inl = inl[best]
    Ff = _weighted_eight_point(p1, p2, best_inl.astype(jnp.float32))
    err_f = sampson_error(Ff, p1, p2)
    inl_f = (err_f < thr2) & valid
    # keep the refit only if it didn't lose inliers
    better = jnp.sum(inl_f) >= scores[best]
    F = jnp.where(better, Ff, Fs[best])
    inliers = jnp.where(better, inl_f, best_inl)
    return TwoViewResult(F=F, inliers=inliers,
                         num_inliers=jnp.sum(inliers.astype(jnp.int32)))


def _weighted_eight_point(p1, p2, wts):
    """Least-squares F from weighted correspondences (soft inlier refit)."""
    wsum = jnp.sum(wts) + 1e-12
    m1 = (wts[:, None] * p1).sum(0) / wsum
    m2 = (wts[:, None] * p2).sum(0) / wsum
    c1 = p1 - m1
    c2 = p2 - m2
    s1 = jnp.sqrt(2.0) / ((wts * jnp.linalg.norm(c1, axis=1)).sum() / wsum + 1e-12)
    s2 = jnp.sqrt(2.0) / ((wts * jnp.linalg.norm(c2, axis=1)).sum() / wsum + 1e-12)
    n1 = c1 * s1
    n2 = c2 * s2
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                   jnp.ones_like(x1)], axis=1)
    A = A * wts[:, None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[-1].reshape(3, 3)
    u, s, vt2 = jnp.linalg.svd(F)
    F = _mm(u * s.at[2].set(0.0)[None, :], vt2)
    T1 = jnp.stack([jnp.array([s1, 0.0, -s1 * m1[0]]),
                    jnp.array([0.0, s1, -s1 * m1[1]]),
                    jnp.array([0.0, 0.0, 1.0])])
    T2 = jnp.stack([jnp.array([s2, 0.0, -s2 * m2[0]]),
                    jnp.array([0.0, s2, -s2 * m2[1]]),
                    jnp.array([0.0, 0.0, 1.0])])
    return _mm(_mm(T2.T, F), T1)


# ---------------------------------------------------------------------------
# calibrated geometry
# ---------------------------------------------------------------------------

def essential_from_fundamental(F, K1, K2):
    E = _mm(_mm(K2.T, F), K1)
    u, s, vt = jnp.linalg.svd(E)
    # project to the essential manifold: singular values (1, 1, 0)
    return _mm(_mm(u, jnp.diag(jnp.array([1.0, 1.0, 0.0]))), vt)


def triangulate(P1, P2, p1, p2):
    """Linear (DLT) triangulation. P*: (3, 4) projections; p*: (N, 2).

    Returns (N, 3) points. Solved per point via the 4x4 normal equations -
    no SVD in the inner loop.
    """
    def one(x1, x2):
        A = jnp.stack([
            x1[0] * P1[2] - P1[0],
            x1[1] * P1[2] - P1[1],
            x2[0] * P2[2] - P2[0],
            x2[1] * P2[2] - P2[1],
        ])
        # nullspace via eigh of A^T A (4x4)
        _, v = jnp.linalg.eigh(_mm(A.T, A))
        X = v[:, 0]
        return X[:3] / (X[3] + jnp.where(jnp.abs(X[3]) < 1e-12, 1e-12, 0.0))

    return jax.vmap(one)(p1, p2)


def recover_pose(E, p1, p2, K1, K2, valid=None):
    """Decompose E into (R, t) resolving the 4-fold ambiguity by cheirality.

    p1, p2: (N, 2) pixel coordinates. Returns (R, t, points3d, front_mask).
    """
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    u, _, vt = jnp.linalg.svd(E)
    # enforce proper rotations
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    R1 = _mm(_mm(u, W), vt)
    R2 = _mm(_mm(u, W.T), vt)
    t = u[:, 2]

    n1 = _mm(jnp.concatenate([p1, jnp.ones((p1.shape[0], 1))], 1),
             jnp.linalg.inv(K1).T)[:, :2]
    n2 = _mm(jnp.concatenate([p2, jnp.ones((p2.shape[0], 1))], 1),
             jnp.linalg.inv(K2).T)[:, :2]
    if valid is None:
        valid = jnp.ones(p1.shape[0], bool)

    P1 = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)

    def score(R, tt):
        P2 = jnp.concatenate([R, tt[:, None]], axis=1)
        X = triangulate(P1, P2, n1, n2)
        z1 = X[:, 2]
        z2 = (_mm(X, R.T) + tt)[:, 2]
        front = (z1 > 0) & (z2 > 0) & valid
        return jnp.sum(front.astype(jnp.int32)), X, front

    candidates = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    scores, Xs, fronts = zip(*[score(R, tt) for R, tt in candidates])
    scores = jnp.stack(scores)
    best = jnp.argmax(scores)
    Rb = jnp.stack([c[0] for c in candidates])[best]
    tb = jnp.stack([c[1] for c in candidates])[best]
    Xb = jnp.stack(Xs)[best]
    fb = jnp.stack(fronts)[best]
    return Rb, tb, Xb, fb


class PnPResult(NamedTuple):
    R: jnp.ndarray          # (3, 3)
    t: jnp.ndarray          # (3,)
    inliers: jnp.ndarray    # (N,) bool
    num_inliers: jnp.ndarray


def _dlt_pose6(X, x_norm):
    """6-point DLT pose [R|t] from 3D-2D (normalized) correspondences.

    X: (6, 3), x_norm: (6, 2). Returns (R, t, ok) - branch-free, so it
    vmaps across RANSAC hypotheses.
    """
    ones = jnp.ones((X.shape[0], 1))
    Xh = jnp.concatenate([X, ones], axis=1)              # (6, 4)
    u_, v_ = x_norm[:, 0], x_norm[:, 1]
    zeros = jnp.zeros_like(Xh)
    rows1 = jnp.concatenate([zeros, -Xh, v_[:, None] * Xh], axis=1)
    rows2 = jnp.concatenate([Xh, zeros, -u_[:, None] * Xh], axis=1)
    A = jnp.concatenate([rows1, rows2], axis=0)          # (12, 12)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    P = vt[-1].reshape(3, 4)
    M = P[:, :3]
    um, sm, vtm = jnp.linalg.svd(M)
    d = jnp.sign(jnp.linalg.det(_mm(um, vtm)))
    R = _mm(_mm(um, jnp.diag(jnp.stack([jnp.float32(1.0), jnp.float32(1.0),
                                        d]))), vtm)
    scale = jnp.mean(sm) * d
    ok = jnp.abs(scale) > 1e-12
    t = P[:, 3] / jnp.where(ok, scale, 1.0)
    return R, t, ok


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
def ransac_pnp(key, pts3d, pts2d, valid, K, threshold: float = 8.0,
               num_hypotheses: int = 256) -> PnPResult:
    """Batched-hypothesis PnP: register a camera from 2D-3D matches.

    Replacement for the sequential NumPy DLT loop: all
    hypotheses' 6-point DLTs run as one vmapped batch and score against
    the full correspondence set in a single (H, N) residual matrix - the
    same pattern as ransac_fundamental.

    pts3d: (N, 3) world points; pts2d: (N, 2) pixels; valid: (N,) mask;
    K: (3, 3) intrinsics. threshold: reprojection-error inlier gate (px).
    """
    n = pts3d.shape[0]
    Ki = jnp.linalg.inv(K)
    ones = jnp.ones((n, 1))
    norm2d = _mm(jnp.concatenate([pts2d, ones], axis=1), Ki.T)[:, :2]

    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-12)
    idx = jax.random.choice(key, n, shape=(num_hypotheses, 6), p=probs)

    Rs, ts, oks = jax.vmap(
        lambda i: _dlt_pose6(pts3d[i], norm2d[i]))(idx)

    def reproj_err(R, t):
        xc = _mm(pts3d, R.T) + t
        z = jnp.maximum(xc[:, 2], 1e-9)
        pix = _mm(xc[:, :2] / z[:, None], K[:2, :2].T) + K[:2, 2]
        err = jnp.linalg.norm(pix - pts2d, axis=1)
        return jnp.where((xc[:, 2] > 0) & valid, err, jnp.inf)

    errs = jax.vmap(reproj_err)(Rs, ts)                   # (H, N)
    inl = (errs < threshold) & oks[:, None]
    scores = jnp.sum(inl.astype(jnp.int32), axis=1)
    best = jnp.argmax(scores)
    return PnPResult(R=Rs[best], t=ts[best], inliers=inl[best],
                     num_inliers=scores[best])


def type_aware_match_mask(type1, type2):
    """HessGPU's typed keypoints enable type-consistent matching: dark blobs
    match dark blobs, bright match bright, saddles match saddles.

    Returns (N1, N2) bool gate usable with matcher._match_core.
    """
    return type1[:, None] == type2[None, :]
