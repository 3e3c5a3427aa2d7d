"""Two-view geometry: synthetic-scene ground-truth tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hessgpu_tpu.sfm.twoview import (eight_point, essential_from_fundamental,
                                     ransac_fundamental, recover_pose,
                                     sampson_error, triangulate,
                                     type_aware_match_mask)


def _synthetic_scene(rng, n=200, noise=0.0, outliers=0):
    """Random 3D points seen by two calibrated cameras."""
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X = rng.rand(n, 3) * np.array([4, 3, 2]) + np.array([-2, -1.5, 4])
    R, _ = np.linalg.qr(np.eye(3) + 0.1 * rng.randn(3, 3))
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    t = np.array([1.0, 0.1, 0.05])
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([R, t[:, None]])

    def proj(P, X):
        x = (np.hstack([X, np.ones((n, 1))]) @ P.T)
        return x[:, :2] / x[:, 2:3]

    p1 = proj(P1, X) + noise * rng.randn(n, 2)
    p2 = proj(P2, X) + noise * rng.randn(n, 2)
    if outliers:
        idx = rng.choice(n, outliers, replace=False)
        p2[idx] += rng.rand(outliers, 2) * 100 + 20
    return K, R, t, X, p1.astype(np.float32), p2.astype(np.float32)


def test_eight_point_exact(rng):
    K, R, t, X, p1, p2 = _synthetic_scene(rng, n=50)
    F = np.asarray(eight_point(jnp.asarray(p1), jnp.asarray(p2)))
    err = np.asarray(sampson_error(jnp.asarray(F), jnp.asarray(p1),
                                   jnp.asarray(p2)))
    assert np.sqrt(err).max() < 0.1


def test_ransac_rejects_outliers(rng):
    K, R, t, X, p1, p2 = _synthetic_scene(rng, n=200, noise=0.3, outliers=60)
    res = ransac_fundamental(jax.random.PRNGKey(0), jnp.asarray(p1),
                             jnp.asarray(p2), jnp.ones(200, bool),
                             threshold=2.0)
    n_in = int(res.num_inliers)
    assert n_in >= 120, n_in
    # outliers must be excluded
    inl = np.asarray(res.inliers)
    err = np.asarray(sampson_error(res.F, jnp.asarray(p1), jnp.asarray(p2)))
    assert (err[inl] < 4.0).all()


def test_pose_recovery(rng):
    K, R, t, X, p1, p2 = _synthetic_scene(rng, n=100)
    F = eight_point(jnp.asarray(p1), jnp.asarray(p2))
    E = essential_from_fundamental(F, jnp.asarray(K), jnp.asarray(K))
    Rr, tr, Xr, front = recover_pose(E, jnp.asarray(p1), jnp.asarray(p2),
                                     jnp.asarray(K), jnp.asarray(K))
    Rr, tr = np.asarray(Rr), np.asarray(tr)
    # rotation recovered up to numerical noise
    assert np.abs(Rr - R).max() < 1e-2, np.abs(Rr - R).max()
    # translation up to scale
    tn = tr / np.linalg.norm(tr)
    texp = t / np.linalg.norm(t)
    assert min(np.linalg.norm(tn - texp), np.linalg.norm(tn + texp)) < 1e-2
    assert np.asarray(front).mean() > 0.95


def test_triangulation_accuracy(rng):
    K, R, t, X, p1, p2 = _synthetic_scene(rng, n=100)
    # triangulate in normalized coordinates with the true pose
    Ki = np.linalg.inv(K)
    n1 = (np.hstack([p1, np.ones((100, 1))]) @ Ki.T)[:, :2]
    n2 = (np.hstack([p2, np.ones((100, 1))]) @ Ki.T)[:, :2]
    P1 = jnp.asarray(np.hstack([np.eye(3), np.zeros((3, 1))]), jnp.float32)
    P2 = jnp.asarray(np.hstack([R, t[:, None]]), jnp.float32)
    Xr = np.asarray(triangulate(P1, P2, jnp.asarray(n1, jnp.float32),
                                jnp.asarray(n2, jnp.float32)))
    assert np.abs(Xr - X).max() < 1e-2


def test_type_aware_mask():
    t1 = jnp.asarray([0, 1, 2])
    t2 = jnp.asarray([2, 0])
    m = np.asarray(type_aware_match_mask(t1, t2))
    assert m.tolist() == [[False, True], [False, False], [True, False]]


def test_ransac_pnp_recovers_pose(rng):
    """Batched-hypothesis PnP recovers a camera from 2D-3D matches with
    outliers (replacement for the sequential DLT loop)."""
    from hessgpu_tpu.sfm.twoview import ransac_pnp

    K, R, t, X, p1, p2 = _synthetic_scene(rng, n=128, noise=0.2,
                                          outliers=25)
    valid = jnp.ones(len(X), bool)
    res = ransac_pnp(jax.random.PRNGKey(0), jnp.asarray(X, jnp.float32),
                     jnp.asarray(p2), valid, jnp.asarray(K, jnp.float32),
                     threshold=3.0)
    dR = np.asarray(res.R) @ R.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 1.0, ang
    np.testing.assert_allclose(np.asarray(res.t), t, atol=0.05)
    assert int(res.num_inliers) > 80
    # the injected outliers are rejected
    assert np.asarray(res.inliers)[np.asarray(res.inliers)].sum() \
        == int(res.num_inliers)
