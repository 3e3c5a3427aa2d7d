"""Bundle adjustment on synthetic problems with known ground truth."""

import numpy as np
import jax.numpy as jnp
import pytest

from hessgpu_tpu.sfm.ba import (BAProblem, BAState, bundle_adjust,
                                reprojection_rmse, so3_exp)


def _rotmat(rng, scale=0.1):
    """Rotation by a random axis-angle with |angle| ~ scale (well-defined
    smallness - QR of a near-identity matrix is NOT near identity due to
    sign conventions)."""
    from hessgpu_tpu.sfm.ba import so3_exp
    return np.asarray(so3_exp(jnp.asarray(scale * rng.randn(3))))


def _make_problem(rng, C=4, P=60, noise=0.0, perturb=0.05):
    f, cx, cy = 500.0, 320.0, 240.0
    X = rng.rand(P, 3) * np.array([4, 3, 2]) + np.array([-2, -1.5, 6])
    Rs, ts = [], []
    for c in range(C):
        Rs.append(_rotmat(rng, 0.05))
        ts.append(np.array([c * 0.5, 0.02 * c, 0.01 * c]))
    Rs, ts = np.stack(Rs), np.stack(ts)

    cams, pts, uvs = [], [], []
    for c in range(C):
        xc = X @ Rs[c].T + ts[c]
        u = f * xc[:, 0] / xc[:, 2] + cx
        v = f * xc[:, 1] / xc[:, 2] + cy
        for p in range(P):
            cams.append(c)
            pts.append(p)
            uvs.append([u[p] + noise * rng.randn(),
                        v[p] + noise * rng.randn()])

    prob = BAProblem(
        cam_idx=jnp.asarray(cams, jnp.int32),
        pt_idx=jnp.asarray(pts, jnp.int32),
        uv=jnp.asarray(uvs, jnp.float32),
        weight=jnp.ones(len(cams), jnp.float32),
    )
    intr = jnp.broadcast_to(jnp.asarray([f, cx, cy]), (C, 3))
    gt = BAState(R=jnp.asarray(Rs, jnp.float32),
                 t=jnp.asarray(ts, jnp.float32),
                 X=jnp.asarray(X, jnp.float32), intr=intr)

    # perturb everything except camera 0 (the gauge)
    Rp = Rs.copy()
    tp = ts.copy()
    for c in range(1, C):
        Rp[c] = _rotmat(rng, perturb * 0.2) @ Rp[c]
        tp[c] = tp[c] + perturb * rng.randn(3)
    Xp = X + perturb * rng.randn(P, 3)
    init = BAState(R=jnp.asarray(Rp, jnp.float32),
                   t=jnp.asarray(tp, jnp.float32),
                   X=jnp.asarray(Xp, jnp.float32), intr=intr)
    return gt, init, prob


def test_so3_exp_basic():
    R = np.asarray(so3_exp(jnp.asarray([0.0, 0.0, np.pi / 2])))
    want = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    np.testing.assert_allclose(R, want, atol=1e-6)
    # identity for zero
    np.testing.assert_allclose(np.asarray(so3_exp(jnp.zeros(3))), np.eye(3),
                               atol=1e-6)


def test_ba_reduces_reprojection_error(rng):
    gt, init, prob = _make_problem(rng)
    rmse0 = reprojection_rmse(init, prob)
    out, _ = bundle_adjust(init, prob, iterations=15)
    rmse1 = reprojection_rmse(out, prob)
    assert rmse0 > 1.0          # the perturbation is visible
    assert rmse1 < 0.05, (rmse0, rmse1)


def test_ba_recovers_poses(rng):
    gt, init, prob = _make_problem(rng)
    out, _ = bundle_adjust(init, prob, iterations=20)
    # camera rotations recovered (gauge fixed by camera 0)
    for c in range(gt.R.shape[0]):
        dR = np.asarray(out.R[c]) @ np.asarray(gt.R[c]).T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 0.5, (c, ang)
    np.testing.assert_allclose(np.asarray(out.t), np.asarray(gt.t), atol=0.02)


def test_ba_noise_floor(rng):
    """With pixel noise, BA converges to ~noise-level residuals."""
    gt, init, prob = _make_problem(rng, noise=0.5)
    out, _ = bundle_adjust(init, prob, iterations=15)
    rmse = reprojection_rmse(out, prob)
    assert rmse < 0.8, rmse


def test_ba_respects_weights(rng):
    gt, init, prob = _make_problem(rng)
    # zero out half the observations; BA should still converge using the rest
    w = np.asarray(prob.weight).copy()
    w[::2] = 0.0
    prob2 = prob._replace(weight=jnp.asarray(w))
    out, _ = bundle_adjust(init, prob2, iterations=20)
    assert reprojection_rmse(out, prob2) < 0.05


def test_huber_ba_resists_outliers(rng):
    """Gross outlier observations: plain BA gets dragged, a redescending
    (Cauchy) robust loss + pruning recovers near the clean solution."""
    from hessgpu_tpu.sfm.ba import prune_outliers

    gt, init, prob = _make_problem(rng)
    uv = np.asarray(prob.uv).copy()
    n_out = len(uv) // 10
    idx = rng.choice(len(uv), n_out, replace=False)
    uv[idx] += rng.rand(n_out, 2) * 200 + 50
    prob_bad = prob._replace(uv=jnp.asarray(uv))

    out_plain, _ = bundle_adjust(init, prob_bad, iterations=15)
    out_rob, _ = bundle_adjust(init, prob_bad, iterations=15,
                               huber_delta=2.0, loss="cauchy")
    probp, npruned = prune_outliers(out_rob, prob_bad, threshold=4.0)
    assert npruned >= n_out * 0.8, npruned
    out_rob, _ = bundle_adjust(out_rob, probp, iterations=8,
                               huber_delta=2.0, loss="cauchy")

    # measure on the clean inlier set only
    mask = np.ones(len(uv), bool)
    mask[idx] = False
    clean = prob._replace(weight=jnp.asarray(mask.astype(np.float32)))
    rmse_plain = reprojection_rmse(out_plain, clean)
    rmse_rob = reprojection_rmse(out_rob, clean)
    assert rmse_rob < 0.1, rmse_rob
    assert rmse_rob < rmse_plain


def test_prune_outliers_counts(rng):
    gt, init, prob = _make_problem(rng)
    # ground-truth state: every observation is exact, so nothing prunes
    from hessgpu_tpu.sfm.ba import prune_outliers
    prob2, n = prune_outliers(gt, prob, threshold=1.0)
    assert n == 0
    assert np.all(np.asarray(prob2.weight) == np.asarray(prob.weight))


def test_lm_step_selects_observations_by_gather(rng):
    """lm_step selects each observation's camera and point by gather,
    and its vjp accumulates by scatter-add (segment sum), on every
    backend: no one-hot selector matmuls."""
    import jax.numpy as jnp

    from hessgpu_tpu.sfm.ba import lm_step

    _, init, prob = _make_problem(rng)
    text = lm_step.lower(init, prob, jnp.asarray(1e-3),
                         cg_iters=5).as_text()
    assert "stablehlo.gather" in text
    assert "stablehlo.scatter" in text
    assert "one_hot" not in text
