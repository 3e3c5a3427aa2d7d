"""Bundle adjustment: Levenberg-Marquardt with matrix-free PCG.

North-star component (no reference code; SURVEY.md section 7.6). Design:
  * residuals/Jacobians vectorized over the observation list (cam_idx,
    pt_idx, uv) - no per-camera Python loops;
  * the Gauss-Newton system is solved matrix-free: H v = J^T(J v) via
    jvp/vjp, preconditioned by the block-diagonal (6x6 pose / 3x3 point)
    blocks - every op is a gather/segment-sum/matmul that XLA maps onto
    the device, and the same products distribute across hosts with psum when
    observations are sharded (parallel/distributed.py);
  * rotations live on the manifold: increments are axis-angle deltas
    composed by exponential map each LM step.

State convention: camera c maps world points X to camera frame via
x_cam = R_c @ X + t_c; projection is pinhole with per-camera (f, cx, cy).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# All contractions here are tiny (3x3 rotations, 6x6 blocks) but feed a
# Krylov solver: a GPU may run an f32 matmul in TF32 (about three decimal
# digits), which is too coarse for PCG to converge to the f32 solution,
# so every dot in this module requests full f32.
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


class BAProblem(NamedTuple):
    """Static observation structure."""
    cam_idx: jnp.ndarray    # i32 (O,)
    pt_idx: jnp.ndarray     # i32 (O,)
    uv: jnp.ndarray         # f32 (O, 2) observed pixels
    weight: jnp.ndarray     # f32 (O,) 0 masks an observation out


class BAState(NamedTuple):
    R: jnp.ndarray          # (C, 3, 3) world->camera rotations
    t: jnp.ndarray          # (C, 3)
    X: jnp.ndarray          # (P, 3) points
    intr: jnp.ndarray       # (C, 3) f, cx, cy


def so3_exp(w):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    Taylor-safe at w = 0 (the BA solver differentiates through this at the
    zero increment, so the formulation must be smooth there - the naive
    normalize-then-rodrigues form has NaN gradients at the origin).
    """
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-10
    # double-where trick: keep the exact branch finite where unused
    t2safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(t2safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / t2safe)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    K = jnp.stack([
        jnp.stack([zero, -wz, wy], -1),
        jnp.stack([wz, zero, -wx], -1),
        jnp.stack([-wy, wx, zero], -1),
    ], -2)
    eye = jnp.broadcast_to(jnp.eye(3), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * _mm(K, K)


def _project(state: BAState, delta_pose, delta_pt, prob: BAProblem):
    """Residuals with tangent-space increments applied.

    delta_pose: (C, 6) [axis-angle | dt]; delta_pt: (P, 3). Observations
    select their camera and point by gather (the vjp's transpose is a
    segment sum).
    """
    dR = so3_exp(delta_pose[:, :3])
    R = _mm(dR, state.R)
    t = state.t + delta_pose[:, 3:]
    X = state.X + delta_pt

    Rc = R[prob.cam_idx]
    tc = t[prob.cam_idx]
    intr = state.intr[prob.cam_idx]
    Xp = X[prob.pt_idx]
    xc = jnp.einsum("oij,oj->oi", Rc, Xp, precision=_HI) + tc
    z = jnp.maximum(xc[:, 2], 1e-6)
    u = intr[:, 0] * xc[:, 0] / z + intr[:, 1]
    v = intr[:, 0] * xc[:, 1] / z + intr[:, 2]
    res = jnp.stack([u, v], 1) - prob.uv
    return res * prob.weight[:, None]


def _residual_fn(state, prob):
    def fn(params):
        dp, dx = params
        return _project(state, dp, dx, prob)
    return fn


def _block_jacobi(state: BAState, prob: BAProblem, lam):
    """Inverse block-diagonal preconditioner from per-observation Jacobians."""
    C = state.R.shape[0]
    P = state.X.shape[0]

    def per_obs(ci, pi, uv, wt):
        Rc, tc, intr = state.R[ci], state.t[ci], state.intr[ci]
        Xp = state.X[pi]

        def res_one(dp6, dx3):
            R = _mm(so3_exp(dp6[:3]), Rc)
            t = tc + dp6[3:]
            X = Xp + dx3
            xc = _mm(R, X) + t
            z = jnp.maximum(xc[2], 1e-6)
            u = intr[0] * xc[0] / z + intr[1]
            v = intr[0] * xc[1] / z + intr[2]
            return (jnp.stack([u, v]) - uv) * wt

        Jp = jax.jacfwd(res_one, argnums=0)(jnp.zeros(6), jnp.zeros(3))
        Jx = jax.jacfwd(res_one, argnums=1)(jnp.zeros(6), jnp.zeros(3))
        return _mm(Jp.T, Jp), _mm(Jx.T, Jx)      # (6,6), (3,3)

    Hcc, Hpp = jax.vmap(per_obs)(prob.cam_idx, prob.pt_idx, prob.uv,
                                 prob.weight)
    Hc = jax.ops.segment_sum(Hcc, prob.cam_idx, C)   # (C, 6, 6)
    Hp = jax.ops.segment_sum(Hpp, prob.pt_idx, P)    # (P, 3, 3)
    Hc = Hc + lam * jnp.eye(6)[None]
    Hp = Hp + lam * jnp.eye(3)[None]
    return jnp.linalg.inv(Hc), jnp.linalg.inv(Hp)


def robust_weights(state: BAState, prob: BAProblem, delta: float,
                   loss: str = "huber"):
    """IRLS sqrt-weights for a robust loss of width `delta` pixels,
    evaluated at the current state and held fixed for one LM step.

    huber:  w = 1 in the quadratic zone, sqrt(delta/|r|) outside -
            bounds but does not eliminate outlier influence (grows
            linearly), right when outliers are moderate.
    cauchy: w = 1/sqrt(1 + (r/delta)^2) - redescending, gross outliers'
            influence decays to ~0, right for contaminated SfM tracks.
    """
    zero = (jnp.zeros((state.R.shape[0], 6)), jnp.zeros_like(state.X))
    res = _residual_fn(state, prob)(zero)
    rn = jnp.linalg.norm(res, axis=1)
    if loss == "huber":
        w = jnp.sqrt(jnp.minimum(1.0, delta / jnp.maximum(rn, 1e-9)))
    elif loss == "cauchy":
        w = jax.lax.rsqrt(1.0 + (rn / delta) ** 2)
    else:
        raise ValueError(f"unknown robust loss {loss!r}")
    return jax.lax.stop_gradient(w)


def huber_weights(state: BAState, prob: BAProblem, delta: float):
    return robust_weights(state, prob, delta, loss="huber")


@functools.partial(jax.jit, static_argnames=("cg_iters", "fix_first_cam"))
def lm_step(state: BAState, prob: BAProblem, lam, cg_iters: int = 30,
            fix_first_cam: bool = True):
    """One Levenberg-Marquardt step. Returns (new_state, new_lam, cost,
    new_cost, accepted)."""
    fn = _residual_fn(state, prob)
    zero = (jnp.zeros((state.R.shape[0], 6)), jnp.zeros_like(state.X))

    # gauge fixing: camera 0 stays put by projecting it out of the Krylov
    # subspace (post-hoc snapping would invalidate the accepted cost)
    cam_mask = jnp.ones((state.R.shape[0], 1))
    if fix_first_cam:
        cam_mask = cam_mask.at[0].set(0.0)

    def project(v):
        return (v[0] * cam_mask, v[1])

    res0 = fn(zero)
    cost0 = 0.5 * jnp.sum(res0 ** 2)

    _, vjp = jax.vjp(fn, zero)
    grad = vjp(res0)[0]          # J^T r, pytree like zero

    def hvp(v):
        _, jv = jax.jvp(fn, (zero,), (v,))
        hv = vjp(jv)[0]
        return project((hv[0] + lam * v[0], hv[1] + lam * v[1]))

    Mc, Mp = _block_jacobi(state, prob, lam)

    def precond(v):
        return project((jnp.einsum("cij,cj->ci", Mc, v[0], precision=_HI),
                        jnp.einsum("pij,pj->pi", Mp, v[1], precision=_HI)))

    # PCG for H dx = -grad
    b = project((-grad[0], -grad[1]))

    def dot(a, bb):
        return jnp.sum(a[0] * bb[0]) + jnp.sum(a[1] * bb[1])

    x = (jnp.zeros_like(b[0]), jnp.zeros_like(b[1]))
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)

    def body(_, carry):
        x, r, p, rz = carry
        hp = hvp(p)
        alpha = rz / (dot(p, hp) + 1e-20)
        x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
        r = (r[0] - alpha * hp[0], r[1] - alpha * hp[1])
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / (rz + 1e-20)
        p = (z[0] + beta * p[0], z[1] + beta * p[1])
        return x, r, p, rz_new

    x, r, p, rz = jax.lax.fori_loop(0, cg_iters, body, (x, r, p, rz))

    # evaluate the step
    res1 = fn(x)
    cost1 = 0.5 * jnp.sum(res1 ** 2)
    accept = cost1 < cost0

    dR = so3_exp(x[0][:, :3])
    newR = jnp.where(accept, _mm(dR, state.R), state.R)
    newt = jnp.where(accept, state.t + x[0][:, 3:], state.t)
    newX = jnp.where(accept, state.X + x[1], state.X)
    new_lam = jnp.where(accept, lam * 0.5, lam * 4.0)
    new_lam = jnp.clip(new_lam, 1e-8, 1e6)
    return (BAState(R=newR, t=newt, X=newX, intr=state.intr),
            new_lam, cost0, cost1, accept)


def bundle_adjust(state: BAState, prob: BAProblem, iterations: int = 20,
                  lam0: float = 1e-3, cg_iters: int = 30,
                  fix_first_cam: bool = True,
                  huber_delta: float = 0.0, loss: str = "huber",
                  verbose: bool = False) -> Tuple[BAState, float]:
    """Run LM to convergence (fixed iteration budget, jit-cached step).

    fix_first_cam gauges the problem by zero-weighting the first camera's
    update (implemented by projecting its delta out via a large damping on
    that block - handled here simply by restoring cam 0 after each step).
    huber_delta > 0 enables a robust loss of that width (pixels) via
    per-step IRLS reweighting (`loss` picks huber or cauchy) - outliers
    stop dominating the normal equations.
    """
    lam = jnp.asarray(lam0)
    cost = None
    for _ in range(iterations):
        if huber_delta > 0:
            w = robust_weights(state, prob, huber_delta, loss=loss)
            prob_it = prob._replace(weight=prob.weight * w)
        else:
            prob_it = prob
        state, lam, c0, c1, acc = lm_step(state, prob_it, lam,
                                          cg_iters=cg_iters,
                                          fix_first_cam=fix_first_cam)
        cost = float(jnp.minimum(c0, c1))
        if verbose:
            print(f"LM cost {float(c0):.6f} -> {float(c1):.6f} "
                  f"accept={bool(acc)} lam={float(lam):.2e}")
    return state, cost


def prune_outliers(state: BAState, prob: BAProblem,
                   threshold: float = 4.0) -> Tuple[BAProblem, int]:
    """Zero-weight observations whose reprojection error exceeds threshold
    (pixels). Returns (pruned problem, number pruned)."""
    zero = (jnp.zeros((state.R.shape[0], 6)), jnp.zeros_like(state.X))
    res = _residual_fn(state, prob)(zero)
    safew = jnp.where(prob.weight > 0, prob.weight, 1.0)
    rn = jnp.linalg.norm(res, axis=1) / safew
    keep = (rn < threshold) & (prob.weight > 0)
    pruned = int(jnp.sum((prob.weight > 0) & ~keep))
    return prob._replace(weight=jnp.where(keep, prob.weight, 0.0)), pruned


def reprojection_rmse(state: BAState, prob: BAProblem) -> float:
    zero = (jnp.zeros((state.R.shape[0], 6)), jnp.zeros_like(state.X))
    res = _residual_fn(state, prob)(zero)
    nobs = jnp.sum(prob.weight > 0)
    return float(jnp.sqrt(jnp.sum(res ** 2) / jnp.maximum(2 * nobs, 1)))
