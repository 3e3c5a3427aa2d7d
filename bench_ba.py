"""Bundle-adjustment throughput benchmark (BASELINE.json headline metric
"BA iters/s").

Builds a synthetic BA problem at SfM-map scale (64 cameras, 4096 points,
~32k observations: every camera sees every 8th point, Gaussian pixel
noise + perturbed initial geometry), then times jitted LM steps.  One LM
iteration = robust reweight + full residual/cost + 30 matrix-free PCG
iterations on the Gauss-Newton system (H v = J^T(J v) via jvp/vjp,
block-Jacobi preconditioned) + the accept/reject update, i.e. the unit of
work Ceres calls an LM iteration.

Prints ONE JSON line: LM iters/s, derived CG iters/s, and the final
reprojection RMSE (sanity: the solver must actually converge on the
timed problem). vs_baseline is LM iters/s against a 1.0 floor -- one
full LM iteration per second on a ~50k-parameter problem is the bar a
CPU Ceres run sets; the reference repo publishes no BA numbers.

Runs on JAX's default backend (the north star asks for BA throughput
*per device*).
"""

import json
import sys
import time

CAMS = 64
PTS = 4096
SEE_EVERY = 8   # camera c observes points with (p % SEE_EVERY) == c % SEE_EVERY
CG_ITERS = 30
WARMUP = 2
ITERS = 10


def _make_problem(np, jnp, cams=CAMS, pts=PTS, see_every=SEE_EVERY,
                  seed=0):
    """Seeded (state, problem): `cams` cameras each observing every
    `see_every`-th of `pts` points, 0.5 px noise, perturbed start."""
    from hessgpu_tpu.sfm.ba import BAProblem, BAState, so3_exp

    CAMS, PTS, SEE_EVERY = cams, pts, see_every
    rng = np.random.default_rng(seed)
    # cameras on a ring looking at a point cloud around the origin
    X = rng.uniform(-2, 2, (PTS, 3)).astype(np.float32)
    X[:, 2] += 6.0
    R_list, t_list = [], []
    for c in range(CAMS):
        ang = 0.4 * np.sin(2 * np.pi * c / CAMS)
        w = np.array([0.0, ang, 0.0], np.float32)
        R = np.asarray(so3_exp(jnp.asarray(w)))
        cpos = np.array([3.0 * np.sin(ang), 0.3 * np.cos(ang), 0.0])
        R_list.append(R)
        t_list.append(-R @ cpos)
    R = np.stack(R_list).astype(np.float32)
    t = np.stack(t_list).astype(np.float32)
    f, cx, cy = 800.0, 320.0, 240.0
    intr = np.tile(np.array([f, cx, cy], np.float32), (CAMS, 1))

    cam_idx, pt_idx, uvs = [], [], []
    for c in range(CAMS):
        pts = np.arange(c % SEE_EVERY, PTS, SEE_EVERY)
        Xc = X[pts] @ R[c].T + t[c]
        uv = Xc[:, :2] / Xc[:, 2:3] * f + np.array([cx, cy])
        cam_idx.append(np.full(len(pts), c))
        pt_idx.append(pts)
        uvs.append(uv + rng.normal(0, 0.5, uv.shape))
    prob = BAProblem(
        cam_idx=jnp.asarray(np.concatenate(cam_idx), jnp.int32),
        pt_idx=jnp.asarray(np.concatenate(pt_idx), jnp.int32),
        uv=jnp.asarray(np.concatenate(uvs), jnp.float32),
        weight=jnp.ones(sum(len(a) for a in cam_idx), jnp.float32),
    )
    # perturb the initial estimate: BA has real work to do
    state = BAState(
        R=jnp.asarray(R), t=jnp.asarray(t + rng.normal(0, 0.05, t.shape)),
        X=jnp.asarray(X + rng.normal(0, 0.05, X.shape)),
        intr=jnp.asarray(intr))
    return state, prob


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hessgpu_tpu.sfm.ba import lm_step, reprojection_rmse
    from hessgpu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    state, prob = _make_problem(np, jnp)
    n_obs = int(prob.uv.shape[0])

    step = jax.jit(lambda s, lam: lm_step(s, prob, lam, cg_iters=CG_ITERS))
    lam = jnp.asarray(1e-3)
    s = state
    for _ in range(WARMUP):
        s, lam, c0, c1, acc = step(s, lam)
    jax.block_until_ready(s)

    s, lam = state, jnp.asarray(1e-3)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        s, lam, c0, c1, acc = step(s, lam)
    jax.block_until_ready(s)
    dt = time.perf_counter() - t0

    rmse = float(reprojection_rmse(s, prob))
    lm_per_s = ITERS / dt
    print(json.dumps({
        "metric": "ba_lm_iterations_per_sec",
        "value": round(lm_per_s, 2),
        "unit": "LM iters/s (64 cams, 4096 pts, %d obs)" % n_obs,
        "vs_baseline": round(lm_per_s / 1.0, 2),
        "cg_iters_per_sec": round(lm_per_s * CG_ITERS, 1),
        "final_reproj_rmse_px": round(rmse, 3),
        "device": str(jax.devices()[0]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
