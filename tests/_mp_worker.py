"""Worker process for the multi-process distributed test.

Each process calls jax.distributed.initialize on the CPU backend — the
processes-as-nodes pattern the reference uses to smoke-test its server mode
on one machine (ServerSiftGPU.cpp:156-194, server.cpp:31-60) — and runs the
sharded detect / match / bundle-adjust paths over the global device mesh.
Process 0 writes results to an .npz for the parent test to compare against
the single-process ground truth.

Launched by tests/test_multiprocess.py with JAX_PLATFORMS=cpu and
--xla_force_host_platform_device_count=2 (so 2 processes x 2 local
devices = one 4-device global mesh).
"""

import sys

import numpy as np


def _replicated(arr):
    """Full value of a replicated (P()) global array via the local shard."""
    return np.asarray(arr.addressable_data(0))


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    out_path = sys.argv[4]

    import jax
    from hessgpu_tpu.parallel import distributed

    distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                           process_id=pid)
    assert jax.process_count() == nproc

    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, PartitionSpec as P

    devs = jax.devices()
    mesh = Mesh(np.array(devs), ("batch",))
    n_dev = len(devs)
    rng = np.random.RandomState(0)

    # ---- 1. sharded batch detection --------------------------------------
    from hessgpu_tpu.config import SiftConfig
    from hessgpu_tpu.parallel.batch import detect_batch

    images = rng.rand(n_dev, 64, 96).astype(np.float32)
    local = images.reshape(nproc, n_dev // nproc, 64, 96)[pid]
    global_imgs = multihost_utils.host_local_array_to_global_array(
        local, mesh, P("batch"))
    table = detect_batch(global_imgs, SiftConfig(), mesh=mesh)
    counts = _replicated(
        jax.jit(
            lambda v: jnp.sum(v.astype(jnp.int32), axis=(1,)),
            out_shardings=jax.sharding.NamedSharding(mesh, P()),
        )(table.valid))

    # ---- 2. sharded matching ---------------------------------------------
    from hessgpu_tpu.matcher import quantize_descriptors
    raw = rng.rand(4 * n_dev, 128).astype(np.float32)
    raw /= np.linalg.norm(raw, axis=1, keepdims=True)
    d1 = quantize_descriptors(raw)
    d2 = d1[::-1].copy()
    matches = distributed.match_sharded(
        jnp.asarray(d1), jnp.asarray(d2), mesh)
    matches = _replicated(
        jax.jit(lambda m: m,
                out_shardings=jax.sharding.NamedSharding(mesh, P()))(matches))

    # ---- 3. sharded bundle adjustment ------------------------------------
    from hessgpu_tpu.sfm.ba import BAProblem, BAState, so3_exp
    from hessgpu_tpu.sfm.distributed_ba import bundle_adjust_sharded

    npts, ncams = 40, 3
    X = rng.rand(npts, 3) * 2 - 1 + np.array([0, 0, 4.0])
    Rs, ts, obs = [], [], []
    for c in range(ncams):
        w = rng.randn(3) * 0.1
        R = np.asarray(so3_exp(jnp.asarray(w)))
        t = np.array([0.3 * c, 0.0, 0.0])
        Rs.append(R)
        ts.append(t)
        Xc = X @ R.T + t
        uv = 500.0 * Xc[:, :2] / Xc[:, 2:3] + 320.0
        obs.append(uv)
    cam_idx = np.repeat(np.arange(ncams), npts).astype(np.int32)
    pt_idx = np.tile(np.arange(npts), ncams).astype(np.int32)
    uv = np.concatenate(obs).astype(np.float32)
    uv += rng.randn(*uv.shape).astype(np.float32) * 0.1
    prob = BAProblem(cam_idx=jnp.asarray(cam_idx),
                     pt_idx=jnp.asarray(pt_idx),
                     uv=jnp.asarray(uv),
                     weight=jnp.ones(len(cam_idx), jnp.float32))
    intr = np.tile(np.array([500.0, 320.0, 320.0], np.float32), (ncams, 1))
    state = BAState(R=jnp.asarray(np.stack(Rs), jnp.float32),
                    t=jnp.asarray(np.stack(ts), jnp.float32),
                    X=jnp.asarray(X + rng.randn(npts, 3) * 0.05, jnp.float32),
                    intr=jnp.asarray(intr))
    state2, cost = bundle_adjust_sharded(state, prob, mesh, iterations=5)

    if pid == 0:
        np.savez(out_path,
                 counts=counts,
                 matches=matches,
                 ba_cost=np.float32(cost),
                 ba_X=np.asarray(state2.X),
                 ba_t=np.asarray(state2.t))
    multihost_utils.sync_global_devices("done")
    print(f"proc {pid}: OK", flush=True)


if __name__ == "__main__":
    main()
