"""True multi-process distributed execution test.

Spawns 2 OS processes that join one jax.distributed CPU job (2 local
devices each -> a 4-device global mesh) and run the sharded detection,
matching, and bundle-adjustment paths — the same processes-as-nodes trick
the reference uses to smoke-test its multi-GPU server mode on one machine
(ServerSiftGPU.cpp:156-194, server.cpp:31-60; SURVEY.md section 4 item 5).
The parent compares against single-process ground truth computed in-process
on the 8-virtual-device CPU backend.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_mp_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def mp_results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mp") / "results.npz")
    port = _free_port()
    env = _worker_env()
    nproc = 2
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(i), str(nproc),
                          str(port), out],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
        for i in range(nproc)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i]}"
    return np.load(out)


def test_multiprocess_detect_matches_single_process(mp_results):
    from hessgpu_tpu.config import SiftConfig
    from hessgpu_tpu.parallel.batch import detect_batch

    rng = np.random.RandomState(0)
    images = rng.rand(4, 64, 96).astype(np.float32)
    table = detect_batch(images, SiftConfig())
    want = np.asarray(jnp.sum(table.valid.astype(jnp.int32), axis=1))
    np.testing.assert_array_equal(mp_results["counts"], want)


def test_multiprocess_match_matches_single_process(mp_results):
    from hessgpu_tpu.matcher import _match_core, quantize_descriptors

    rng = np.random.RandomState(0)
    rng.rand(4, 64, 96)  # keep the stream aligned with the worker
    raw = rng.rand(16, 128).astype(np.float32)
    raw /= np.linalg.norm(raw, axis=1, keepdims=True)
    d1 = quantize_descriptors(raw)
    d2 = d1[::-1].copy()
    n = d1.shape[0]
    want = np.asarray(_match_core(
        jnp.asarray(d1), jnp.asarray(d2),
        jnp.ones(n, bool), jnp.ones(n, bool), 0.7, 0.8, mutual_best=True))
    np.testing.assert_array_equal(mp_results["matches"], want)
    # the reversed-copy construction means row i must match row N-1-i
    np.testing.assert_array_equal(mp_results["matches"],
                                  n - 1 - np.arange(n))


def test_multiprocess_ba_converges(mp_results):
    # the sharded LM on 2 processes reaches the same quality as single
    # process: reprojection cost is tiny for a 0.1 px noise problem
    assert float(mp_results["ba_cost"]) < 1.0
    assert np.isfinite(mp_results["ba_X"]).all()
    assert np.isfinite(mp_results["ba_t"]).all()
