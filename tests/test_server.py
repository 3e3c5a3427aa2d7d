"""Native feature server: loopback client/server test.

Mirrors the reference's `server_siftgpu -test` smoke test
(server.cpp:31-60): spawn the C++ server as a local process, drive it over
the reference-compatible protocol, verify detect + match results.
"""

import os
import socket

import numpy as np
import pytest

from hessgpu_tpu.parallel.client import RemoteSift

# HESS_SERVER_BIN overrides the binary under test (e.g. the `make asan` /
# `make tsan` sanitizer builds, csrc/Makefile)
SERVER_BIN = os.environ.get("HESS_SERVER_BIN") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "build", "hess_server")

pytestmark = pytest.mark.skipif(
    not os.path.exists(SERVER_BIN),
    reason="native server not built (make -C csrc)")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + ":" + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def remote():
    r = RemoteSift(port=_free_port(), env=_cpu_env(),
                   server_binary=SERVER_BIN)
    yield r
    r.close(shutdown_server=True)


def test_server_detect_roundtrip(remote, gray_small, tmp_path):
    assert remote.initialize()
    ok = remote.run_sift_data(gray_small)
    assert ok
    n = remote.get_feature_count()
    assert n > 20
    keys, desc = remote.get_feature_vector()
    assert keys.shape == (n, 6)
    assert desc.shape == (n, 128)
    # descriptors are unit norm
    np.testing.assert_allclose(np.linalg.norm(desc, axis=1), 1.0, atol=1e-3)
    # matches the local pipeline
    from hessgpu_tpu import HessianSift, SiftConfig
    local = HessianSift(SiftConfig()).run(gray_small)
    assert local["x"].shape[0] == n
    np.testing.assert_allclose(keys[:, 0], local["x"], atol=1e-3)

    # save via the server (fire-and-forget; a round-trip flushes it)
    out = str(tmp_path / "remote.sift")
    remote.save_sift(out)
    remote.get_feature_count()
    assert os.path.exists(out)


def test_server_match(remote, gray_small):
    remote.run_sift_data(gray_small)
    _, desc = remote.get_feature_vector()
    remote.match_set_descriptors(0, desc)
    remote.match_set_descriptors(1, desc)
    matches = remote.match()
    # self-matching: every feature matches itself (up to duplicates from
    # multi-orientation keypoints sharing descriptors)
    n = desc.shape[0]
    assert len(matches) > 0.8 * n
    agree = (matches[:, 0] == matches[:, 1]).mean()
    assert agree > 0.9


def test_server_runsift_key(remote, gray_small):
    """COMMAND_RUNSIFT_KEY: describe externally supplied keypoints."""
    remote.run_sift_data(gray_small)
    keys_full, desc_full = remote.get_feature_vector()
    n = min(16, keys_full.shape[0])
    # feed back x, y, sigma, theta of detected keypoints
    ok = remote.run_sift_keys(keys_full[:n, :4], has_orientation=True)
    assert ok
    assert remote.get_feature_count() == n
    _, desc = remote.get_feature_vector()
    assert desc.shape == (n, 128)
    dots = np.sum(desc * desc_full[:n], axis=1)
    assert (dots > 0.999).mean() > 0.8


def test_server_runsift_rerun_and_set_keypoint(remote, gray_small):
    """COMMAND_RUNSIFT re-runs the current image; COMMAND_SET_KEYPOINT +
    COMMAND_RUNSIFT is the reference's two-step keypoint upload path
    (ServerSiftGPU.cpp:334-346, 362-377)."""
    assert remote.run_sift_data(gray_small)
    n0 = remote.get_feature_count()
    keys0, desc0 = remote.get_feature_vector()

    # plain re-run: full detection repeats deterministically
    assert remote.run_sift_current()
    assert remote.get_feature_count() == n0
    keys1, _ = remote.get_feature_vector()
    np.testing.assert_array_equal(keys0, keys1)

    # SET_KEYPOINT + RUNSIFT: describe an uploaded list; response and
    # packed level/type columns must be carried through to GET_KEY_VECTOR
    n = min(12, n0)
    remote.set_keypoint_list(keys0[:n], has_orientation=True)
    assert remote.run_sift_current()
    assert remote.get_feature_count() == n
    keys2, desc2 = remote.get_feature_vector()
    np.testing.assert_allclose(keys2[:, :4], keys0[:n, :4], atol=1e-4)
    np.testing.assert_array_equal(keys2[:, 4:], keys0[:n, 4:])
    dots = np.sum(desc2 * desc0[:n], axis=1)
    assert (dots > 0.999).mean() > 0.8

    # the pending list is consumed: the next RUNSIFT is a full detection
    assert remote.run_sift_current()
    assert remote.get_feature_count() == n0


def test_server_selftest_flag():
    """`hess_server -test` runs the reference's loopback self-test
    (server.cpp:31-60): spawn itself as a local server, detect on the two
    800-* images through the wire protocol, exit 0."""
    import subprocess
    r = subprocess.run([SERVER_BIN, "-test"], env=_cpu_env(),
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "self-test passed" in r.stdout


def test_server_concurrent_clients(gray_small):
    """Two clients on ONE server process, interleaved: per-connection
    backends isolate state (parse_param on one client does not leak into
    the other; each keeps its own current image / feature list). The
    reference serves one client at a time - this is a deliberate
    extension (hess_server.cpp ServeConnection thread-per-client)."""
    import subprocess
    import time

    port = _free_port()
    proc = subprocess.Popen([SERVER_BIN, "-server", str(port)],
                            env=_cpu_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 60
        while True:
            try:
                a = RemoteSift(host="127.0.0.1", port=port)
                break
            except (ConnectionRefusedError, OSError):
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        b = RemoteSift(host="127.0.0.1", port=port)
        assert a.initialize()
        assert b.initialize()

        # b raises its detection threshold; a must be unaffected
        b.parse_param("-t 0.5")

        assert a.run_sift_data(gray_small)
        na = a.get_feature_count()
        assert b.run_sift_data(gray_small)
        nb = b.get_feature_count()
        assert na > 20
        assert nb < na          # stricter threshold on b only

        # interleave: a's state survives b's activity
        keys_a, _ = a.get_feature_vector()
        assert b.run_sift_data(np.ascontiguousarray(gray_small[::-1]))
        assert a.get_feature_count() == na
        keys_a2, _ = a.get_feature_vector()
        np.testing.assert_array_equal(keys_a, keys_a2)

        a.close()
        b.close()
    finally:
        proc.kill()
        proc.wait()


def test_server_concurrent_light():
    """Sanitizer-friendly concurrency check: two clients enter the
    embedded interpreter concurrently (initialize / parse_param /
    counters) with no jit compiles. This is the designated target for
    the TSan build of the threaded server:

        make -C csrc tsan
        HESS_SERVER_BIN=csrc/build-tsan/hess_server \
            pytest tests/test_server.py::test_server_concurrent_light
    """
    import subprocess
    import time

    port = _free_port()
    proc = subprocess.Popen([SERVER_BIN, "-server", str(port)],
                            env=_cpu_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while True:
            try:
                a = RemoteSift(host="127.0.0.1", port=port)
                break
            except (ConnectionRefusedError, OSError):
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        b = RemoteSift(host="127.0.0.1", port=port)
        import threading

        errs = []

        def hammer(client, tag):
            try:
                assert client.initialize()
                for k in range(5):
                    client.parse_param(f"-t 0.0{k + 1}")
                    client.set_max_dimension(2048 + k)
                    assert client.get_feature_count() == 0
            except Exception as e:          # propagate to the main thread
                errs.append((tag, e))

        ts = [threading.Thread(target=hammer, args=(c, t))
              for c, t in ((a, "a"), (b, "b"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert not errs, errs
        a.close()
        b.close()
    finally:
        proc.kill()
        proc.wait()
