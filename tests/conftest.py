"""Test configuration: force the CPU backend with 8 virtual devices.

Unit tests run on CPU - JAX executes identical code there - and
multi-device sharding tests use 8 virtual CPU devices, the same way the
reference smoke-tested its server mode with local processes (SURVEY.md
section 4.5).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402



# ---------------------------------------------------------------------------
# smoke tier: `pytest -m smoke` is the fast (~2 min) pre-commit gate
# (`make test-smoke`). Whole modules of unit tests are smoke; jit-heavy
# end-to-end modules contribute only the cherry-picked node ids below
# (they share one module-scoped compile). The full suite stays the
# authority: scripts/run_tests_parallel.sh runs it 4-way in ~11 min.
# ---------------------------------------------------------------------------

SMOKE_MODULES = {
    "test_compaction.py", "test_gaussian.py", "test_keypoint.py",
    "test_descriptor.py", "test_orientation.py", "test_matcher.py",
    "test_twoview.py", "test_posegraph.py", "test_io_viz.py",
    "test_distributed.py",
}
SMOKE_TESTS = {
    ("test_pipeline.py", "test_pipeline_finds_features"),
    ("test_pipeline.py", "test_coordinates_in_bounds"),
    ("test_pipeline.py", "test_descriptors_normalized"),
    ("test_pipeline.py", "test_determinism"),
    ("test_pipeline.py", "test_formats_roundtrip"),
    ("test_dog_mode.py", "test_dog_sigma_schedule"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = os.path.basename(str(item.fspath))
        base = item.name.split("[")[0]
        if fname in SMOKE_MODULES or (fname, base) in SMOKE_TESTS:
            item.add_marker(pytest.mark.smoke)


@pytest.fixture(scope="session")
def image_640():
    """Seeded 640x480 RGB u8 render of the textured corner scene."""
    from hessgpu_tpu.sfm.synthetic import scene_views
    g = scene_views(seed=0, h=480, w=640)[0]
    return np.repeat((g * 255 + 0.5).astype(np.uint8)[..., None], 3, -1)


@pytest.fixture(scope="session")
def gray_small(image_640):
    """A small grayscale crop for fast pipeline tests."""
    from hessgpu_tpu.ops.resize import rgb_to_gray, to_float
    import jax.numpy as jnp
    g = rgb_to_gray(to_float(jnp.asarray(image_640)))
    return np.asarray(g)[200:360, 280:480]  # textured region


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream
    # regardless of execution order
    return np.random.RandomState(42)
