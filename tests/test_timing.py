"""Per-stage device time from a profiler trace (utils.timing)."""

import jax
import jax.numpy as jnp
import pytest

from hessgpu_tpu.utils.timing import device_stage_breakdown


@jax.jit
def _scoped(x):
    with jax.named_scope("BUILD_PYRAMID"):
        y = jnp.sin(x) @ x
    with jax.named_scope("COMPUTE_DESCRIPTORS"):
        return jnp.tanh(y) @ y


@jax.jit
def _unscoped(x):
    return jnp.cumsum(jnp.sin(x) @ x, axis=0)


def test_ops_land_in_their_named_scope_buckets():
    b = device_stage_breakdown(_scoped, jnp.ones((128, 128)), runs=2)
    assert b["BUILD_PYRAMID"] > 0 and b["COMPUTE_DESCRIPTORS"] > 0
    parts = sum(v for k, v in b.items() if k != "TOTAL")
    assert b["TOTAL"] == pytest.approx(parts)


def test_no_bucketed_op_raises_instead_of_zeros():
    with pytest.raises(RuntimeError, match="none in a pipeline stage"):
        device_stage_breakdown(_unscoped, jnp.ones((128, 128)), runs=2)
