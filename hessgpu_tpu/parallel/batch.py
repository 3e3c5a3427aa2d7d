"""Batched + multi-chip detection.

Replacement for the reference's multi-GPU story (SURVEY.md section 2.5):
where HessGPU runs one thread/process per GPU (MultiThreadSIFT.cpp:83-149,
ServerSiftGPU one-server-per-GPU), we shard a batch of same-sized images
across a jax.sharding.Mesh and let one jitted program run data-parallel on
every device - no sockets, no threads.

Shapes are bucketed: images of one (H, W) bucket batch together (the
analogue of the reference's pyramid-reuse allocation policy,
SiftGPU.cpp:149-227).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SiftConfig
from ..features import FeatureTable
from ..pyramid import (PipelinePlan, _CfgKey, make_plan,
                       run_pipeline_batched)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _batched_pipeline(imgs, plan: PipelinePlan, cfg_key) -> FeatureTable:
    """Full pipeline over a batch of grayscale images (B, H, W): one
    program whose size and compile time are flat in B
    (pyramid.run_pipeline_batched)."""
    return run_pipeline_batched(imgs, plan, cfg_key.cfg)[0]


def detect_batch(images: np.ndarray, cfg: Optional[SiftConfig] = None,
                 mesh: Optional[Mesh] = None) -> FeatureTable:
    """Detect+describe a batch of same-sized grayscale images.

    images: (B, H, W) float32 in [0, 1].
    mesh: optional 1-D device mesh; the batch dim is sharded across it
    with shard_map (B must be divisible by the mesh size), so every device
    runs its local images' full pipeline - the replacement for the
    reference's one-process-per-GPU pattern.
    Returns a batched FeatureTable (leading dim B).
    """
    cfg = cfg or SiftConfig()
    b, h, w = images.shape
    plan = make_plan(h, w, cfg)
    arr = jnp.asarray(images, jnp.float32)
    ckey = _CfgKey(cfg)
    if mesh is None:
        return _batched_pipeline(arr, plan, ckey)

    fn = _build_sharded_batch_fn((b, h, w), plan, ckey, mesh)
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    return fn(jax.device_put(arr, sharding))


@functools.lru_cache(maxsize=32)
def _build_sharded_batch_fn(shape, plan, ckey, mesh: Mesh):
    """Compiled shard_map program per (shape, plan, config, mesh):
    rebuilding jit(shard_map(...)) per detect_batch call would re-trace
    and recompile the whole pipeline on every invocation."""
    b, h, w = shape
    axis = mesh.axis_names[0]
    spec_in = P(axis)

    def local_fn(local_imgs):
        return run_pipeline_batched(local_imgs, plan, ckey.cfg)[0]

    out_spec = jax.tree.map(lambda _: P(axis),
                            jax.eval_shape(local_fn,
                                           jax.ShapeDtypeStruct(
                                               (b // mesh.size, h, w),
                                               jnp.float32)))
    return jax.jit(jax.shard_map(local_fn, mesh=mesh, in_specs=spec_in,
                                 out_specs=out_spec))


def data_parallel_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D 'batch' mesh over available devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("batch",))


def bucket_images(images: List[np.ndarray], buckets: List[tuple]) -> dict:
    """Group images into static (H, W) buckets (padding up).

    The answer here to varying input sizes: pad each image to the smallest
    bucket that fits so jit caches hit (SURVEY.md section 2.1 translation
    note). Returns {bucket: (stacked array, list of original indices,
    list of original shapes)}.
    """
    out = {}
    for idx, img in enumerate(images):
        h, w = img.shape[:2]
        fit = None
        for bh, bw in sorted(buckets):
            if h <= bh and w <= bw:
                fit = (bh, bw)
                break
        if fit is None:
            fit = (h, w)
        padded = np.zeros(fit, np.float32)
        padded[:h, :w] = img
        out.setdefault(fit, ([], [], []))
        out[fit][0].append(padded)
        out[fit][1].append(idx)
        out[fit][2].append((h, w))
    return {k: (np.stack(v[0]), v[1], v[2]) for k, v in out.items()}
