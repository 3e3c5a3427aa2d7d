"""Multi-host / multi-chip distribution helpers.

Replacement for the reference's distribution story (SURVEY.md
section 2.5/5.8): where HessGPU used TCP sockets for feature transport and
one process per GPU, here `jax.distributed` + XLA collectives (NCCL over
NVLink between the cards of a host) carry everything:

  * initialize(): multi-host program launch (the analogue of starting one
    server per GPU, ServerSiftGPU.cpp usage comment SiftGPU.h:378-396).
  * device_mesh(): all-device mesh for data/batch sharding.
  * match_sharded(): the all-pairs descriptor matcher with image-1 rows
    sharded across the mesh - the dot-product matrix never materializes on
    one chip, mutual-best is resolved with psum/argmax collectives.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

INV_512_SQ = 1.0 / (512.0 * 512.0)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Multi-host initialization (no-op on a single host)."""
    if coordinator_address is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def device_mesh(axis_name: str = "batch",
                n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def match_sharded(d1: jnp.ndarray, d2: jnp.ndarray, mesh: Mesh,
                  distmax: float = 0.7, ratiomax: float = 0.8,
                  mutual_best: bool = True,
                  loc1: jnp.ndarray = None, loc2: jnp.ndarray = None,
                  H=None, F=None,
                  hdistmax: float = 32.0,
                  fdistmax: float = 16.0,
                  n2_tile: Optional[int] = None) -> jnp.ndarray:
    """Pairwise matching with d1's rows sharded across the mesh.

    d1: (N1, 128) u8 (any N1 - rows are zero-padded up to a multiple of
    the mesh size; zero descriptors dot to 0 and can never pass the
    `best > 0` acceptance gates, so padding rows report -1 and are sliced
    off); d2: (N2, 128) u8 (replicated). Returns (N1,) match index per
    row or -1 - identical to matcher._match_core, but the (N1, N2) dot
    matrix lives sharded.

    Guided mode (reference GetGuidedSiftMatch): pass loc1 (N1, 2) - row
    coordinates, sharded with d1 - and loc2 (N2, 2, replicated) plus a
    homography H and/or fundamental matrix F; candidate pairs outside the
    geometric gate are masked before the argmax, exactly as
    matcher._guided_gate does on one chip. A None matrix skips its test
    (identity/huge-threshold convention, SiftMatchGPU semantics).

    n2_tile: map-scale mode - the local dot block is computed one
    (N1/n, n2_tile) column tile at a time under lax.scan (running top-2
    merge for the row side; columns are tile-local so their stats are
    final per tile), so peak memory is O(N1/n * n2_tile) instead of
    O(N1/n * N2). At N1=N2=1e5 the untiled block would be 5 GB/chip.
    Auto-enabled (8192 cols) when the full block would exceed ~256 MB.
    Results are identical to the untiled path (same reductions; tile
    boundaries only regroup max/argmax merges, which are exact).
    """
    from ..matcher import _guided_gate

    axis = mesh.axis_names[0]
    guided = H is not None or F is not None
    if guided:
        assert loc1 is not None and loc2 is not None, \
            "guided match_sharded needs loc1/loc2"
        if H is None:
            H = jnp.eye(3, dtype=jnp.float32)
            hdistmax = 1.0e20
        if F is None:
            # identity keeps the Sampson denominator nonzero for any real
            # coordinate pair; the huge threshold then admits everything
            F = jnp.eye(3, dtype=jnp.float32)
            fdistmax = 1.0e20
        H = jnp.asarray(H, jnp.float32)
        F = jnp.asarray(F, jnp.float32)
    n1 = d1.shape[0]
    n1p = -(-n1 // mesh.size) * mesh.size
    if n1p != n1:
        d1 = jnp.pad(d1, ((0, n1p - n1), (0, 0)))
        if guided:
            loc1 = jnp.pad(jnp.asarray(loc1, jnp.float32),
                           ((0, n1p - n1), (0, 0)))
    nloc = n1p // mesh.size

    n2 = d2.shape[0]
    if n2_tile is None and nloc * n2 * 4 > 256 * 1024 * 1024:
        n2_tile = 16384
    if n2_tile is not None:
        n2_tile = min(n2_tile, n2)
        n2p = -(-n2 // n2_tile) * n2_tile
        if n2p != n2:
            d2 = jnp.pad(d2, ((0, n2p - n2), (0, 0)))
            if guided:
                loc2 = jnp.pad(jnp.asarray(loc2, jnp.float32),
                               ((0, n2p - n2), (0, 0)))

    def _tile_dots(d1s, d2t, l1s, l2t, col0):
        a = d1s.astype(jnp.bfloat16)
        b = d2t.astype(jnp.bfloat16)
        dots = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
        if guided:
            gate = _guided_gate(l1s, l2t, H, hdistmax, F, fdistmax)
            dots = jnp.where(gate, dots, -1.0)
        if n2_tile is not None and d2.shape[0] != n2:
            # padded columns must stay out of the second-best values in
            # guided mode (ungated zero-pad rows would inject 0s)
            colio = col0 + jnp.arange(dots.shape[1])
            dots = jnp.where(colio[None, :] < n2, dots,
                             -1.0 if guided else 0.0)
        return dots

    def _row_col_stats(dots, col0, shard, row0=0):
        # row side: argmax/max/2nd within these columns
        ri = jnp.argmax(dots, axis=1) + col0
        rv = jnp.max(dots, axis=1)
        onehot = jax.nn.one_hot(ri - col0, dots.shape[1], dtype=jnp.bool_,
                                axis=1)
        rn = jnp.max(jnp.where(onehot, -jnp.inf, dots), axis=1)
        # column side: these columns' final local stats (row0 = this row
        # tile's offset within the shard, map-scale mode)
        cv = jnp.max(dots, axis=0)
        ci_local = jnp.argmax(dots, axis=0)
        ci = ci_local + shard * nloc + row0
        oh = jax.nn.one_hot(ci_local, dots.shape[0], dtype=jnp.bool_,
                            axis=0)
        cn = jnp.max(jnp.where(oh, -jnp.inf, dots), axis=0)
        return ri, rv, rn, cv, ci, cn

    def local_fn(d1s, d2r, *locs):
        l1s, l2r = locs if guided else (None, None)
        shard = jax.lax.axis_index(axis)
        if n2_tile is None:
            dots = _tile_dots(d1s, d2r, l1s, l2r, 0)
            ri, rv, rn, cv, ci, cn = _row_col_stats(dots, 0, shard)
        else:
            ntile = d2r.shape[0] // n2_tile
            d2t = d2r.reshape(ntile, n2_tile, -1)
            l2t = l2r.reshape(ntile, n2_tile, -1) if guided else \
                jnp.zeros((ntile, 1, 1))
            # row tiling bounds the live block to (n1_tile, n2_tile) so
            # the f32 dot block and its top-2 masks stay a bounded working
            # set. Column stats merge across row tiles with the same
            # exact top-2 merge the column-tile scan uses. The clamp at
            # 16384 rows is an untuned default on this device.
            n1_tile = min(n2_tile, nloc, 16384)
            nrt = -(-nloc // n1_tile)
            nlocp = nrt * n1_tile
            d1p = jnp.pad(d1s, ((0, nlocp - nloc), (0, 0)))
            d1t = d1p.reshape(nrt, n1_tile, -1)
            if guided:
                l1p = jnp.pad(l1s, ((0, nlocp - nloc), (0, 0)))
                l1t = l1p.reshape(nrt, n1_tile, -1)
            else:
                l1t = jnp.zeros((nrt, 1, 1))
            n2p = ntile * n2_tile

            def row_tile(carry, xs):
                cv0, ci0, cn0 = carry              # (n2p,) running stats
                d1b, l1b, rt = xs
                row00 = rt * n1_tile

                def step(c2, xs2):
                    v1, i1, v2 = c2
                    dt, lt, ti = xs2
                    col0 = ti * n2_tile
                    dots = _tile_dots(d1b, dt,
                                      l1b if guided else None,
                                      lt if guided else None, col0)
                    tri, trv, trn, tcv, tci, tcn = _row_col_stats(
                        dots, col0, shard, row00)
                    # exact running top-2 merge: the global second is
                    # either the loser of the two firsts or a second
                    nv1 = jnp.maximum(v1, trv)
                    ni1 = jnp.where(trv > v1, tri, i1)  # ties keep first
                    nv2 = jnp.maximum(jnp.minimum(v1, trv),
                                      jnp.maximum(v2, trn))
                    return (nv1, ni1, nv2), (tcv, tci, tcn)

                init2 = (jnp.full((n1_tile,), -jnp.inf, jnp.float32),
                         jnp.zeros((n1_tile,), jnp.int32),
                         jnp.full((n1_tile,), -jnp.inf, jnp.float32))
                (rv, ri, rn), (cvs, cis, cns) = jax.lax.scan(
                    step, init2,
                    (d2t, l2t, jnp.arange(ntile, dtype=jnp.int32)))
                tcv = cvs.reshape(-1)
                tci = cis.reshape(-1)
                tcn = cns.reshape(-1)
                ncv = jnp.maximum(cv0, tcv)
                nci = jnp.where(tcv > cv0, tci, ci0)
                ncn = jnp.maximum(jnp.minimum(cv0, tcv),
                                  jnp.maximum(cn0, tcn))
                return (ncv, nci, ncn), (rv, ri, rn)

            init = (jnp.full((n2p,), -jnp.inf, jnp.float32),
                    jnp.zeros((n2p,), jnp.int32),
                    jnp.full((n2p,), -jnp.inf, jnp.float32))
            (cvp, cip, cnp_), (rvs, ris, rns) = jax.lax.scan(
                row_tile, init,
                (d1t, l1t, jnp.arange(nrt, dtype=jnp.int32)))
            rv = rvs.reshape(-1)[:nloc]
            ri = ris.reshape(-1)[:nloc]
            rn = rns.reshape(-1)[:nloc]
            cv = cvp[:n2]
            ci = cip[:n2]
            cn = cnp_[:n2]

        def accept(bv, nv):
            dist = jnp.arccos(jnp.minimum(bv * INV_512_SQ, 1.0))
            distn = jnp.arccos(jnp.clip(nv * INV_512_SQ, -1.0, 1.0))
            return (dist < distmax) & (dist < distn * ratiomax)

        row_match = jnp.where(accept(rv, rn) & (rv > 0), ri, -1)

        if not mutual_best:
            return row_match

        # column side stats (computed above, per tile in map-scale mode):
        # combine across shards with an all-gather (small: (3, N2) each)
        all_cv = jax.lax.all_gather(cv, axis)      # (n_shards, N2)
        all_ci = jax.lax.all_gather(ci, axis)
        all_cn = jax.lax.all_gather(cn, axis)

        best_shard = jnp.argmax(all_cv, axis=0)    # (N2,)
        n2g = all_cv.shape[1]
        cols = jnp.arange(n2g)
        best_v = all_cv[best_shard, cols]
        best_i = all_ci[best_shard, cols]
        # global second-best: max of (per-shard seconds, other shards' bests)
        masked = jnp.where(jax.nn.one_hot(best_shard, all_cv.shape[0],
                                          dtype=jnp.bool_, axis=0),
                           all_cn, all_cv)
        second_v = jnp.max(masked, axis=0)

        col_match = jnp.where(accept(best_v, second_v) & (best_v > 0),
                              best_i, -1)
        mutual = col_match[jnp.clip(row_match, 0, n2g - 1)] == \
            (jnp.arange(nloc) + shard * nloc)
        return jnp.where((row_match >= 0) & mutual, row_match, -1)

    in_specs = [P(axis, None), P(None, None)]
    args = [jax.device_put(d1, NamedSharding(mesh, P(axis, None))),
            jax.device_put(d2, NamedSharding(mesh, P(None, None)))]
    if guided:
        in_specs += [P(axis, None), P(None, None)]
        args += [jax.device_put(jnp.asarray(loc1, jnp.float32),
                                NamedSharding(mesh, P(axis, None))),
                 jax.device_put(jnp.asarray(loc2, jnp.float32),
                                NamedSharding(mesh, P(None, None)))]
    fn = jax.jit(jax.shard_map(local_fn, mesh=mesh,
                               in_specs=tuple(in_specs),
                               out_specs=P(axis),
                               # the scan carry in map-scale mode starts
                               # unvarying; skip the varying-mesh-axes check
                               check_vma=False))
    return fn(*args)[:n1]
