#!/usr/bin/env python3
"""Smoke check of the system's main paths on one GPU.

Runs each deployment once through its public entry point, on inputs
rendered in-repo from --seed, and compares every result with the same jnp
program run on this process's CPU device (or with a NumPy reference):

  1. VO frame: HessianSift.run on a 640x480 frame, Hessian and DoG.
  2. Batch: parallel.batch.detect_batch on 16 frames of 640x480.
  3. Photo: HessianSift.run on one 2048x1536 image.
  4. Descriptor service: describe_keypoints on the phase-1 keypoints.
  5. Matching: SiftMatcher.match between two views of one scene.
  6. BA: 10 LM steps at 64 cameras / 4096 points / 32k observations and
     at 256 cameras / 100k points / 1M observations.

Every line but the last is a report: the card's name and power limit,
then one JSON object per phase with compile time, steady time, memory,
per-stage device ms and the observed differences from the reference. The
last line is {"ok": true, "device": {...}}. A failed phase raises, so
the script exits non-zero and prints no "ok". Without a GPU it refuses.

    python chip_smoke.py                # one GPU, all phases
    python chip_smoke.py --photo-ref    # also compare phase 3 with the CPU
    python chip_smoke.py --four         # four GPUs: only the sharded paths
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from hessgpu_tpu import HessianSift, SiftConfig, SiftMatcher  # noqa: E402
from hessgpu_tpu.describe import describe_keypoints  # noqa: E402
from hessgpu_tpu.features import to_numpy_trimmed  # noqa: E402
from hessgpu_tpu.matcher import quantize_descriptors  # noqa: E402
from hessgpu_tpu.sfm.synthetic import scene_views  # noqa: E402
from hessgpu_tpu.utils.timing import device_stage_breakdown  # noqa: E402

# Tolerances against the CPU run of the same program. Convolutions run at
# Precision.HIGHEST, but exp/atan2, FMA contraction and summation order
# differ between backends, so keypoints near the threshold can flip, and
# an orientation whose histogram has two near-equal neighbour bins can
# move. Hence the bounds on fractions: at least MATCHED_MIN of the CPU's
# keypoints have a GPU twin, and at least MATCHED_MIN have one that also
# agrees in orientation and descriptor.
COUNT_RTOL = 0.01        # feature count within 1% of the CPU's
MATCHED_MIN = 0.99       # CPU keypoints with a GPU twin (level, type)...
KP_TOL_PX = 0.01         # ...within this distance in x and in y
THETA_TOL = 1e-3         # rad, modulo 2*pi, for an agreeing pair
DESC_TOL = 1e-3          # L2 between normalized descriptors, agreeing pair
BA_COST_RTOL = 1e-3      # final LM cost, relative
BA_RMSE_RTOL = 0.01      # final reprojection RMSE, relative

FRAME = (480, 640)       # TUM RGB-D
PHOTO = (1536, 2048)     # the reference's statistics.pdf image size
BATCH = 16
BA_SMALL = dict(cams=64, pts=4096, see_every=8)        # ~32k observations
BA_LARGE = dict(cams=256, pts=100_000, see_every=25)   # ~1M observations
BA_ITERS = 10


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def report(phase: str, **fields) -> dict:
    fields = {"phase": phase, **fields}
    print(json.dumps(fields, default=float), flush=True)
    return fields


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _angdiff(a, b):
    d = np.abs(np.mod(a - b, 2 * np.pi))
    return np.minimum(d, 2 * np.pi - d)


def compare_features(got: dict, ref: dict, label: str) -> dict:
    """Observed differences of a feature set from its reference; raises
    SmokeFailure past the tolerances above.

    A reference keypoint's twin is a keypoint of the same level and type
    within KP_TOL_PX in x and y; among several (multi-orientation
    duplicates) the one nearest in orientation. The pair agrees if its
    orientations are within THETA_TOL and its descriptors within
    DESC_TOL. max_dtheta and max_desc_l2 are taken over all twins."""
    n_got, n_ref = len(got["x"]), len(ref["x"])
    count_rel = abs(n_got - n_ref) / max(n_ref, 1)
    matched = agree = 0
    dth, dd = [0.0], [0.0]
    for i in range(n_ref):
        c = np.nonzero((got["level"] == ref["level"][i])
                       & (got["ftype"] == ref["ftype"][i])
                       & (np.abs(got["x"] - ref["x"][i]) <= KP_TOL_PX)
                       & (np.abs(got["y"] - ref["y"][i]) <= KP_TOL_PX))[0]
        if len(c) == 0:
            continue
        matched += 1
        j = c[np.argmin(_angdiff(got["theta"][c], ref["theta"][i]))]
        dth.append(float(_angdiff(got["theta"][j], ref["theta"][i])))
        g = got["desc"][j] / max(np.linalg.norm(got["desc"][j]), 1e-12)
        r = ref["desc"][i] / max(np.linalg.norm(ref["desc"][i]), 1e-12)
        dd.append(float(np.linalg.norm(g - r)))
        agree += dth[-1] <= THETA_TOL and dd[-1] <= DESC_TOL
    obs = dict(count=n_got, count_ref=n_ref, count_rel=count_rel,
               matched_frac=matched / max(n_ref, 1),
               agree_frac=agree / max(n_ref, 1),
               max_dtheta=max(dth), max_desc_l2=max(dd))
    check(n_ref > 0, f"{label}: the reference found no features")
    check(count_rel <= COUNT_RTOL, f"{label}: count {obs}")
    check(obs["matched_frac"] >= MATCHED_MIN, f"{label}: keypoints {obs}")
    check(obs["agree_frac"] >= MATCHED_MIN,
          f"{label}: orientation/descriptor agreement {obs}")
    return obs


def match_numpy(d1: np.ndarray, d2: np.ndarray, distmax: float = 0.7,
                ratiomax: float = 0.8) -> np.ndarray:
    """Brute-force mutual-best ratio-test matcher on u8 descriptors with
    int64 dot products: the plain reference for SiftMatcher. Returns
    (M, 2) index pairs in row order."""
    dots = d1.astype(np.int64) @ d2.astype(np.int64).T
    inv = np.float32(1.0 / (512.0 * 512.0))

    def best_two(mat):
        bi = np.argmax(mat, axis=1)
        bv = mat[np.arange(len(mat)), bi]
        rest = mat.astype(np.float64)
        rest[np.arange(len(mat)), bi] = -np.inf
        return bi, bv, rest.max(axis=1) if mat.shape[1] > 1 else \
            np.full(len(mat), -np.inf)

    def accept(bv, nv):
        dist = np.arccos(np.minimum(bv.astype(np.float32) * inv,
                                    np.float32(1.0)))
        distn = np.arccos(np.clip(nv.astype(np.float32) * inv,
                                  np.float32(-1.0), np.float32(1.0)))
        return (dist < np.float32(distmax)) & \
            (dist < distn * np.float32(ratiomax)) & (bv > 0)

    ri, rv, rn = best_two(dots)
    ci, cv, cn = best_two(dots.T)
    row = np.where(accept(rv, rn), ri, -1)
    col = np.where(accept(cv, cn), ci, -1)
    rows = np.nonzero((row >= 0) & (col[np.clip(row, 0, None)]
                                    == np.arange(len(row))))[0]
    return np.stack([rows, row[rows]], axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _device_peak_bytes(jax):
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _timed_run(cfg, img, device=None):
    """(features of the first run, first-run s, steady-run s) of
    HessianSift.run; the first run includes compilation."""
    import contextlib

    import jax

    ctx = jax.default_device(device) if device is not None \
        else contextlib.nullcontext()
    with ctx:
        sift = HessianSift(cfg)
        t0 = time.perf_counter()
        feats = sift.run(img)
        t1 = time.perf_counter()
        sift.run(img)
        t2 = time.perf_counter()
    return feats, t1 - t0, t2 - t1


def _memory_analysis(jitted, *args) -> dict:
    ma = jitted.lower(*args).compile().memory_analysis()
    if ma is None:
        return {}
    return {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, k)}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_vo_frame(seed: int, h: int, w: int, ref_device,
                   breakdown: bool = True) -> dict:
    """HessianSift.run on one frame, Hessian then DoG, each against the
    reference device. Returns the frame and both feature sets."""
    from hessgpu_tpu.pyramid import prepare_input, run_pipeline_jit

    frame = scene_views(seed, h, w)[0]
    out = {"frame": frame}
    for name, cfg in (("hessian", SiftConfig()),
                      ("dog", SiftConfig(detector="dog"))):
        check(not cfg.fail_soft, "fail_soft must stay off")
        feats, first, steady = _timed_run(cfg, frame)
        ref, ref_first, _ = _timed_run(cfg, frame, ref_device)
        obs = compare_features(feats, ref, f"frame/{name}")
        extra = {}
        if breakdown and name == "hessian":
            args = prepare_input(frame, cfg)
            extra["memory"] = _memory_analysis(run_pipeline_jit, *args)
            extra["stage_ms"] = dict(
                device_stage_breakdown(run_pipeline_jit, *args))
        report(f"1.frame.{name}", size=[h, w], first_call_s=first,
               steady_ms=steady * 1e3, ref_first_call_s=ref_first,
               **obs, **extra)
        out[name] = feats
        out[name + "_ref"] = ref
    return out


def phase_batch(seed: int, h: int, w: int, batch: int, frame, ref,
                breakdown: bool = True) -> dict:
    """detect_batch on `batch` frames whose first is `frame`; frame 0 is
    compared with `ref`, the reference features of `frame`."""
    import jax
    import jax.numpy as jnp

    from hessgpu_tpu.parallel.batch import _batched_pipeline, detect_batch
    from hessgpu_tpu.pyramid import _CfgKey, make_plan

    others = scene_views(seed, h, w,
                         positions=np.linspace(0.0, 1.0, batch - 1))
    imgs = np.concatenate([frame[None], others]).astype(np.float32)
    cfg = SiftConfig()
    t0 = time.perf_counter()
    table = jax.block_until_ready(detect_batch(imgs, cfg))
    t1 = time.perf_counter()
    jax.block_until_ready(detect_batch(imgs, cfg))
    t2 = time.perf_counter()
    first = to_numpy_trimmed(jax.tree.map(lambda a: a[0], table))
    obs = compare_features(first, ref, "batch/frame0")
    counts = np.asarray(table.count())
    extra = {}
    if breakdown:
        args = (jnp.asarray(imgs), make_plan(h, w, cfg), _CfgKey(cfg))
        extra["memory"] = _memory_analysis(_batched_pipeline, *args)
        extra["stage_ms"] = dict(
            device_stage_breakdown(_batched_pipeline, *args))
    report("2.batch", size=[batch, h, w], first_call_s=t1 - t0,
           steady_ms=(t2 - t1) * 1e3, counts=counts.tolist(), **obs,
           **extra)
    return {"imgs": imgs, "table": table}


def phase_photo(seed: int, h: int, w: int, ref_device=None,
                breakdown: bool = True) -> dict:
    """HessianSift.run on one photo-sized image; compared with the
    reference device only when one is given."""
    from hessgpu_tpu.pyramid import prepare_input, run_pipeline_jit

    img = scene_views(seed + 1, h, w)[0]
    cfg = SiftConfig()
    feats, first, steady = _timed_run(cfg, img)
    check(len(feats["x"]) > 0, "photo: no features")
    check(all(np.isfinite(feats[k]).all() for k in ("x", "y", "desc")),
          "photo: non-finite output")
    obs = {"count": len(feats["x"])}
    if ref_device is not None:
        ref, _, _ = _timed_run(cfg, img, ref_device)
        obs = compare_features(feats, ref, "photo")
    extra = {}
    if breakdown:
        args = prepare_input(img, cfg)
        extra["memory"] = _memory_analysis(run_pipeline_jit, *args)
        extra["stage_ms"] = dict(
            device_stage_breakdown(run_pipeline_jit, *args))
    report("3.photo", size=[h, w], first_call_s=first,
           steady_ms=steady * 1e3, **obs, **extra)
    return feats


def phase_describe(frame, feats: dict, ref_device) -> dict:
    """describe_keypoints on given keypoints, against the reference."""
    import jax

    keys = np.stack([feats["x"], feats["y"], feats["sigma"],
                     feats["theta"]], axis=1)
    t0 = time.perf_counter()
    got = describe_keypoints(frame, keys, SiftConfig())
    t1 = time.perf_counter()
    describe_keypoints(frame, keys, SiftConfig())
    t2 = time.perf_counter()
    with jax.default_device(ref_device):
        ref = describe_keypoints(frame, keys, SiftConfig())
    dd = np.linalg.norm(got["desc"] - ref["desc"], axis=1)
    obs = dict(count=len(keys), max_desc_l2=float(dd.max(initial=0.0)),
               theta_equal=bool(np.array_equal(got["theta"], ref["theta"])))
    check(len(keys) > 0, "describe: no keypoints")
    check(obs["max_desc_l2"] <= DESC_TOL, f"describe: {obs}")
    check(obs["theta_equal"], "describe: given orientations not kept")
    report("4.describe", first_call_s=t1 - t0, steady_ms=(t2 - t1) * 1e3,
           **obs)
    return got


def phase_match(seed: int, h: int, w: int) -> dict:
    """SiftMatcher.match between two views of one scene against the
    NumPy brute-force matcher on the same u8 descriptors."""
    v = scene_views(seed + 2, h, w, positions=(0.45, 0.55))
    sift = HessianSift(SiftConfig())
    f1 = sift.run(v[0])
    f2 = sift.run(v[1])
    matcher = SiftMatcher()
    t0 = time.perf_counter()
    m = matcher.match(f1, f2)
    t1 = time.perf_counter()
    matcher.match(f1, f2)
    t2 = time.perf_counter()
    want = match_numpy(quantize_descriptors(f1["desc"]),
                       quantize_descriptors(f2["desc"]))
    check(len(want) > 0, "match: the reference found no matches")
    check(np.array_equal(m, want),
          f"match: {len(m)} matches vs {len(want)} from NumPy")
    report("5.match", sizes=[len(f1["x"]), len(f2["x"])], matches=len(m),
           identical=True, first_call_s=t1 - t0, steady_ms=(t2 - t1) * 1e3)
    return {"f1": f1, "f2": f2, "matches": m}


def _lm_run(state, prob, iters: int, device=None):
    """(final state, final cost, rmse, first-call s, per-iteration s) of
    `iters` lm_step calls from `state`; the first call, which compiles,
    is timed apart and not counted."""
    import contextlib

    import jax
    import jax.numpy as jnp

    from hessgpu_tpu.sfm.ba import lm_step, reprojection_rmse

    ctx = jax.default_device(device) if device is not None \
        else contextlib.nullcontext()
    with ctx:
        if device is not None:
            state, prob = jax.device_put((state, prob), device)
        lam0 = jnp.asarray(1e-3)
        t0 = time.perf_counter()
        jax.block_until_ready(lm_step(state, prob, lam0))
        first = time.perf_counter() - t0
        s, lam = state, lam0
        t0 = time.perf_counter()
        for _ in range(iters):
            s, lam, c0, c1, _acc = lm_step(s, prob, lam)
        jax.block_until_ready(s)
        per_iter = (time.perf_counter() - t0) / iters
        cost = float(jnp.minimum(c0, c1))
        rmse = reprojection_rmse(s, prob)
    return s, cost, rmse, first, per_iter


def phase_ba(name: str, cams: int, pts: int, see_every: int, iters: int,
             ref_device) -> dict:
    """lm_step on a seeded problem against the reference device."""
    import jax.numpy as jnp

    from bench_ba import _make_problem

    state, prob = _make_problem(np, jnp, cams, pts, see_every)
    _, cost, rmse, first, per_iter = _lm_run(state, prob, iters)
    _, rcost, rrmse, _, ref_iter = _lm_run(state, prob, iters, ref_device)
    obs = dict(obs=int(prob.uv.shape[0]), cost=cost, cost_ref=rcost,
               cost_rel=abs(cost - rcost) / abs(rcost), rmse=rmse,
               rmse_ref=rrmse, rmse_rel=abs(rmse - rrmse) / rrmse,
               first_call_s=first, ms_per_iter=per_iter * 1e3,
               ref_ms_per_iter=ref_iter * 1e3)
    check(np.isfinite(cost) and np.isfinite(rmse), f"ba/{name}: non-finite")
    check(obs["cost_rel"] <= BA_COST_RTOL, f"ba/{name}: cost {obs}")
    check(obs["rmse_rel"] <= BA_RMSE_RTOL, f"ba/{name}: rmse {obs}")
    report(f"6.ba.{name}", cams=cams, pts=pts, iters=iters, **obs)
    return obs


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _devices_of(a) -> int:
    return len(a.sharding.device_set)


def run_four(seed: int, h: int, w: int, batch: int, ba_sizes: dict,
             n: int = 4) -> None:
    """The paths that span devices, on the first n devices, each against
    its one-device result."""
    import jax
    import jax.numpy as jnp

    from bench_ba import _make_problem
    from hessgpu_tpu.parallel.batch import data_parallel_mesh, detect_batch
    from hessgpu_tpu.parallel.distributed import device_mesh, match_sharded
    from hessgpu_tpu.sfm.ba import reprojection_rmse
    from hessgpu_tpu.sfm.distributed_ba import bundle_adjust_sharded

    check(len(jax.devices()) >= n,
          f"needs {n} devices, found {len(jax.devices())}")

    # data-parallel detect: n-device mesh against one device
    frames = scene_views(seed, h, w, positions=np.linspace(0, 1, batch))
    one = jax.block_until_ready(detect_batch(frames, SiftConfig()))
    mesh = data_parallel_mesh(n)
    t0 = time.perf_counter()
    four = jax.block_until_ready(detect_batch(frames, SiftConfig(),
                                              mesh=mesh))
    t1 = time.perf_counter()
    jax.block_until_ready(detect_batch(frames, SiftConfig(), mesh=mesh))
    t2 = time.perf_counter()
    check(_devices_of(four.x) == n,
          f"detect_batch output not on {n} devices")
    worst = {"count_rel": 0.0, "matched_frac": 1.0, "agree_frac": 1.0,
             "max_dtheta": 0.0, "max_desc_l2": 0.0}
    for b in range(batch):
        obs = compare_features(
            to_numpy_trimmed(jax.tree.map(lambda a: a[b], four)),
            to_numpy_trimmed(jax.tree.map(lambda a: a[b], one)),
            f"four/detect[{b}]")
        for k in ("count_rel", "max_dtheta", "max_desc_l2"):
            worst[k] = max(worst[k], obs[k])
        for k in ("matched_frac", "agree_frac"):
            worst[k] = min(worst[k], obs[k])
    report("4x.detect_batch", size=[batch, h, w], devices=n,
           first_call_s=t1 - t0, steady_ms=(t2 - t1) * 1e3, **worst)

    # observation-sharded BA against single-device lm_step
    dmesh = device_mesh("obs", n)
    for name, size in ba_sizes.items():
        state, prob = _make_problem(np, jnp, **size)
        _, cost1, rmse1, _, _ = _lm_run(state, prob, BA_ITERS)
        t0 = time.perf_counter()
        s4, cost4 = bundle_adjust_sharded(state, prob, dmesh,
                                          iterations=BA_ITERS)
        t1 = time.perf_counter()
        check(_devices_of(s4.X) == n, f"BA state not on {n} devices")
        rmse4 = reprojection_rmse(s4, prob)
        obs = dict(obs=int(prob.uv.shape[0]), cost=cost4, cost_one=cost1,
                   cost_rel=abs(cost4 - cost1) / abs(cost1), rmse=rmse4,
                   rmse_one=rmse1, rmse_rel=abs(rmse4 - rmse1) / rmse1,
                   wall_s_incl_compile=t1 - t0)
        check(obs["cost_rel"] <= BA_COST_RTOL, f"four/ba/{name}: {obs}")
        check(obs["rmse_rel"] <= BA_RMSE_RTOL, f"four/ba/{name}: {obs}")
        report(f"4x.ba.{name}", devices=n, **obs)

    # row-sharded matcher against SiftMatcher
    v = scene_views(seed + 2, h, w, positions=(0.45, 0.55))
    sift = HessianSift(SiftConfig())
    d1 = quantize_descriptors(sift.run(v[0])["desc"])
    d2 = quantize_descriptors(sift.run(v[1])["desc"])
    m = SiftMatcher()
    m.set_descriptors(0, d1)
    m.set_descriptors(1, d2)
    want = m.get_sift_match()
    rm = match_sharded(jnp.asarray(d1), jnp.asarray(d2),
                       device_mesh("rows", n))
    check(_devices_of(rm) == n, f"match rows not on {n} devices")
    rm = np.asarray(rm)
    rows = np.nonzero(rm >= 0)[0]
    got = np.stack([rows, rm[rows]], axis=1).astype(np.int32)
    check(len(want) > 0 and np.array_equal(got, want),
          f"four/match: {len(got)} vs {len(want)} matches")
    report("4x.match_sharded", devices=n, matches=len(got), identical=True)


# ---------------------------------------------------------------------------

def card_lines() -> list:
    """nvidia-smi's name and power limit per card, read by a child that
    does not touch JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return [l.strip() for l in r.stdout.splitlines() if l.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device paths")
    ap.add_argument("--photo-ref", action="store_true",
                    help="compare the 2048x1536 photo with the CPU too")
    args = ap.parse_args(argv)

    import jax

    # the reference runs on this process's CPU device beside the GPU
    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU, JAX's default backend is "
              f"{backend!r}", file=sys.stderr)
        return 2

    from hessgpu_tpu.utils.compile_cache import enable_compile_cache

    for line in card_lines():
        print(line, flush=True)
    print(f"jax {jax.__version__}, compile cache "
          f"{enable_compile_cache()}", flush=True)

    if args.four:
        run_four(args.seed, *FRAME, BATCH,
                 {"small": BA_SMALL, "large": BA_LARGE})
    else:
        cpu = jax.devices("cpu")[0]
        h, w = FRAME
        vo = phase_vo_frame(args.seed, h, w, cpu)
        phase_batch(args.seed, h, w, BATCH, vo["frame"], vo["hessian_ref"])
        phase_photo(args.seed, *PHOTO, cpu if args.photo_ref else None)
        phase_describe(vo["frame"], vo["hessian"], cpu)
        phase_match(args.seed, h, w)
        phase_ba("small", **BA_SMALL, iters=BA_ITERS, ref_device=cpu)
        phase_ba("large", **BA_LARGE, iters=BA_ITERS, ref_device=cpu)
    report("memory", peak_bytes_in_use=_device_peak_bytes(jax))

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
