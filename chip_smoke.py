#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path — ES odometry through ``ESPipeline`` at the full
width of ``kitti_config()`` (HDL-64, 1800 azimuth, 131072-point scans) on the
pinned v1 protocol of ``bench.py`` (``make_city_world(seed=7)``,
``make_loop_trajectory(300, speed=1.5)``, 10 warm-up frames, drift scored at
100-300 m) — and checks it:

1. device: the card's name and power limit; TF32 off;
2. build: compiles ``pfilter_tpu_torch/csrc/*.cu`` with nvcc;
3. the kNN kernel against its plain PyTorch version on the pipeline's own
   edge and surf maps and queries, and on edge cases (empty tiles, a halo
   row over the cap, invalid queries, clipped border tiles);
4. the pipeline: fps, drift, ATE, overflow, kernel launches
   (must equal 2 x (frames - 1)), drift below the reference's 0.783 %;
5. the first 20 frames again with the plain kNN on the card: poses must
   match the kernel run;
6. CUDA-event times of the kernel, its plain version, and (as a yardstick
   only) ``torch.cdist`` + ``torch.topk`` over the whole map;
7. where a steady frame's time goes (torch.profiler: host time per stage,
   kernel launches, the device's busy share) and which calls synchronise
   the host while a frame is dispatched.

Exits non-zero, without the final line, if any phase fails or no CUDA card
is present.  The last two lines are a JSON ``kernels`` record and
``{"ok": true, "device": {...}}``, preceded by the nvidia-smi line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

FRAMES = 300
WARMUP = 10
SPEED = 1.5
AZIMUTH = 1800
LENGTHS = (100.0, 200.0, 300.0)
DRIFT_BAR = 0.783  # the C++ reference's KITTI drift (BASELINE.md)
PLAIN_FRAMES = 20
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-4
REPEATS = 50
PROFILE_FRAMES = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
FLOPS_PER_PAIR = 8  # 3 sub + 3 mul + 2 add per (query, candidate)


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rotation_angle(q1, q2) -> np.ndarray:
    """Angle (rad) of the relative rotation between wxyz quaternions, per row."""
    a, b = np.asarray(q1, np.float64), np.asarray(q2, np.float64)
    w = np.sum(a * b, axis=1)  # real part of conj(a) * b
    v = a[:, :1] * b[:, 1:] - b[:, :1] * a[:, 1:] - np.cross(a[:, 1:], b[:, 1:])
    return 2.0 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w))


def render_all(cfg, world, poses, synthetic, dev):
    """All frames rendered on the card up front, padded to scan_points
    (rendering is input generation, not the system under test)."""
    cap = cfg.capacity.scan_points
    frames = []
    for i in range(len(poses.t)):
        pose = synthetic.se3.Pose(q=poses.q[i], t=poses.t[i])
        xyz, valid = synthetic.render_scan(pose, world, cfg.lidar, AZIMUTH, noise=0.008, seed=0, t_time=float(i), device=dev)
        n = min(xyz.shape[0], cap)
        x = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
        v = torch.zeros(cap, dtype=torch.bool, device=dev)
        x[:n], v[:n] = xyz[:n], valid[:n]
        frames.append((x, v))
    torch.cuda.synchronize()
    return frames


def frame_queries(pipe_cfg, state, xyz, valid):
    """The edge and surf kNN inputs of the next step: the main path's own
    compaction, downsampling and tile sort at the constant-velocity pose."""
    from pfilter_tpu_torch.models import es_odometry as es, map_state
    from pfilter_tpu_torch.ops import features, se3, voxel

    cfg = pipe_cfg
    o, cap = cfg.odometry, cfg.capacity
    feat = features.extract_features(xyz, valid, cfg.lidar, cfg.features, cap)
    pred = se3.constant_velocity_predict(state.pose, state.last_pose)
    out = {}
    for kind, mask, n_pts, n_ds, leaf, tmap in (
        ("edge", feat.edge_mask, cap.edge_points, cap.ds_edge_points, o.map_resolution, state.edge_map),
        ("surf", feat.surf_mask, cap.surf_points, cap.ds_surf_points, 2 * o.map_resolution, state.surf_map),
    ):
        p, v, _ = es._compact_idx(feat.xyz, mask, n_pts)
        ds, _ = voxel.voxel_downsample_rgbds_counted(voxel.PointSet(p, torch.zeros_like(p[:, :2]), v), leaf, n_ds)
        world = se3.transform_points(pred, ds.xyz)
        qs = map_state.sort_queries_for_index(tmap, world, ds.valid, cfg, kind)
        out[kind] = (tmap, world[qs.order].contiguous(), qs.bounds, map_state._tile_params(cfg, kind))
    return out


def compare(knn, tmap, q, bounds, params, name):
    nt, tc, tcap = params
    rk = knn._query_tiled_sorted_cuda(tmap, q, bounds, nt, tc, tcap, 5)
    rp = knn.query_tiled_sorted_plain(tmap, q, bounds, nt, tc, tcap, 5)
    torch.cuda.synchronize()
    dk, dp = rk.sqdist.cpu().numpy(), rp.sqdist.cpu().numpy()
    ik, ip = rk.idx.cpu().numpy(), rp.idx.cpu().numpy()
    check(np.array_equal(np.isfinite(dk), np.isfinite(dp)), f"{name}: finite pattern differs")
    fin = np.isfinite(dk)
    err = float(np.max(np.abs(dk[fin] - dp[fin]))) if fin.any() else 0.0
    rel_ok = np.all(np.abs(dk[fin] - dp[fin]) <= 1e-6 * np.abs(dp[fin]))
    check(rel_ok, f"{name}: sqdist differs beyond rtol 1e-6 (max abs {err})")
    xt = tmap.xyz_t[:3].T.cpu().numpy()
    diff = ik != ip
    ties_ok = np.all(np.all(xt[ik[diff]] == xt[ip[diff]], axis=-1)) if diff.any() else True
    check(ties_ok, f"{name}: {int(diff.sum())} indices differ at distinct coordinates")
    log(f"  {name}: Q={q.shape[0]} finite={int(fin.sum())} idx_mismatch={int(diff.sum())} max_abs_err={err:.3e}")
    return err


def edge_case_inputs(knn, dev, params):
    """A synthetic map with one 3-tile row far over 3*tile_cap, empty tiles
    around it, invalid queries and queries clipped into the border tiles."""
    nt, tc, tcap = params
    g = torch.Generator(device="cpu").manual_seed(3)
    n_dense = 6 * tcap  # ~4.5*tile_cap of these fall in one 3-tile row
    dense = torch.rand((n_dense, 3), generator=g) * torch.tensor([3.9, 11.9, 4.0]) + torch.tensor([0.05, -5.9, -1.0])
    sparse = torch.rand((2000, 3), generator=g) * torch.tensor([80.0, 80.0, 6.0]) - torch.tensor([40.0, 40.0, 3.0])
    xyz = torch.cat([dense, sparse]).to(dev)
    cap = xyz.shape[0] + 512
    xyz = torch.cat([xyz, torch.zeros((512, 3), device=dev)])
    valid = torch.arange(cap, device=dev) < cap - 512
    origin = knn.tile_origin_for_pose(torch.zeros(3, device=dev), nt, tc)
    tmap = knn.build_tiled(xyz, torch.zeros((cap, 2), device=dev), valid, origin, nt, tc, tcap)
    q = torch.cat(
        [
            torch.rand((3000, 3), generator=g) * torch.tensor([10.0, 16.0, 4.0]) - torch.tensor([3.0, 8.0, 1.0]),
            torch.rand((1000, 3), generator=g) * 600.0 - 300.0,  # mostly beyond the window: border tiles
        ]
    ).to(dev)
    qv = torch.rand(q.shape[0], generator=g).to(dev) > 0.1  # ~10 % invalid
    qs = knn.sort_queries(q, qv, origin, nt, tc)
    return tmap, q[qs.order].contiguous(), qs.bounds


def time_cuda(fn, repeats=REPEATS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(repeats):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / repeats


def knn_bound(knn, tmap, q, bounds, params):
    """Least time for this call: bytes it must move (queries, live map
    coordinates, tile ranges read once; results written once) over HBM
    bandwidth, and the (query, candidate) distance work this data needs over
    the fp32 rate."""
    nt, tc, tcap = params
    nt2 = nt * nt
    _, c_cnt = knn._halo_ranges(tmap, nt, 3 * tcap)
    per_tile = (bounds[1:] - bounds[:-1]).to(torch.float64)
    pairs = float((per_tile * c_cnt.sum(-1).to(torch.float64)).sum())
    live = int(tmap.tile_start[nt2])
    nbytes = q.shape[0] * 12 + live * 12 + 2 * 4 * (nt2 + 1) + 12 + q.shape[0] * 5 * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * FLOPS_PER_PAIR / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), pairs, nbytes


def profile_steady_frames(cfg, frames, ESPipeline):
    """Profile frames WARMUP..WARMUP+PROFILE_FRAMES of a fresh run, with a
    span around each stage of the step (wrapped here, not in the package):
    host time per stage, kernel launches per frame, and the device's busy
    share of the wall time (profiler on, so the wall is inflated)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from pfilter_tpu_torch.models import es_odometry, map_state
    from pfilter_tpu_torch.ops import features, pose_graph

    stages = [
        (features, "extract_features"),
        (es_odometry, "_es_outer_assoc_once"),
        (pose_graph, "smoothed_newest"),
        (map_state, "merge_scan_into_index"),
    ]
    originals = [(mod, name, getattr(mod, name)) for mod, name in stages]

    def spanned(name, fn):
        def run(*args, **kwargs):
            with record_function("stage::" + name):
                return fn(*args, **kwargs)

        return run

    pipe = ESPipeline(cfg, sync=False, fetch_lag=4)
    for i in range(WARMUP):
        pipe.process_frame(*frames[i])
    pipe.flush()
    torch.cuda.synchronize()
    try:
        for mod, name, fn in originals:
            setattr(mod, name, spanned(name, fn))
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(WARMUP, WARMUP + PROFILE_FRAMES):
                pipe.process_frame(*frames[i])
            pipe.flush()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    events = prof.key_averages()
    # Device rows of the stage spans cover their whole time range, gaps
    # included; only real kernels count toward the busy time.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.key.startswith("stage::")]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    per = PROFILE_FRAMES
    log(f"  wall {wall_ms / per:.1f} ms/frame (profiled); device busy {device_us / 1e3 / per:.1f} ms/frame "
        f"= {device_us / 1e3 / wall_ms * 100:.1f} % of wall; kernel launches {launches / per:.0f}/frame")
    for e in sorted(events, key=lambda e: -e.cpu_time_total):
        if e.key.startswith("stage::") and e.device_type == DeviceType.CPU:
            log(f"  stage {e.key[7:]}: host {e.cpu_time_total / 1e3 / per:.1f} ms/frame, "
                f"its kernels {e.device_time_total / 1e3 / per:.2f} ms/frame")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  kernel {e.key[:70]}: {e.self_device_time_total / 1e3 / per:.2f} ms/frame, {e.count / per:.0f} launches/frame")

    # Host synchronisations in a frame's dispatch (the lagged fetch put out
    # of reach): PyTorch's sync debug mode warns at each synchronising call.
    pipe.fetch_lag = 10**6
    first = WARMUP + PROFILE_FRAMES
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(first, first + 2):
                pipe.process_frame(*frames[i])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted(
        {f"{Path(w.filename).name}:{w.lineno}" for w in caught if "called a synchronizing CUDA operation" in str(w.message)}
    )
    log(f"  host syncs while dispatching 2 frames: {len(syncs)} call sites {syncs}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from pfilter_tpu_torch.config import kitti_config
    from pfilter_tpu_torch.ops import _build
    from pfilter_tpu_torch.ops import knn_tiled as knn
    from pfilter_tpu_torch.pipeline import ESPipeline
    from pfilter_tpu_torch.utils import metrics, synthetic

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    log("== phase 1: device")
    smi = nvidia_smi_line()
    log(f"  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 2: build")
    _build.load()
    log(f"  built {_build.BUILD_INFO['path']} in {_build.BUILD_INFO['seconds']:.1f} s")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "smem" in line or "error" in line.lower():
            log(f"  ptxas: {line.strip()}")

    cfg = kitti_config()
    world = synthetic.make_city_world(seed=7)
    poses = synthetic.make_loop_trajectory(FRAMES, speed=SPEED)
    t0 = time.perf_counter()
    frames = render_all(cfg, world, poses, synthetic, dev)
    log(f"  rendered {FRAMES} scans on the card in {time.perf_counter() - t0:.1f} s")

    log("== phase 4: pipeline on the card (kitti_config, v1 protocol)")
    pipe = ESPipeline(cfg, sync=False, fetch_lag=4)
    knn.KERNEL_LAUNCHES = 0
    for i in range(WARMUP):
        pipe.process_frame(*frames[i])
    pipe.flush()
    torch.cuda.synchronize()
    t_steady = time.perf_counter()
    for i in range(WARMUP, FRAMES):
        pipe.process_frame(*frames[i])
    pipe.flush()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t_steady
    launches = knn.KERNEL_LAUNCHES
    fps = (FRAMES - WARMUP) / steady_s
    q_est, t_est = pipe.trajectory
    gt = metrics.poses_to_matrices(np.asarray(poses.q), np.asarray(poses.t))
    gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    est = metrics.poses_to_matrices(q_est, t_est)
    path = metrics.trajectory_distances(gt)[-1]
    lengths = tuple(length for length in LENGTHS if length <= path * 0.8)
    drift = metrics.kitti_drift(gt, est, lengths=lengths, step=10)
    ate = metrics.ate_rmse(gt, est)
    log(f"  frames/s {fps:.3f}  ms/frame {steady_s / (FRAMES - WARMUP) * 1e3:.2f}  (steady {FRAMES - WARMUP} frames)")
    log(f"  drift_t_pct {drift['t_err_pct']:.4f}  r_err_deg_per_m {drift['r_err_deg_per_m']:.6f}  segments {drift['n_segments']}  lengths {lengths}")
    log(f"  ate_rmse_m {ate:.4f}  path_m {path:.1f}")
    log(f"  overflow_total {pipe.overflow_total}  n_dropped {pipe.n_dropped}  knn_kernel_launches {launches}")
    check(pipe.overflow_total == 0, f"overflow_total {pipe.overflow_total} != 0")
    check(np.isfinite(q_est).all() and np.isfinite(t_est).all(), "non-finite poses")
    check(launches == 2 * (FRAMES - 1), f"kernel launches {launches} != {2 * (FRAMES - 1)}")
    check(drift["n_segments"] > 0 and drift["t_err_pct"] < DRIFT_BAR, f"drift {drift['t_err_pct']} not below {DRIFT_BAR}")

    log("== phase 3: kernel vs plain version at main-path shapes")
    inputs = frame_queries(pipe.cfg, pipe.state, *frames[FRAMES - 1])
    max_err = 0.0
    for kind, (tmap, q, bounds, params) in inputs.items():
        max_err = max(max_err, compare(knn, tmap, q, bounds, params, f"{kind} map"))
    surf_params = inputs["surf"][3]
    tmap_e, q_e, b_e = edge_case_inputs(knn, dev, surf_params)
    nt, _, tcap = surf_params
    over = int(torch.clamp(knn._halo_ranges(tmap_e, nt, 10**9)[1] - 3 * tcap, min=0).max())
    n_inv = int(q_e.shape[0] - b_e[nt * nt])
    log(f"  edge cases: widest halo row over the cap by {over} slots; {n_inv} invalid queries")
    check(over > 0 and n_inv > 0, "edge-case map does not exercise the cap or invalid queries")
    max_err = max(max_err, compare(knn, tmap_e, q_e, b_e, surf_params, "edge cases"))

    log("== phase 5: first 20 frames with the plain kNN on the card")
    kernel_path = knn.query_tiled_sorted
    knn.query_tiled_sorted = knn.query_tiled_sorted_plain
    try:
        plain = ESPipeline(cfg, sync=True)
        for i in range(PLAIN_FRAMES):
            plain.process_frame(*frames[i])
    finally:
        knn.query_tiled_sorted = kernel_path
    pq, pt = plain.trajectory
    dt = float(np.max(np.linalg.norm(pt - t_est[:PLAIN_FRAMES], axis=1)))
    dr = float(np.max(rotation_angle(pq, q_est[:PLAIN_FRAMES])))
    log(f"  max pose difference: {dt:.3e} m, {dr:.3e} rad")
    check(dt <= POSE_TOL_M and dr <= POSE_TOL_RAD, f"plain-kNN poses differ: {dt} m, {dr} rad")

    log("== phase 6: times (CUDA events, %d repeats)" % REPEATS)
    per_shape = {}
    for kind, (tmap, q, bounds, params) in inputs.items():
        nt, tc, tcap = params
        ms = time_cuda(lambda: knn._query_tiled_sorted_cuda(tmap, q, bounds, nt, tc, tcap, 5))
        plain_ms = time_cuda(lambda: knn.query_tiled_sorted_plain(tmap, q, bounds, nt, tc, tcap, 5))
        mx = tmap.xyz[tmap.valid]
        yard_ms = time_cuda(lambda: torch.topk(torch.cdist(q, mx), 5, dim=1, largest=False))
        bound_ms, bound_by, pairs, nbytes = knn_bound(knn, tmap, q, bounds, params)
        per_shape[kind] = dict(
            queries=q.shape[0], map_points=int(mx.shape[0]), ms=ms, plain_ms=plain_ms,
            cdist_topk_ms=yard_ms, bound_ms=bound_ms, bound_by=bound_by, pairs=pairs, bytes=nbytes,
        )
        log(f"  {kind}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  cdist+topk (whole map, yardstick) {yard_ms:.4f} ms  "
            f"bound {bound_ms:.5f} ms ({bound_by}; {pairs:.0f} pairs, {nbytes} bytes)")
    tot = {k: sum(s[k] for s in per_shape.values()) for k in ("ms", "plain_ms", "bound_ms", "cdist_topk_ms")}
    t_bytes = sum(s["bytes"] for s in per_shape.values()) / HBM_BYTES_PER_S * 1e3

    log("== phase 7: where a frame's time goes (torch.profiler, %d steady frames)" % PROFILE_FRAMES)
    profile_steady_frames(cfg, frames, ESPipeline)
    log(f"  total wall {time.perf_counter() - t_start:.1f} s")

    kernels = {
        "kernels": [
            {
                "name": "knn_tiled",
                "route": "cuda",
                "source": "pfilter_tpu_torch/csrc/knn_tiled.cu",
                "replaces": "pfilter_tpu/ops/knn_tiled.py:174",
                "launches": launches,
                "max_abs_err": max_err,
                "ms": tot["ms"],
                "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"],
                "bound_by": "bytes" if t_bytes >= tot["bound_ms"] else "operations",
                "library_ms": None,
                "yardstick_cdist_topk_ms": tot["cdist_topk_ms"],
                "per_frame_shapes": per_shape,
            }
        ]
    }
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
