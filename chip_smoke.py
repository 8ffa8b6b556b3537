#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths through ``make_pipeline`` at the full width of
``kitti_config()`` (HDL-64, 1800 azimuth, 131072-point scans) on the pinned
v1 protocol of ``bench.py`` (``make_city_world(seed=7)``,
``make_loop_trajectory(300, speed=1.5)``, 10 warm-up frames, drift scored at
100-300 m; ES and the default BPF path run the first 150 frames, scored on
100 m segments, the radius-BPF path all 300), each with every kernel launch
count set to 0 just before it and read just after, and checks them:

1. device: the card's name and power limit; TF32 off;
2. build: compiles ``pfilter_tpu_torch/csrc/*.cu`` with nvcc (ptxas
   registers, shared memory and spills), and times an empty kernel: the
   card's launch floor, eager and inside a CUDA graph;
3. ES odometry (``mode="es"``): fps, drift, ATE, overflow, kNN launches
   (= 2 x (frames - 1)), drift below the reference's 0.783 %;
4. the kNN kernel against its plain version on that run's edge and surf
   maps and queries, on edge cases (empty tiles, a halo row over the cap,
   invalid queries, clipped border tiles) and on duplicate map points (equal
   distances on the same and on different lanes of a query; and in the
   window's first and last tile rows, where a halo reads a row twice and a
   slot ties with itself): distances and indices identical; two launches on the same inputs bitwise equal; and
   at every kernel comparison below too, the work-list kernel that both
   kernels' wrappers launch (``csrc/work_list.cu``) equal to its plain
   version, item for item, with its launches equal to the kNN's plus the
   PCA kernel's on every path;
5. the first 20 ES frames again with the plain kNN: poses must match;
6. times of the kNN kernel: ``device_ms``, the replay of a CUDA graph of
   REPEATS wrapper calls (the card's time alone), and ``call_ms``, CUDA
   events around REPEATS eager calls (host enqueue included); CUDA-event
   times of its plain version and (a yardstick only) ``torch.cdist`` +
   ``torch.topk`` over the whole map;
7. where a steady ES frame's time goes (torch.profiler), and the call sites
   that synchronise the host while four frames are dispatched (two fed as
   tensors on the card, two as numpy scans, a ``GlobalMap.update`` after
   each): none, gated;
8. BPF odometry with the default voxel front-end (``mode="bpf"``): fps,
   drift, ATE, overflow, kNN launches (= 3 x (frames - 1)), drift < 0.783 %;
9. the kNN kernel against its plain version on that run's beam, pillar and
   facade maps and queries (tile caps 128, 128, 256), and their times (as
   in 6) and bounds;
10. the first 20 default-BPF frames again with the plain kNN: poses within
    1 mm / 1e-4 rad;
11. BPF with the radius front-end (``pca.impl=radius``,
    ``capacity.frontend_tile_cap=5120``): the same as 8, plus PCA kernel
    launches (= frames) and front-end halo truncation (= 0);
12. the kNN kernel against its plain version on that run's three channels,
    and their times and bounds;
13. the widest halo row of any frame against the cap, and the PCA moment
    kernel against its plain version at that run's last-frame shapes, on
    edge cases (the same scan at tile cap 384, invalid queries, empty tiles,
    clipped border tiles) and on candidates at r (1 +- 1e-6) from queries on
    the corners of a work item's bounding box: counts exact, means within
    1e-4 m, covariances within 1e-3 m^2 per neighbour; two launches on the
    same inputs bitwise equal;
14. the first 20 radius-BPF frames again with the plain PCA: poses within
    1 mm / 1e-4 rad;
15. the PCA kernel's ``device_ms`` and ``call_ms``, its plain version and (a
    yardstick only) ``(torch.cdist(q, c) < r).float() @ F`` over the whole
    cloud; the bound from the in-ball pairs, beside the all-halo-pairs bound
    of earlier runs (``bound_halo_ms``);
16. where a steady radius-BPF frame's time goes, and its host syncs as in 7
    (tensor- and numpy-fed; none, gated);
17. the KITTI runner (``pfilter_tpu_torch.run_kitti.main``) on the loop's
    first 100 frames, rendered by the port's ``render_sequence`` and written
    as a KITTI sequence (velodyne .bin, a calib with an axis-swapping ``Tr``,
    cam0 poses), with ``--global-map 5``: the native prefetcher used and
    equal to ``read_velodyne_bin`` on every scan; drift < 0.783 %, overflow
    0, kNN launches 2 x 99; poses bit for bit those of an ``ESPipeline`` fed
    the same scans as CUDA tensors; the trajectory file equal to them to its
    9 digits; 100 JSONL lines; a finite, non-empty map and its .ply;
18. checkpoint/resume: ES and default BPF run 20 frames, save the state,
    restore it into a fresh template and run 20 more: every pose equal bit
    for bit to frames 0-39 of the runs of phases 3 and 8.

Exits non-zero, without the final line, if any phase fails or no CUDA card
is present.  The last three lines are a JSON ``kernels`` record, the
nvidia-smi line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

FRAMES = 300  # rendered scans; the radius-BPF path runs all of them
# The script must finish well inside the chip run's time limit, and the host
# takes 0.4-0.75 s per frame; the earlier paths run at 150 frames (100 m
# segments still score), the slice's kernel path at the full 300.
ES_FRAMES = 150
BPF_FRAMES = 150
WARMUP = 10
SPEED = 1.5
AZIMUTH = 1800
LENGTHS = (100.0, 200.0, 300.0)
DRIFT_BAR = 0.783  # the C++ reference's KITTI drift (BASELINE.md)
PLAIN_FRAMES = 20
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-4
REPEATS = 50
GRAPH_REPLAYS = 5  # replays of a captured graph of REPEATS calls, timed together
PROFILE_FRAMES = 1  # the profiler and its trace processing cost ~15-30 s per profiled frame
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
FLOPS_PER_PAIR = 8  # 3 sub + 3 mul + 2 add per (query, candidate)
FLOPS_PER_HIT = 16  # 10 adds + 6 products per (query, in-ball candidate)
TPU_BPF_DRIFT = 0.3609  # the reference package's BPF v1 drift on a TPU v5 lite (BENCH_r05.json)
RADIUS_OVERRIDES = ("pca.impl=radius", "capacity.frontend_tile_cap=5120")
PLAIN_REPEATS = 5
MEAN_TOL_M = 1e-4
COV_TOL_PER_POINT = 1e-3
RUNNER_FRAMES = 100  # the KITTI runner's sequence: the loop's first 100 frames (148 m, 100 m segments score)
RUNNER_MAP_STRIDE = 5
RUNNER_SEQ = "99"
KITTI_TR = [[0.0, -1.0, 0.0, 0.1], [0.0, 0.0, -1.0, -0.05], [1.0, 0.0, 0.0, 0.2]]  # velodyne -> cam0, an axis swap
RESUME_AT = 20  # checkpoint after 20 frames, resume for 20


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


def bpf_frame_queries(cfg, state, xyz, valid):
    """The beam, pillar and facade kNN inputs of the next BPF step: the main
    path's front-end, compaction, downsampling and tile sort at the
    constant-velocity pose, with the queries placed as
    ``es_odometry._associate_static`` places them."""
    from pfilter_tpu_torch.models import bpf_frontend, map_state
    from pfilter_tpu_torch.models import bpf_odometry as bo
    from pfilter_tpu_torch.models.es_odometry import _compact_idx
    from pfilter_tpu_torch.ops import se3, voxel

    cap = cfg.capacity
    fr = bpf_frontend.run_frontend(xyz, valid, cfg)
    masks = {"beam": fr.beam_mask, "pillar": fr.pillar_mask, "facade": fr.facade_mask}
    pred = se3.constant_velocity_predict(state.pose, state.last_pose)
    pose0 = se3.Pose(q=pred.q, t=torch.zeros_like(pred.t))
    out = {}
    for kind in bo.CHANNELS:
        tmap = getattr(state, kind + "_map")
        comp_cap = bo._compact_cap(cfg, kind)
        ds_cap = cap.ds_edge_points if map_state.is_line_kind(kind) else cap.ds_surf_points
        p, v, _ = _compact_idx(xyz, masks[kind], comp_cap)
        ds, _ = voxel.voxel_downsample_rgbds_counted(voxel.PointSet(p, torch.zeros_like(p[:, :2]), v), bo._leaf(cfg, kind), ds_cap)
        qs = map_state.sort_queries_for_index(tmap, se3.transform_points(pred, ds.xyz), ds.valid, cfg, kind)
        q = se3.transform_points(pose0, ds.xyz[qs.order]) + pred.t
        out[kind] = (tmap, q.contiguous(), qs.bounds, map_state._tile_params(cfg, kind))
    return out


def compare(knn, tmap, q, bounds, params, name):
    """Kernel against plain on the same inputs: distances and indices
    identical (ties go to the lower slot in both), and a second launch
    bitwise equal to the first."""
    nt, tc, tcap = params
    rk = knn._query_tiled_sorted_cuda(tmap, q, bounds, nt, tc, tcap, 5)
    rk2 = knn._query_tiled_sorted_cuda(tmap, q, bounds, nt, tc, tcap, 5)
    rp = knn.query_tiled_sorted_plain(tmap, q, bounds, nt, tc, tcap, 5)
    torch.cuda.synchronize()
    dk, dp = rk.sqdist.cpu().numpy(), rp.sqdist.cpu().numpy()
    ik, ip = rk.idx.cpu().numpy(), rp.idx.cpu().numpy()
    check(np.array_equal(np.isfinite(dk), np.isfinite(dp)), f"{name}: finite pattern differs")
    fin = np.isfinite(dk)
    err = float(np.max(np.abs(dk[fin] - dp[fin]))) if fin.any() else 0.0
    mismatch = int((ik != ip).sum())
    check(np.array_equal(dk, dp), f"{name}: sqdist differs (max abs {err})")
    check(mismatch == 0, f"{name}: {mismatch} indices differ")
    same = torch.equal(rk.sqdist, rk2.sqdist) and torch.equal(rk.idx, rk2.idx)
    check(same, f"{name}: two launches on the same inputs differ")
    n_items = compare_work_list(knn, bounds, nt, knn.CHUNK, q.shape[0], name)
    log(f"  {name}: Q={q.shape[0]} valid={int(bounds[nt * nt])} map={int(tmap.tile_start[nt * nt])} tile_cap={tcap} "
        f"items={n_items} finite={int(fin.sum())} idx_mismatch={mismatch} max_abs_err={err:.3e} run_to_run_equal={same}")
    return err


def compare_work_list(knn, bounds, nt, chunk, n_q, name):
    """The work-list kernel against its plain version: the same item count
    and the same items, row for row."""
    wk = knn.work_list(bounds, nt, chunk, n_q).cpu()
    wp = knn.work_list_plain(bounds.cpu(), nt, chunk, n_q)
    n_items = int(wp[0, 0])
    check(wk.shape == wp.shape and torch.equal(wk[: 1 + n_items, :3], wp[: 1 + n_items, :3]), f"{name}: work lists differ")
    return n_items


def duplicate_inputs(knn, dev, params):
    """A map of 300 points each stored 12 times in consecutive slots (equal
    distances on the same lane of a query and on different lanes) and once
    more at the map's end (another halo position), with a sparse
    background; the queries are the points themselves (distance 0, twelve
    or more ways tied), points 1 cm off, and random points around them."""
    nt, tc, tcap = params
    g = np.random.default_rng(9)
    base = g.uniform(-6.0, 6.0, (300, 3)).astype(np.float32)
    pts = np.concatenate([np.repeat(base, 12, 0), g.uniform(-40.0, 40.0, (1000, 3)).astype(np.float32), base])
    cap = pts.shape[0] + 256
    xyz = torch.zeros((cap, 3), device=dev)
    xyz[: pts.shape[0]] = torch.from_numpy(pts).to(dev)
    valid = torch.arange(cap, device=dev) < pts.shape[0]
    origin = knn.tile_origin_for_pose(torch.zeros(3, device=dev), nt, tc)
    tmap = knn.build_tiled(xyz, torch.zeros((cap, 2), device=dev), valid, origin, nt, tc, tcap)
    q = np.concatenate([base, base + np.float32(0.01), g.uniform(-8.0, 8.0, (600, 3)).astype(np.float32)])
    qt = torch.from_numpy(q).to(dev)
    qs = knn.sort_queries(qt, torch.ones(q.shape[0], dtype=torch.bool, device=dev), origin, nt, tc)
    return tmap, qt[qs.order].contiguous(), qs.bounds


def border_duplicate_inputs(knn, dev, params, row):
    """Query tiles in the window's first (``row=0``) or last tile row, whose
    halo reads that row twice, so a slot ties with itself: tile ids are not
    moved off the border ring (as ``build_tiled`` and ``sort_queries`` do).
    200 points stored 6 times in consecutive slots in that row, a sparse
    background, and as queries the points, points 1 cm off and random points
    in the row."""
    nt, tc, tcap = params
    g = np.random.default_rng(17 + row)
    origin = knn.tile_origin_for_pose(torch.zeros(3, device=dev), nt, tc)
    x0 = float(origin[0]) + row * tc
    lo, hi = [x0 + 0.05, -20.0, -2.0], [x0 + tc - 0.05, 20.0, 2.0]
    base = g.uniform(lo, hi, (200, 3)).astype(np.float32)
    span = nt * tc / 2.0 - 0.1
    pts = np.concatenate([np.repeat(base, 6, 0), g.uniform(-span, span, (4000, 3)).astype(np.float32)])
    q = np.concatenate([base, base + np.float32(0.01), g.uniform(lo, hi, (800, 3)).astype(np.float32)])

    def tiles(xyz):
        c = torch.clamp(torch.floor((xyz[:, :2] - origin[:2]) / float(tc)).to(torch.int32), 0, nt - 1)
        return c[:, 0] * nt + c[:, 1]

    x = torch.from_numpy(pts).to(dev)
    sx = x[torch.argsort(tiles(x), stable=True)]
    sv = torch.ones(sx.shape[0], dtype=torch.bool, device=dev)
    tmap = knn.TiledMap(xyz=sx, rg=torch.zeros((sx.shape[0], 2), device=dev), valid=sv,
                        xyz_t=knn.transposed_coords(sx, sv, tcap), tile_start=knn._tile_range(tiles(sx), nt), origin=origin)
    qt = torch.from_numpy(q).to(dev)
    sq = qt[torch.argsort(tiles(qt), stable=True)].contiguous()
    return tmap, sq, knn._tile_range(tiles(sq), nt)


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
    """``call_ms``: CUDA events around ``repeats`` eager calls, per call. The
    host's work between launches (checks, allocation, the ctypes call) is in
    it wherever it takes longer than the kernel."""
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


def graph_ms(fn, repeats=REPEATS):
    """``device_ms``: one CUDA graph captures ``repeats`` calls, and CUDA
    events time GRAPH_REPLAYS replays of it, per call: the card's time alone,
    the device work of the wrapper (its allocations and small tensor ops)
    included, the host's not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (GRAPH_REPLAYS * repeats)
    del graph
    return ms


def launch_floor():
    """The card's floor for one kernel: an empty kernel (``torch.cuda._sleep(0)``)
    in a CUDA graph (``device_ms``) and launched eagerly (``call_ms``)."""
    return graph_ms(lambda: torch.cuda._sleep(0)), time_cuda(lambda: torch.cuda._sleep(0))


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


def time_knn(knn, inputs, label):
    """Times of the kNN kernel (device and call), its plain version and the
    yardstick on each map's inputs, with each call's bound."""
    per_shape = {}
    for kind, (tmap, q, bounds, params) in inputs.items():
        nt, tc, tcap = params
        kernel = lambda: knn._query_tiled_sorted_cuda(tmap, q, bounds, nt, tc, tcap, 5)  # noqa: E731
        row = {"device_ms": graph_ms(kernel)}
        row["work_list_device_ms"] = graph_ms(lambda: knn.work_list(bounds, nt, knn.CHUNK, q.shape[0]))
        row["call_ms"] = time_cuda(kernel)
        row["plain_ms"] = time_cuda(lambda: knn.query_tiled_sorted_plain(tmap, q, bounds, nt, tc, tcap, 5))
        mx = tmap.xyz[tmap.valid]
        row["cdist_topk_ms"] = time_cuda(lambda: torch.topk(torch.cdist(q, mx), 5, dim=1, largest=False))
        bound_ms, bound_by, pairs, nbytes = knn_bound(knn, tmap, q, bounds, params)
        per_shape[f"{label}_{kind}"] = dict(
            queries=int(bounds[nt * nt]), map_points=int(mx.shape[0]), tile_cap=tcap, **row,
            bound_ms=bound_ms, bound_by=bound_by, pairs=pairs, bytes=nbytes,
        )
        log(f"  {label} {kind}: kernel device {row['device_ms']:.4f} ms (of which work list {row['work_list_device_ms']:.4f})  "
            f"call {row['call_ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
            f"cdist+topk (whole map, yardstick) {row['cdist_topk_ms']:.4f} ms  bound {bound_ms:.5f} ms ({bound_by}; {pairs:.0f} pairs, {nbytes} bytes)")
    return per_shape


def knn_frame_totals(per_shape, label):
    """Per-frame kNN sums over one path's maps."""
    rows = [v for k, v in per_shape.items() if k.startswith(label + "_")]
    keys = ["device_ms", "work_list_device_ms", "call_ms", "plain_ms", "bound_ms", "cdist_topk_ms"]
    tot = {k: sum(r[k] for r in rows) for k in keys}
    t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3
    tot["bound_by"] = "bytes" if t_bytes >= tot["bound_ms"] else "operations"
    return tot


def plain_knn_rerun(knn, make_pipe, frames, ref, name):
    """The first PLAIN_FRAMES frames of a path with the plain kNN swapped in;
    poses held to POSE_TOL_M / POSE_TOL_RAD against the kernel run ``ref``."""
    kernel_path = knn.query_tiled_sorted
    knn.query_tiled_sorted = knn.query_tiled_sorted_plain
    try:
        plain = make_pipe()
        for i in range(PLAIN_FRAMES):
            plain.process_frame(*frames[i])
    finally:
        knn.query_tiled_sorted = kernel_path
    pq, pt = plain.trajectory
    dt = float(np.max(np.linalg.norm(pt - ref["t"][:PLAIN_FRAMES], axis=1)))
    dr = float(np.max(rotation_angle(pq, ref["q"][:PLAIN_FRAMES])))
    log(f"  max pose difference: {dt:.3e} m, {dr:.3e} rad")
    check(dt <= POSE_TOL_M and dr <= POSE_TOL_RAD, f"{name}: plain-kNN poses differ: {dt} m, {dr} rad")


def profile_steady_frames(make_pipe, frames, stages, between=None):
    """Profile frames WARMUP..WARMUP+PROFILE_FRAMES of a fresh run, with a
    span around each stage (wrapped here, not in the package): host time per
    stage, kernel launches per frame, and the device's busy share of the wall
    time (profiler on, so the wall is inflated).  Then count the call sites
    that synchronise the host while four more frames are dispatched, two fed
    as tensors on the card and two as numpy scans (the valid points only, as
    a sensor or a KITTI file gives them), with ``between(pipe, scan)`` called
    after each frame on its numpy scan; fail unless there are none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    originals = [(mod, name, getattr(mod, name)) for mod, name in stages]

    def spanned(name, fn):
        def run(*args, **kwargs):
            with record_function("stage::" + name):
                return fn(*args, **kwargs)

        return run

    pipe = make_pipe()
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
    checked = range(first, first + 4)
    scans = {i: frames[i][0][frames[i][1]].cpu().numpy() for i in checked}  # read back before the check
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in checked:
                if i < first + 2:
                    pipe.process_frame(*frames[i])
                else:
                    pipe.process_frame(scans[i])
                if between is not None:
                    between(pipe, scans[i])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted(
        {f"{Path(w.filename).name}:{w.lineno}" for w in caught if "called a synchronizing CUDA operation" in str(w.message)}
    )
    log(f"  host syncs while dispatching 4 frames (2 tensor-fed, 2 numpy-fed{', a global-map update after each' if between else ''}): "
        f"{len(syncs)} call sites {syncs}")
    check(not syncs, f"a frame's dispatch synchronises the host at {syncs}")


def run_protocol(pipe, frames, gt, metrics, n_frames):
    """Warm up, time the steady loop over ``n_frames``, score drift and ATE
    against ``gt``."""
    gt = gt[:n_frames]
    for i in range(WARMUP):
        pipe.process_frame(*frames[i])
    pipe.flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP, n_frames):
        pipe.process_frame(*frames[i])
    pipe.flush()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    q_est, t_est = pipe.trajectory
    est = metrics.poses_to_matrices(q_est, t_est)
    path = metrics.trajectory_distances(gt)[-1]
    lengths = tuple(length for length in LENGTHS if length <= path * 0.8)
    drift = metrics.kitti_drift(gt, est, lengths=lengths, step=10)
    r = dict(
        fps=(n_frames - WARMUP) / steady_s,
        ms=steady_s / (n_frames - WARMUP) * 1e3,
        drift=drift["t_err_pct"],
        r_err=drift["r_err_deg_per_m"],
        segments=drift["n_segments"],
        ate=metrics.ate_rmse(gt, est),
        path=path,
        overflow=pipe.overflow_total,
        dropped=pipe.n_dropped,
        q=q_est,
        t=t_est,
    )
    log(f"  frames/s {r['fps']:.3f}  ms/frame {r['ms']:.2f}  (steady {n_frames - WARMUP} of {n_frames} frames)")
    log(f"  drift_t_pct {r['drift']:.4f}  r_err_deg_per_m {r['r_err']:.6f}  segments {r['segments']}  lengths {lengths}")
    log(f"  ate_rmse_m {r['ate']:.4f}  path_m {path:.1f}  overflow_total {r['overflow']}  n_dropped {r['dropped']}")
    return r


def gate_protocol(name, r):
    """Zero overflow, finite poses, drift below the reference's bar."""
    check(r["overflow"] == 0, f"{name}: overflow_total {r['overflow']} != 0")
    check(np.isfinite(r["q"]).all() and np.isfinite(r["t"]).all(), f"{name}: non-finite poses")
    check(r["segments"] > 0 and r["drift"] < DRIFT_BAR, f"{name}: drift {r['drift']} not below {DRIFT_BAR}")


def nonground_cloud(cfg, xyz, valid):
    """The radius front-end's moment input for one scan: the non-ground
    points that survive ground removal and DCVC."""
    from pfilter_tpu_torch.ops import dcvc, ground

    ng = ground.segment_ground_dispatch(xyz, valid, cfg).nonground_mask
    return dcvc.cluster(xyz, ng, cfg.dcvc, cfg.lidar).keep


def tiled_cloud(knn, xyz, valid, nt, tc, tile_cap):
    origin = knn.tile_origin_for_pose(torch.zeros(3, device=xyz.device), nt, tc)
    return knn.build_tiled(xyz, torch.zeros((xyz.shape[0], 2), device=xyz.device), valid, origin, nt, tc, tile_cap)


def pca_edge_inputs(knn, xyz, ng, nt, tc):
    """The scan at tile cap 384 (near-sensor rows overflow the cap by
    thousands of slots), with points and queries in the clipped border
    tiles, queries far outside the window, and ~10 % invalid queries."""
    dev = xyz.device
    g = torch.Generator(device="cpu").manual_seed(5)
    half = nt * tc / 2.0
    border = torch.rand((600, 3), generator=g) * torch.tensor([7.9, 60.0, 4.0]) + torch.tensor([half - 8.0, -30.0, -2.0])
    far = torch.rand((2000, 3), generator=g) * 600.0 - 300.0
    mxyz = torch.cat([xyz, border.to(dev)])
    mvalid = torch.cat([ng, torch.ones(600, dtype=torch.bool, device=dev)])
    q = torch.cat([mxyz, far.to(dev)])
    qv = torch.cat([mvalid & (torch.rand(mvalid.shape[0], generator=g) > 0.1).to(dev), torch.ones(2000, dtype=torch.bool, device=dev)])
    return tiled_cloud(knn, mxyz, mvalid, nt, tc, 384), q, qv, (nt, tc, 384)


def pca_boundary_inputs(knn, dev, nt, tc):
    """One work item of 32 queries in one tile: the 8 corners of a 2.6 x 1.8
    x 1.2 m box and 24 points inside it; candidates at r (1 +- 1e-6) and
    r (1 +- k 2^-23) from each corner along the axes and the diagonals, so
    ball membership is decided at its boundary for queries on the box's
    corners, and a sparse background; no halo row reaches the cap."""
    g = np.random.default_rng(13)
    half = np.array([1.3, 0.9, 0.6], np.float32)
    center = np.array([tc / 2.0 + 0.1, tc / 2.0 + 0.1, 0.0], np.float32)  # inside the tile at [0, tc)^2
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32) * half
    q = (center + np.concatenate([corners, g.uniform(-half, half, (24, 3))])).astype(np.float32)
    dirs = [np.eye(3)[a] * sg for a in range(3) for sg in (-1.0, 1.0)]
    dirs += [np.array([sx, sy, sz]) / np.sqrt(3.0) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    scales = [1.0 - 1e-6, 1.0 + 1e-6] + [1.0 + k * 2.0**-23 for k in range(-4, 5)]
    cand = np.stack([q[i] + np.float32(sc) * np.asarray(d, np.float32) for i in range(8) for d in dirs for sc in scales])
    cand = np.concatenate([cand, g.uniform(-6.0, 8.0, (500, 3))]).astype(np.float32)
    x = torch.from_numpy(cand).to(dev)
    tmap = tiled_cloud(knn, x, torch.ones(x.shape[0], dtype=torch.bool, device=dev), nt, tc, 512)
    check(int(knn.halo_overflow(tmap, nt, 3 * 512)) == 0, "ball boundary case: a halo row is capped")
    d2 = ((cand[None, :, :].astype(np.float64) - q[:8, None, :].astype(np.float64)) ** 2).sum(-1)
    n_edge = int((np.abs(d2 - 1.0) < 1e-5).sum())
    return tmap, torch.from_numpy(q).to(dev), torch.ones(q.shape[0], dtype=torch.bool, device=dev), (nt, tc, 512), n_edge


def compare_pca(knn, pr, tmap, q, qv, params, name):
    """Kernel against plain on the same inputs: counts exact, means within
    MEAN_TOL_M, covariances within COV_TOL_PER_POINT per neighbour; and two
    launches on the same inputs bitwise equal."""
    nt, tc, tcap = params
    before = pr.KERNEL_LAUNCHES
    a = pr.radius_pca_moments(tmap, q, qv, nt, tc, tcap)
    a2 = pr.radius_pca_moments(tmap, q, qv, nt, tc, tcap)
    b = pr.radius_pca_moments_plain(tmap, q, qv, nt, tc, tcap)
    torch.cuda.synchronize()
    check(pr.KERNEL_LAUNCHES == before + 2, f"{name}: the kernel did not launch")
    same = all(torch.equal(x, y) for x, y in zip(a, a2))
    check(same, f"{name}: two launches on the same inputs differ")
    compare_work_list(knn, knn.sort_queries(q, qv, tmap.origin, nt, tc).bounds, nt, pr.CHUNK, q.shape[0], name)
    ac, bc = a.count.cpu().numpy(), b.count.cpu().numpy()
    check(np.array_equal(ac, bc), f"{name}: counts differ in {int((ac != bc).sum())} rows")
    d_mean = float((a.mean - b.mean).abs().max())
    d_cov = (a.cov - b.cov).abs().amax(dim=(1, 2)).cpu().numpy()
    d_cov_pp = float(np.max(d_cov / np.maximum(bc, 1.0)))
    err = max(d_mean, float(d_cov.max()))
    check(d_mean <= MEAN_TOL_M, f"{name}: mean differs by {d_mean} m")
    check(d_cov_pp <= COV_TOL_PER_POINT, f"{name}: covariance differs by {d_cov_pp} m^2 per neighbour")
    _, c_cnt = knn._halo_ranges(tmap, nt, 2**31 - 1)
    nt2 = nt * nt
    filled = int(((tmap.tile_start[1:] - tmap.tile_start[:-1]) > 0).sum())
    log(f"  {name}: Q={q.shape[0]} valid={int(qv.sum())} tile_cap={tcap} widest halo row {int(c_cnt.max())} slots "
        f"(cap {3 * tcap}), truncated {int(knn.halo_overflow(tmap, nt, 3 * tcap))}; {nt2 - filled} empty tiles; "
        f"neighbours {bc.sum():.0f}; max |d count| 0, |d mean| {d_mean:.3e} m, |d cov| {d_cov.max():.3e} m^2 "
        f"({d_cov_pp:.3e} per neighbour); run_to_run_equal={same}")
    return err, float(bc.sum())


def pca_bound(knn, tmap, q, qv, params, hits):
    """Least time for one moments call: the bytes it must move (valid
    queries, live map coordinates, tile ranges read once; the [Q,10] sums
    written once) over HBM bandwidth, and the work the function needs — the
    distance and the sums of each in-ball pair — over the fp32 rate.
    ``bound_halo_ms`` is the yardstick of earlier runs: the distance of every
    (query, halo candidate) pair, which the kernel's cull no longer does."""
    nt, tc, tcap = params
    nt2 = nt * nt
    qs = knn.sort_queries(q, qv, tmap.origin, nt, tc)
    _, c_cnt = knn._halo_ranges(tmap, nt, 3 * tcap)
    per_tile = (qs.bounds[1:] - qs.bounds[:-1]).to(torch.float64)
    pairs = float((per_tile * c_cnt.sum(-1).to(torch.float64)).sum())
    n_q = int(qs.bounds[nt2])
    live = int(tmap.tile_start[nt2])
    nbytes = n_q * 12 + live * 12 + 2 * 4 * (nt2 + 1) + 12 + q.shape[0] * 10 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = hits * (FLOPS_PER_PAIR + FLOPS_PER_HIT) / FP32_FLOPS * 1e3
    t_halo = (pairs * FLOPS_PER_PAIR + hits * FLOPS_PER_HIT) / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), max(t_bytes, t_halo), pairs, nbytes


def write_kitti_layout(root: Path, seq: str, scans, gt) -> None:
    """A KITTI odometry layout: ``sequences/<seq>/velodyne/%06d.bin`` ([N,4]
    float32, reflectance 0), ``calib.txt`` whose ``Tr`` swaps axes and
    offsets (velodyne -> cam0), and ``poses/<seq>.txt`` in cam0 coordinates
    (``Tr . T_vel . Tr^-1``, so the reader's velodyne frame gives ``gt``)."""
    d = root / "sequences" / seq
    (d / "velodyne").mkdir(parents=True)
    (root / "poses").mkdir()
    for i, xyz in enumerate(scans):
        np.concatenate([xyz, np.zeros((len(xyz), 1), np.float32)], 1).astype(np.float32).tofile(d / "velodyne" / f"{i:06d}.bin")
    tr = np.eye(4)
    tr[:3] = KITTI_TR
    with open(d / "calib.txt", "w") as f:
        f.write("P0: " + " ".join(["0"] * 12) + "\n")
        f.write("Tr: " + " ".join(repr(float(v)) for v in tr[:3].reshape(-1)) + "\n")
    cam = np.einsum("ij,njk,kl->nil", tr, gt, np.linalg.inv(tr))
    with open(root / "poses" / f"{seq}.txt", "w") as f:
        for m in cam:
            f.write(" ".join(repr(float(v)) for v in m[:3].reshape(-1)) + "\n")


def kitti_runner_phase(cfg, world, root, zero_counts, read_counts):
    """Render RUNNER_FRAMES frames of the loop with the port's renderer, write them as a
    KITTI sequence, read them back through the port's native prefetcher and
    run ``run_kitti.main`` on them; check the result against the gates and
    against an ``ESPipeline`` fed the same scans as CUDA tensors."""
    from pfilter_tpu_torch import run_kitti
    from pfilter_tpu_torch.utils import kitti, metrics, synthetic

    dev = torch.device("cuda")
    sub = synthetic.make_loop_trajectory(RUNNER_FRAMES, speed=SPEED)
    t0 = time.perf_counter()
    xyz, valid = synthetic.render_sequence(world, sub, cfg.lidar, AZIMUTH, noise=0.008, device=dev)
    scans = [xyz[i][valid[i]].cpu().numpy() for i in range(RUNNER_FRAMES)]
    gt = metrics.poses_to_matrices(np.asarray(sub.q), np.asarray(sub.t))
    gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    write_kitti_layout(root / "kitti", RUNNER_SEQ, scans, gt)
    log(f"  rendered {RUNNER_FRAMES} scans ({min(map(len, scans))}-{max(map(len, scans))} points) and wrote them "
        f"as sequence {RUNNER_SEQ} in {time.perf_counter() - t0:.1f} s")

    seq = kitti.KittiSequence(root / "kitti", RUNNER_SEQ)
    n_read = 0
    for got, path in zip(seq.scans(), seq.scan_paths):
        check(np.array_equal(got, kitti.read_velodyne_bin(path)), f"native loader: {path.name} differs from read_velodyne_bin")
        n_read += 1
    check(seq.reader == "native", f"the KITTI reader is {seq.reader!r}, not the native prefetcher ({kitti.native_loader()[1]})")
    check(n_read == RUNNER_FRAMES, f"native loader yielded {n_read} scans")
    log(f"  native prefetcher {kitti.native_loader()[1]}: {n_read} scans equal to read_velodyne_bin")

    made = {}
    make_pipeline, global_map = run_kitti.make_pipeline, run_kitti.GlobalMap

    def keep(key, fn):
        def made_by(*args, **kwargs):
            made[key] = fn(*args, **kwargs)
            return made[key]

        return made_by

    out = root / "out"
    run_kitti.make_pipeline, run_kitti.GlobalMap = keep("pipe", make_pipeline), keep("map", global_map)
    try:
        zero_counts()
        (res,) = run_kitti.main(["--root", str(root / "kitti"), "--sequence", RUNNER_SEQ, "--global-map", str(RUNNER_MAP_STRIDE), "--out", str(out)])
        counts = read_counts()
    finally:
        run_kitti.make_pipeline, run_kitti.GlobalMap = make_pipeline, global_map
    pipe = made["pipe"]
    tag = f"{RUNNER_SEQ}_run"
    log(f"  frames/s {res['fps']}  mean ms/frame {res['mean_ms']} (frames 10-{RUNNER_FRAMES - 1}, sync=True: a fetch per frame)  "
        f"drift_t_pct {res.get('drift_t_pct')}  ate_rmse_m {res.get('ate_rmse_m')}  overflow {res['overflow_total']}  device {res['device']}")
    log(f"  kernel launches {counts}")
    check(res["device"] == torch.cuda.get_device_name(0), f"runner device {res['device']!r}")
    check(res["overflow_total"] == 0, f"runner: overflow_total {res['overflow_total']} != 0")
    check(np.isfinite(res.get("drift_t_pct", np.nan)) and res["drift_t_pct"] < DRIFT_BAR, f"runner: drift {res.get('drift_t_pct')} not below {DRIFT_BAR}")
    check(counts["knn_tiled"] == 2 * (RUNNER_FRAMES - 1), f"runner: kNN launches {counts} != {2 * (RUNNER_FRAMES - 1)}")

    q, t = pipe.trajectory
    est = metrics.poses_to_matrices(q, t)
    saved = metrics.load_kitti_format(out / f"{tag}.txt")
    check(saved.shape == est.shape and bool(np.all(np.abs(saved - est) <= 5.1e-10 * np.abs(est))), f"{tag}.txt differs from the estimate beyond its 9 digits")
    lines = (out / f"{tag}_frames.jsonl").read_text().splitlines()
    check(len(lines) == RUNNER_FRAMES, f"{tag}_frames.jsonl has {len(lines)} lines")
    pts = np.load(out / f"{tag}_map.npz")["xyz"]
    check(len(pts) > 0 and bool(np.isfinite(pts).all()) and (out / f"{tag}_map.ply").is_file(), "global map empty, non-finite or without its .ply")
    log(f"  {tag}.txt / _frames.jsonl ({len(lines)} lines) / _map.npz ({len(pts)} points, {len(made['map']._slot_of)} cells) / _map.ply written")

    # The same scans as CUDA tensors, padded as the pipeline pads a numpy scan.
    cap = pipe.cfg.capacity.scan_points
    tens = make_pipeline(pipe.cfg, sync=False, fetch_lag=4, device=dev)
    for path in seq.scan_paths:
        x = kitti.read_velodyne_bin(path)[:, :3]
        xp, vp = np.zeros((cap, 3), np.float32), np.zeros(cap, bool)
        xp[: len(x)], vp[: len(x)] = x[:cap], True
        tens.process_frame(torch.from_numpy(xp).to(dev), torch.from_numpy(vp).to(dev))
    tq, tt = tens.trajectory
    same = np.array_equal(tq, q) and np.array_equal(tt, t)
    log(f"  poses equal to a tensor-fed ESPipeline on the same scans: {same} "
        f"(max |dt| {np.abs(tt - t).max():.3e} m)")
    check(same, "runner poses differ from the tensor-fed pipeline's")
    return counts, res


def resume_phase(name, cfg, frames, ref, ckpt_dir):
    """Run RESUME_AT frames, save the state, restore it into a fresh
    template and run the next RESUME_AT frames from it: both halves must
    equal the uninterrupted run ``ref`` bit for bit."""
    from pfilter_tpu_torch.models import bpf_odometry, es_odometry
    from pfilter_tpu_torch.pipeline import BPFPipeline, ESPipeline, make_pipeline
    from pfilter_tpu_torch.utils import checkpoint

    dev = torch.device("cuda")
    first = make_pipeline(cfg, sync=False, fetch_lag=4, device=dev)
    for i in range(RESUME_AT):
        first.process_frame(*frames[i])
    q1, t1 = first.trajectory
    checkpoint.save_state(ckpt_dir, first.state, step=RESUME_AT)
    template = es_odometry.init_state(cfg, device=dev) if name == "es" else bpf_odometry.init_state(cfg, device=dev)
    restored, meta = checkpoint.restore_state(ckpt_dir, template)
    check(meta["restored_from_template"] == [] and meta["step"] == RESUME_AT, f"{name}: restore fell back to the template: {meta}")
    resumed = (ESPipeline if name == "es" else BPFPipeline)(cfg, state=restored, sync=False, fetch_lag=4, device=dev)
    t0 = time.perf_counter()
    for i in range(RESUME_AT, 2 * RESUME_AT):
        resumed.process_frame(*frames[i])
    q2, t2 = resumed.trajectory
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / RESUME_AT * 1e3
    size = sum(f.stat().st_size for f in ckpt_dir.iterdir())
    same1 = np.array_equal(q1, ref["q"][:RESUME_AT]) and np.array_equal(t1, ref["t"][:RESUME_AT])
    same2 = np.array_equal(q2, ref["q"][RESUME_AT : 2 * RESUME_AT]) and np.array_equal(t2, ref["t"][RESUME_AT : 2 * RESUME_AT])
    log(f"  {name}: checkpoint {size} bytes ({meta['n_leaves']} leaves); frames 0-{RESUME_AT - 1} equal to the uninterrupted run: {same1}; "
        f"resumed frames {RESUME_AT}-{2 * RESUME_AT - 1} equal: {same2} (max |dt| {np.abs(t2 - ref['t'][RESUME_AT : 2 * RESUME_AT]).max():.3e} m); "
        f"resumed run {ms:.2f} ms/frame")
    check(same1 and same2, f"{name}: the resumed run differs from the uninterrupted one")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from pfilter_tpu_torch.config import apply_dotted_overrides, kitti_config
    from pfilter_tpu_torch.models import bpf_frontend, bpf_odometry, es_odometry, map_state
    from pfilter_tpu_torch.ops import _build, dcvc, features, ground, pca_classify, pose_graph
    from pfilter_tpu_torch.ops import knn_tiled as knn
    from pfilter_tpu_torch.ops import pca_radius as pr
    from pfilter_tpu_torch.models.global_map import GlobalMap
    from pfilter_tpu_torch.pipeline import make_pipeline
    from pfilter_tpu_torch.utils import metrics, synthetic

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    def phase(title):
        log(f"== {title}  [+{time.perf_counter() - t_start:.1f} s]")

    def zero_counts():
        knn.KERNEL_LAUNCHES = 0
        pr.KERNEL_LAUNCHES = 0
        knn.WORK_LIST_LAUNCHES = 0

    def read_counts():
        c = {"knn_tiled": knn.KERNEL_LAUNCHES, "pca_radius": pr.KERNEL_LAUNCHES, "work_list": knn.WORK_LIST_LAUNCHES}
        check(c["work_list"] == c["knn_tiled"] + c["pca_radius"], f"work-list launches {c} != kNN + PCA launches")
        return c

    phase("phase 1: device")
    smi = nvidia_smi_line()
    log(f"  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("phase 2: build")
    _build.load()
    log(f"  built {_build.BUILD_INFO['path']} in {_build.BUILD_INFO['seconds']:.1f} s")
    for line in _build.BUILD_INFO["log"].splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "smem", "spill", "==")) or "error" in line.lower():
            log(f"  ptxas: {line.strip()}")
    floor_device_ms, floor_call_ms = launch_floor()
    log(f"  launch floor (empty kernel): device {floor_device_ms:.4f} ms in a CUDA graph, call {floor_call_ms:.4f} ms eager")

    cfg = kitti_config()
    cfg_bpf = cfg.replace(mode="bpf")
    cfg_rad = apply_dotted_overrides(cfg_bpf, RADIUS_OVERRIDES)
    world = synthetic.make_city_world(seed=7)
    poses = synthetic.make_loop_trajectory(FRAMES, speed=SPEED)
    t0 = time.perf_counter()
    frames = render_all(cfg, world, poses, synthetic, dev)
    log(f"  rendered {FRAMES} scans on the card in {time.perf_counter() - t0:.1f} s")
    gt = metrics.poses_to_matrices(np.asarray(poses.q), np.asarray(poses.t))
    gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    launches = {}

    phase("phase 3: ES odometry on the card (kitti_config, v1 protocol, %d frames)" % ES_FRAMES)
    pipe = make_pipeline(cfg, sync=False, fetch_lag=4)
    zero_counts()
    es = run_protocol(pipe, frames, gt, metrics, ES_FRAMES)
    launches["es"] = read_counts()
    log(f"  kernel launches {launches['es']}")
    gate_protocol("es", es)
    check(launches["es"]["knn_tiled"] == 2 * (ES_FRAMES - 1), f"es: kNN launches {launches['es']} != {2 * (ES_FRAMES - 1)}")

    phase("phase 4: kNN kernel vs plain version at main-path shapes")
    inputs = frame_queries(pipe.cfg, pipe.state, *frames[ES_FRAMES - 1])
    knn_err = 0.0
    for kind, (tmap, q, bounds, params) in inputs.items():
        knn_err = max(knn_err, compare(knn, tmap, q, bounds, params, f"{kind} map"))
    surf_params = inputs["surf"][3]
    tmap_e, q_e, b_e = edge_case_inputs(knn, dev, surf_params)
    nt, _, tcap = surf_params
    over = int(torch.clamp(knn._halo_ranges(tmap_e, nt, 10**9)[1] - 3 * tcap, min=0).max())
    n_inv = int(q_e.shape[0] - b_e[nt * nt])
    log(f"  edge cases: widest halo row over the cap by {over} slots; {n_inv} invalid queries")
    check(over > 0 and n_inv > 0, "edge-case map does not exercise the cap or invalid queries")
    knn_err = max(knn_err, compare(knn, tmap_e, q_e, b_e, surf_params, "edge cases"))
    knn_err = max(knn_err, compare(knn, *duplicate_inputs(knn, dev, surf_params), surf_params, "duplicate points"))
    for row in (0, nt - 1):
        tmap_d, q_d, b_d = border_duplicate_inputs(knn, dev, surf_params, row)
        tx = (torch.searchsorted(b_d, torch.arange(int(b_d[nt * nt]), device=dev, dtype=torch.int32), right=True) - 1) // nt
        check(bool((tx == row).all()), f"border duplicates: a query tile lies outside tile row {row}")
        knn_err = max(knn_err, compare(knn, tmap_d, q_d, b_d, surf_params, f"duplicate points, tile row {row} read twice"))

    phase("phase 5: first %d ES frames with the plain kNN on the card" % PLAIN_FRAMES)
    plain_knn_rerun(knn, lambda: make_pipeline(cfg, sync=True), frames, es, "es")

    phase("phase 6: kNN times (device: CUDA graph of %d calls; call: CUDA events)" % REPEATS)
    per_shape = time_knn(knn, inputs, "es")

    phase("phase 7: where an ES frame's time goes (torch.profiler, %d steady frames)" % PROFILE_FRAMES)
    gmap = GlobalMap(resolution=cfg.odometry.map_resolution, device=dev)

    def map_update(pipe, scan):
        rec = pipe.records[-1]  # the newest fetched pose: host data
        sub = scan[:: max(1, len(scan) // 30000)]
        gmap.update(rec.pose_q, rec.pose_t, sub, np.ones(len(sub), bool))

    profile_steady_frames(
        lambda: make_pipeline(cfg, sync=False, fetch_lag=4),
        frames,
        [(features, "extract_features"), (es_odometry, "_es_outer_assoc_once"), (pose_graph, "smoothed_newest"), (map_state, "merge_scan_into_index")],
        between=map_update,
    )

    phase("phase 8: BPF odometry, default (voxel) front-end (v1 protocol, %d frames)" % BPF_FRAMES)
    pipe = make_pipeline(cfg_bpf, sync=False, fetch_lag=4)
    zero_counts()
    bpf = run_protocol(pipe, frames, gt, metrics, BPF_FRAMES)
    launches["bpf_voxel"] = read_counts()
    log(f"  kernel launches {launches['bpf_voxel']}; map sizes (beam, pillar, facade) {pipe.records[-1].map_sizes.tolist()}")
    log(f"  the reference package's BPF drift on the 300-frame protocol, on a TPU v5 lite (BENCH_r05.json): {TPU_BPF_DRIFT} %")
    gate_protocol("bpf", bpf)
    check(launches["bpf_voxel"]["knn_tiled"] == 3 * (BPF_FRAMES - 1), f"bpf: kNN launches {launches['bpf_voxel']} != {3 * (BPF_FRAMES - 1)}")

    phase("phase 9: kNN kernel vs plain version at the default BPF path's shapes, and times")
    inputs = bpf_frame_queries(pipe.cfg, pipe.state, *frames[BPF_FRAMES - 1])
    for kind, (tmap, q, bounds, params) in inputs.items():
        knn_err = max(knn_err, compare(knn, tmap, q, bounds, params, f"bpf {kind} map"))
    per_shape.update(time_knn(knn, inputs, "bpf_voxel"))

    phase("phase 10: first %d default-BPF frames with the plain kNN on the card" % PLAIN_FRAMES)
    plain_knn_rerun(knn, lambda: make_pipeline(cfg_bpf, sync=True), frames, bpf, "bpf")

    phase("phase 11: BPF odometry, radius front-end %s (v1 protocol, %d frames)" % (RADIUS_OVERRIDES, FRAMES))
    pipe = make_pipeline(cfg_rad, sync=False, fetch_lag=4)
    zero_counts()
    rad = run_protocol(pipe, frames, gt, metrics, FRAMES)
    launches["bpf_radius"] = read_counts()
    trunc = [r.n_scan_trunc for r in pipe.records]  # tensor scans: no raw-scan truncation, all front-end
    div_t = np.linalg.norm(rad["t"][:BPF_FRAMES] - bpf["t"], axis=1)
    div_r = rotation_angle(rad["q"][:BPF_FRAMES], bpf["q"])
    log(f"  kernel launches {launches['bpf_radius']}; front-end halo truncation {sum(trunc)} slots "
        f"(worst frame {max(trunc)}); map sizes {pipe.records[-1].map_sizes.tolist()}")
    log(f"  divergence from the voxel front-end's poses over {BPF_FRAMES} frames: max {div_t.max():.4f} m (frame {int(div_t.argmax())}), "
        f"last {div_t[-1]:.4f} m; max {div_r.max():.3e} rad")
    check(launches["bpf_radius"]["pca_radius"] == FRAMES, f"bpf radius: PCA launches {launches['bpf_radius']} != {FRAMES}")
    check(launches["bpf_radius"]["knn_tiled"] == 3 * (FRAMES - 1), f"bpf radius: kNN launches {launches['bpf_radius']}")
    check(sum(trunc) == 0, f"bpf radius: front-end halo truncation {sum(trunc)} != 0")
    gate_protocol("bpf radius", rad)

    phase("phase 12: kNN kernel vs plain version at the radius BPF path's shapes, and times")
    inputs = bpf_frame_queries(pipe.cfg, pipe.state, *frames[FRAMES - 1])
    for kind, (tmap, q, bounds, params) in inputs.items():
        knn_err = max(knn_err, compare(knn, tmap, q, bounds, params, f"bpf radius {kind} map"))
    per_shape.update(time_knn(knn, inputs, "bpf_radius"))
    knn_tot = {label: knn_frame_totals(per_shape, label) for label in ("es", "bpf_voxel", "bpf_radius")}
    for label, tot in knn_tot.items():
        log(f"  kNN per {label} frame: kernel device {tot['device_ms']:.4f} ms  call {tot['call_ms']:.4f} ms  "
            f"plain {tot['plain_ms']:.4f} ms  bound {tot['bound_ms']:.5f} ms")

    phase("phase 13: PCA kernel vs plain version at main-path shapes and edge cases")
    nt, tc, tcap = cfg_rad.capacity.knn_tiles, cfg_rad.capacity.tile_cells, cfg_rad.capacity.frontend_tile_cap
    widest = [int(knn._halo_ranges(tiled_cloud(knn, x, nonground_cloud(cfg_rad, x, v), nt, tc, tcap), nt, 2**31 - 1)[1].max()) for x, v in frames]
    log(f"  widest 3-tile halo row over all {FRAMES} frames: {max(widest)} slots (frame {int(np.argmax(widest))}); "
        f"cap 3 x {tcap} = {3 * tcap}; the shipped 3 x {cfg.capacity.frontend_tile_cap} = {3 * cfg.capacity.frontend_tile_cap}")
    xyz_l, valid_l = frames[FRAMES - 1]
    ng = nonground_cloud(cfg_rad, xyz_l, valid_l)
    tmap_l = tiled_cloud(knn, xyz_l, ng, nt, tc, tcap)
    pca_err, hits = compare_pca(knn, pr, tmap_l, xyz_l, ng, (nt, tc, tcap), "last frame")
    tmap_x, q_x, qv_x, params_x = pca_edge_inputs(knn, xyz_l, ng, nt, tc)
    check(int(knn.halo_overflow(tmap_x, nt, 3 * 384)) > 0, "edge case does not overflow the cap")
    pca_err = max(pca_err, compare_pca(knn, pr, tmap_x, q_x, qv_x, params_x, "edge cases")[0])
    tmap_b, q_b, qv_b, params_b, n_edge = pca_boundary_inputs(knn, dev, nt, tc)
    log(f"  ball boundary case: {n_edge} (corner, candidate) pairs with |d^2 - r^2| < 1e-5 m^2")
    pca_err = max(pca_err, compare_pca(knn, pr, tmap_b, q_b, qv_b, params_b, "ball boundary")[0])

    phase("phase 14: first %d radius-BPF frames with the plain PCA on the card" % PLAIN_FRAMES)
    kernel_path = pr.radius_moments_sorted
    pr.radius_moments_sorted = pr.radius_moments_sorted_plain
    try:
        plain = make_pipeline(cfg_rad, sync=True)
        for i in range(PLAIN_FRAMES):
            plain.process_frame(*frames[i])
    finally:
        pr.radius_moments_sorted = kernel_path
    pq, pt = plain.trajectory
    dt = float(np.max(np.linalg.norm(pt - rad["t"][:PLAIN_FRAMES], axis=1)))
    dr = float(np.max(rotation_angle(pq, rad["q"][:PLAIN_FRAMES])))
    log(f"  max pose difference: {dt:.3e} m, {dr:.3e} rad")
    check(dt <= POSE_TOL_M and dr <= POSE_TOL_RAD, f"plain-PCA poses differ: {dt} m, {dr} rad")

    phase("phase 15: PCA times (device: CUDA graph of %d calls; call: CUDA events; plain %d)" % (REPEATS, PLAIN_REPEATS))
    radius = cfg_rad.pca.neighbor_radius
    qs = knn.sort_queries(xyz_l, ng, tmap_l.origin, nt, tc)
    sq = xyz_l[qs.order].contiguous()
    pca_kernel = lambda: pr._radius_moments_sorted_cuda(tmap_l, sq, qs.bounds, nt, tc, tcap, radius)  # noqa: E731
    pca_device_ms = graph_ms(pca_kernel)
    pca_call_ms = time_cuda(pca_kernel)
    pca_plain_ms = time_cuda(lambda: pr.radius_moments_sorted_plain(tmap_l, sq, qs.bounds, nt, tc, tcap, radius), PLAIN_REPEATS)
    fn_ms = time_cuda(lambda: pr.radius_pca_moments(tmap_l, xyz_l, ng, nt, tc, tcap))
    cloud = xyz_l[ng]
    x, y, z = cloud[:, 0], cloud[:, 1], cloud[:, 2]
    feats = torch.stack([torch.ones_like(x), x, y, z, x * x, y * y, z * z, x * y, x * z, y * z], -1)
    pca_yard_ms = time_cuda(lambda: (torch.cdist(cloud, cloud) < radius).float() @ feats, 10)
    pca_bound_ms, pca_bound_by, pca_bound_halo_ms, pca_pairs, pca_bytes = pca_bound(knn, tmap_l, xyz_l, ng, (nt, tc, tcap), hits)
    log(f"  kernel (wrapper on sorted queries) device {pca_device_ms:.4f} ms  call {pca_call_ms:.4f} ms  plain {pca_plain_ms:.4f} ms")
    log(f"  bound {pca_bound_ms:.5f} ms ({pca_bound_by}; {hits:.0f} in-ball pairs, {pca_bytes} bytes); "
        f"all-halo-pairs bound of earlier runs {pca_bound_halo_ms:.5f} ms ({pca_pairs:.0f} pairs)")
    log(f"  radius_pca_moments (sort, kernel, finish) {fn_ms:.4f} ms  "
        f"(cdist < r) @ F over {cloud.shape[0]} points (yardstick) {pca_yard_ms:.4f} ms")

    phase("phase 16: where a radius-BPF frame's time goes (torch.profiler, %d steady frames)" % PROFILE_FRAMES)
    profile_steady_frames(
        lambda: make_pipeline(cfg_rad, sync=False, fetch_lag=4),
        frames,
        [
            (bpf_frontend, "run_frontend"),
            (ground, "segment_ground_dispatch"),
            (dcvc, "cluster"),
            (pr, "radius_pca_moments"),
            (pca_classify, "classify"),
            (bpf_odometry, "_bpf_outer_assoc_once"),
            (pose_graph, "smoothed_newest"),
            (map_state, "merge_scan_into_index"),
        ],
    )
    phase("phase 17: KITTI runner on the card (python -m pfilter_tpu_torch.run_kitti, %d frames, --global-map %d)" % (RUNNER_FRAMES, RUNNER_MAP_STRIDE))
    with tempfile.TemporaryDirectory() as tmp:
        launches["kitti_runner"], runner = kitti_runner_phase(cfg, world, Path(tmp), zero_counts, read_counts)

    phase("phase 18: checkpoint/resume on the card (ES and default BPF, %d + %d frames)" % (RESUME_AT, RESUME_AT))
    with tempfile.TemporaryDirectory() as tmp:
        for name, c, ref in (("es", cfg, es), ("bpf", cfg_bpf, bpf)):
            zero_counts()
            resume_phase(name, c, frames, ref, Path(tmp) / name)
            launches[f"{name}_resume"] = read_counts()
            per_frame = 2 if name == "es" else 3
            want = per_frame * (RESUME_AT - 1) + per_frame * RESUME_AT
            check(launches[f"{name}_resume"]["knn_tiled"] == want, f"{name} resume: kNN launches {launches[f'{name}_resume']} != {want}")
            log(f"  kernel launches {launches[f'{name}_resume']}")
    log(f"  total wall {time.perf_counter() - t_start:.1f} s")

    kernels = {
        "kernels": [
            {
                "name": "knn_tiled",
                "route": "cuda",
                "source": "pfilter_tpu_torch/csrc/knn_tiled.cu",
                "replaces": "pfilter_tpu/ops/knn_tiled.py:174",
                "launches": launches["es"]["knn_tiled"],
                "max_abs_err": knn_err,
                "ms": knn_tot["es"]["device_ms"],
                "device_ms": knn_tot["es"]["device_ms"],
                "call_ms": knn_tot["es"]["call_ms"],
                "plain_ms": knn_tot["es"]["plain_ms"],
                "bound_ms": knn_tot["es"]["bound_ms"],
                "bound_by": knn_tot["es"]["bound_by"],
                "library_ms": None,
                "launch_floor_device_ms": floor_device_ms,
                "launch_floor_call_ms": floor_call_ms,
                "yardstick_cdist_topk_ms": knn_tot["es"]["cdist_topk_ms"],
                "launches_by_path": {k: v["knn_tiled"] for k, v in launches.items()},
                "work_list": {
                    "source": "pfilter_tpu_torch/csrc/work_list.cu",
                    "launches_by_path": {k: v["work_list"] for k, v in launches.items()},
                    "device_ms": knn_tot["es"]["work_list_device_ms"],
                },
                "per_path_frame": knn_tot,
                "per_frame_shapes": per_shape,
            },
            {
                "name": "pca_radius",
                "route": "cuda",
                "source": "pfilter_tpu_torch/csrc/pca_radius.cu",
                "replaces": "pfilter_tpu/ops/pca_radius.py:54",
                "launches": launches["bpf_radius"]["pca_radius"],
                "max_abs_err": pca_err,
                "ms": pca_device_ms,
                "device_ms": pca_device_ms,
                "call_ms": pca_call_ms,
                "plain_ms": pca_plain_ms,
                "bound_ms": pca_bound_ms,
                "bound_by": pca_bound_by,
                "bound_halo_ms": pca_bound_halo_ms,
                "library_ms": None,
                "launch_floor_device_ms": floor_device_ms,
                "launch_floor_call_ms": floor_call_ms,
                "moments_fn_ms": fn_ms,
                "yardstick_cdist_matmul_ms": pca_yard_ms,
                "launches_by_path": {k: v["pca_radius"] for k, v in launches.items()},
                "pairs": pca_pairs,
                "in_ball": hits,
            },
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
