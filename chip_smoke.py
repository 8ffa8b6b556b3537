#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths through ``make_pipeline`` at the full width of
``kitti_config()`` (HDL-64, 1800 azimuth, 131072-point scans) on the pinned
v1 protocol of ``bench.py`` (``make_city_world(seed=7)``,
``make_loop_trajectory(speed=1.5)``, 11 warm-up frames, drift scored on
100-300 m segments that fit the run; every path runs its first 100
frames, scored on 100 m, and phase 27 the whole bench protocol: 850 ES
frames, then 300 BPF).  The scans
are the ones the reference package's stored trajectories were run on:
rendered noise-free on the card, plus ``synthetic.shared_range_noise``
(0.008 m, numpy, seeded by the frame), so that phases 26 and 27 can hold
every path to the reference's own run of it.  The bench protocol's 850
scans are rendered once, up front; every path runs a prefix of them.  Each path runs
with every kernel launch count set to 0 just before it and read just after,
and checks them.  Every pipeline, single-device or map-sharded, runs as it
does by default on the card: frames 0-9 eagerly, frame 10 (the first whose
outer iterations are at their floor) eagerly once more while it captures
the frame as a CUDA graph, every later frame by replaying that graph
(``graphs.py``); each such run must capture exactly one graph and replay it
for every frame after frame 10 (a resumed run: capture at its first frame).
A replay counts the kernel launches (and, in a sharded frame, the
collectives) its capture recorded, so every launch and collective gate
below holds through replays.  The reruns with a plain version run eagerly
(``graphs=False``: the plain versions read sizes on the host).

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
7. where a steady ES frame's time goes (torch.profiler, frame 11 of an eager
   run with a span per stage, and of a replayed run: busy share, kernels),
   and the call sites that synchronise the host while four replayed frames
   are dispatched (two fed as tensors on the card, two as numpy scans, a
   ``GlobalMap.update`` after each): none, gated;
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
    for bit to frames 0-39 of the runs of phases 3 and 8;
19. ES re-associating in every outer iteration (``odometry.assoc_once=False``):
    drift, overflow 0, kNN launches = 2 x the outer iterations of frames
    1-99 (12 decaying to 2: 2 x 243); on the last frame's second iteration
    (queries at the refined pose, kept in the predicted pose's tile order;
    the captured frame's tensors, which the last replay wrote, checked
    against the state before the last frame) the kNN kernel against its
    plain version, bit for bit; the first 10
    frames again with the plain kNN (poses within 1 mm / 1e-4 rad); the host
    syncs of two more numpy-fed frames (none, gated);
20. ES on the grid kNN index (``capacity.knn_impl=grid``, the unfused map
    merge): drift, overflow 0, no kernel launched; the largest number of
    points in one 1 m cell of the maps the last frame queried and of the
    maps after it, at most ``knn_candidates_per_cell`` (32: the grid kNN was
    exact); the grid kNN on the card against the CPU on the last frame's
    inputs, bit for bit; the host syncs of two numpy-fed frames (none);
21. BPF re-associating in every outer iteration behind the fast ground
    filter (``ground.method=fast``): drift, overflow 0, kNN launches = 3 x
    the outer iterations (3 x 243); ``fast_ground_filter`` on the card
    against the port's CPU run of the last frame's scan (masks equal; with
    ``normal_method=1`` too, both runs' normals within 1e-3 of a float64 TLS
    wherever a grid's plane is determined);
22. the map-sharded ES step (``pfilter_tpu_torch/parallel/``) at ``n_seq =
    n_map = 1`` through a real NCCL process group of one rank
    (``ShardedESPipeline`` over ``make_mesh``), on the 100 frames of phase 3,
    replayed as the single-device runs are (one capture at frame 10, its
    NCCL collectives inside the graph, every later frame replayed): poses
    bit for bit phase 3's, drift, overflow 0, kNN launches 2 x 99 and the
    collectives of every frame as the step's structure implies
    (``sharded_collectives``), both counted through replays, the backend
    ``nccl``, and no host sync while frames 90-99 are dispatched; then the
    single-device pipeline again on frames 0-29, its frames 11-29 timed
    beside the sharded run's;
23. the map-sharded BPF step (default voxel front-end) at ``n_seq = n_map =
    1`` for 50 frames, replayed likewise: poses bit for bit the first 50 of
    phase 8, overflow 0, kNN launches 3 x 49, the collectives as implied, no
    host sync while frames 40-49 are dispatched; and the single-device rerun
    as in 22;
24. eager against replayed: frames 0-29 of ES, default BPF and radius BPF
    with ``graphs=False``, poses bit for bit those of phases 3, 8 and 11,
    then a replayed rerun (one capture, bit for bit); frames 11-29 timed
    in both; frame 30 of the rerun under the profiler (the device's busy
    share, the kernels of a replayed frame, the kNN, PCA and work-list
    kernels' time inside it); the pose graph's device time (a CUDA graph of
    POSE_GRAPH_REPEATS calls of ``smoothed_newest``);
25. the map-sharded steps eager against replayed, over a new NCCL group of
    one rank: frames 0-29 of sharded ES and BPF with ``graphs=False``, poses
    bit for bit those of phases 22-23, then a replayed rerun (one capture,
    bit for bit); frames 11-29 timed in both, beside a replayed
    single-device rerun; frame 30 of each rerun under the profiler (busy
    share, kernels, the NCCL kernels' and the kNN kernel's time in it);
26. parity with the reference: DCVC's azimuths (``dcvc.atan2_f32``) on the
    card equal to the CPU's bit for bit, and its clusters card vs CPU
    logged; then the runs of phases 3, 8, 11, 19-21 and 22-23
    (ES, BPF, radius BPF, ES per-iteration, ES grid, BPF per-iteration with
    the fast ground filter, sharded ES and BPF at ``n_map = 1``) held frame
    by frame to the reference package's run of the same path on the same
    scans (``tests/data/torch_reference_v1.npz``, written on the CPU by
    ``tools/torch_reference_trajectories.py``), over the frames both hold:
    frames 0-9 within 1 cm / 2e-3 rad, every frame within 5 cm / 5e-3 rad,
    overflow lanes equal, map sizes within 5 %, drift at 100 frames within
    0.02 points (``utils/parity.py``); the per-frame gaps, the largest and
    its frame (frames numbered from 0), and the gaps after 10, 50 and 100
    frames (at frames 9, 49 and 99) logged;
27. the bench protocol, through the runner's own function
    (``pfilter_tpu_torch.bench.run_bench``, what ``python -m
    pfilter_tpu_torch.bench --reference tests/data/torch_reference_v1.npz
    --states tests/data/torch_reference_states_v1`` runs) on the scans
    rendered up front: 850 ES frames, then BPF over the first 300, at
    ``kitti_config()``, held to the reference's stored 850-frame ES and
    300-frame BPF runs (``parity.compare_long``: frames 0-99 with phase 26's
    gates; every frame's poses finite and overflow lanes equal; drift (v1,
    full) and each map's mean size over frames 100 on within the bands of
    the port's own spread, ``parity.LONG_DRIFT_BAND`` and
    ``LONG_MAP_MEAN_BAND``); then the six windows (``parity.compare_window``:
    the reference's own state after ES frames 149, 294, 480, 799 and BPF
    frames 149, 249 restored in the port, 50 frames run from it, held to the
    reference's with phase 26's gates over each window's
    ``parity.WINDOW_LENGTHS``; one capture and 49 replays, kNN launches 2 x
    50 / 3 x 50 a window); every gate gated; no protocol deviation; overflow
    0; one capture per pipeline, 839 and 289 frames replayed; kNN launches 2
    x 849 and 3 x 299, no PCA launch and one work-list launch per kNN launch
    (each path's and each window's counts set to 0 just before it and read
    just after it); drift below 0.783 % at v1 and full; frames 0-99 bit for
    bit phases 3 and 8; the map peaks against their caps, ms/frame and the
    gaps every 50 frames logged.

Exits non-zero, without the final line, if any phase fails or no CUDA card
is present.  Prints the script's wall time.  The last three lines are a
JSON ``kernels`` record (the kNN, PCA and work-list kernels), the nvidia-smi
line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

FRAMES = 100  # the radius-BPF path's frames (100 m segments score; the reference's stored run holds 60)
# The script must finish well inside the chip run's time limit, and the host
# takes 0.4-0.8 s per frame: ES and default BPF run 100 frames (100 m
# segments still score), as do the three option paths of phases 19-21.
ES_FRAMES = 100
BPF_FRAMES = 100
OPTION_FRAMES = 100  # ES per-iteration, ES grid, BPF per-iteration with the fast ground filter
OPTION_PLAIN_FRAMES = 10  # ES per-iteration frames rerun with the plain kNN
# Fast-ground TLS normals against a float64 TLS on grids whose plane is
# determined (eigengap >= 1 % of the trace), and heights, card vs CPU: the
# tolerances of tests/test_torch_fast_ground.py.
NORMAL_TOL = 1e-3
NORMAL_GAP = 1e-2
HAG_TOL_M = 1e-6
# Frames 0-10 warm up: the first frame, the nine whose outer iterations
# decay (11 down to 3), and frame 10, the first at the floor of 2, which runs
# eagerly once more and captures the CUDA graph every later frame replays.
WARMUP = 11
SPEED = 1.5
AZIMUTH = 1800
LENGTHS = (100.0, 200.0, 300.0)
DRIFT_BAR = 0.783  # the C++ reference's KITTI drift (BASELINE.md)
PLAIN_FRAMES = 20
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-4
REPEATS = 50
GRAPH_REPLAYS = 5  # replays of a captured graph of REPEATS calls, timed together
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
FLOPS_PER_PAIR = 8  # 3 sub + 3 mul + 2 add per (query, candidate)
FLOPS_PER_HIT = 16  # 10 adds + 6 products per (query, in-ball candidate)
TPU_BPF_DRIFT = 0.3609  # the reference package's BPF v1 drift on a TPU v5 lite (BENCH_r05.json)
RADIUS_OVERRIDES = ("pca.impl=radius", "capacity.frontend_tile_cap=5120")
REFERENCE = Path(__file__).resolve().parent / "tests" / "data" / "torch_reference_v1.npz"  # phase 26 (tools/torch_reference_trajectories.py)
STATES = REFERENCE.parent / "torch_reference_states_v1"  # phase 27's windows (tools/torch_reference_trajectories.py --states)
PLAIN_REPEATS = 5
MEAN_TOL_M = 1e-4
COV_TOL_PER_POINT = 1e-3
RUNNER_FRAMES = 100  # the KITTI runner's sequence: the loop's first 100 frames (148 m, 100 m segments score)
RUNNER_MAP_STRIDE = 5
RUNNER_SEQ = "99"
KITTI_TR = [[0.0, -1.0, 0.0, 0.1], [0.0, 0.0, -1.0, -0.05], [1.0, 0.0, 0.0, 0.2]]  # velodyne -> cam0, an axis swap
RESUME_AT = 20  # checkpoint after 20 frames, resume for 20
SHARDED_BPF_FRAMES = 50  # phase 23 (replayed, as phase 22)
SHARDED_SYNC_FRAMES = 10  # the last frames of phases 22 and 23, replayed under the sync check
NEAR_FRAMES = 30  # the single-device reruns beside phases 22-23 and 25 (frames 11-29 timed in both)
EAGER_FRAMES = 30  # phases 24-25: frames 0-29 eager and replayed (frames 11-29 timed in both)
POSE_GRAPH_REPEATS = 5  # phase 24: smoothed_newest calls in the CUDA graph that times it


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def rotation_angle(q1, q2) -> np.ndarray:
    """Angle (rad) of the relative rotation between wxyz quaternions, per row."""
    a, b = np.asarray(q1, np.float64), np.asarray(q2, np.float64)
    w = np.sum(a * b, axis=1)  # real part of conj(a) * b
    v = a[:, :1] * b[:, 1:] - b[:, :1] * a[:, 1:] - np.cross(a[:, 1:], b[:, 1:])
    return 2.0 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w))


def render_all(cfg, world, poses, synthetic, dev):
    """All frames rendered on the card up front, padded to scan_points
    (rendering is input generation, not the system under test): noise-free,
    plus the range noise the reference's stored trajectories were run with
    (``synthetic.shared_range_noise``, numpy, 0.008 m)."""
    from pfilter_tpu_torch import bench

    frames = bench.pad_scans(cfg, *synthetic.render_shared_sequence(world, poses, cfg.lidar, AZIMUTH, device=dev))
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


WORK_LIST_ERR = [0.0]  # the largest work-list difference found (kernel vs plain), over every comparison


def compare_work_list(knn, bounds, nt, chunk, n_q, name):
    """The work-list kernel against its plain version: the same item count
    and the same items, row for row."""
    wk = knn.work_list(bounds, nt, chunk, n_q).cpu()
    wp = knn.work_list_plain(bounds.cpu(), nt, chunk, n_q)
    n_items = int(wp[0, 0])
    check(wk.shape == wp.shape, f"{name}: work list shapes differ")
    err = float((wk[: 1 + n_items, :3] - wp[: 1 + n_items, :3]).abs().max())
    WORK_LIST_ERR[0] = max(WORK_LIST_ERR[0], err)
    check(err == 0.0, f"{name}: work lists differ")
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
        row["work_list_plain_ms"] = time_cuda(lambda: knn.work_list_plain(bounds, nt, knn.CHUNK, q.shape[0]), PLAIN_REPEATS)
        n_items = int(knn.work_list_plain(bounds.cpu(), nt, knn.CHUNK, q.shape[0])[0, 0])
        # The work list reads the tile ranges once and writes its count and items.
        row["work_list_bound_ms"] = (4 * (nt * nt + 1) + 16 * (1 + n_items)) / HBM_BYTES_PER_S * 1e3
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
    keys = ["device_ms", "work_list_device_ms", "work_list_plain_ms", "work_list_bound_ms", "call_ms", "plain_ms", "bound_ms", "cdist_topk_ms"]
    tot = {k: sum(r[k] for r in rows) for k in keys}
    t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3
    tot["bound_by"] = "bytes" if t_bytes >= tot["bound_ms"] else "operations"
    return tot


def plain_knn_rerun(knn, make_pipe, frames, ref, name, n_frames=PLAIN_FRAMES):
    """The first ``n_frames`` frames of a path with the plain kNN swapped in
    (run eagerly: the plain version reads sizes on the host, which no CUDA
    graph can hold); poses held to POSE_TOL_M / POSE_TOL_RAD against the
    kernel run ``ref``."""
    kernel_path = knn.query_tiled_sorted
    knn.query_tiled_sorted = knn.query_tiled_sorted_plain
    try:
        plain = make_pipe()
        for i in range(n_frames):
            plain.process_frame(*frames[i])
    finally:
        knn.query_tiled_sorted = kernel_path
    pq, pt = plain.trajectory
    dt = float(np.max(np.linalg.norm(pt - ref["t"][:n_frames], axis=1)))
    dr = float(np.max(rotation_angle(pq, ref["q"][:n_frames])))
    log(f"  max pose difference: {dt:.3e} m, {dr:.3e} rad")
    check(dt <= POSE_TOL_M and dr <= POSE_TOL_RAD, f"{name}: plain-kNN poses differ: {dt} m, {dr} rad")


def profile_frame(pipe, frames, i, stages=()):
    """Profile frame ``i`` of ``pipe`` (torch.profiler; frames before it
    already run), with a span around each of ``stages`` (wrapped here, not
    in the package; an eager frame only: a replay calls no Python).  Returns
    the wall (profiler on, so inflated), the device's busy time and share,
    the kernels the card ran and the host's launch calls (a replayed frame
    launches its graph once), the device time of each kernel by name, and
    each stage's host time and the device time of its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    originals = [(mod, name, getattr(mod, name)) for mod, name in stages]

    def spanned(name, fn):
        def run(*args, **kwargs):
            with record_function("stage::" + name):
                return fn(*args, **kwargs)

        return run

    torch.cuda.synchronize()
    try:
        for mod, name, fn in originals:
            setattr(mod, name, spanned(name, fn))
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    by_kernel = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    busy_ms = sum(by_kernel.values())
    stage_ms = {
        e.key[7:]: dict(host_ms=e.cpu_time_total / 1e3, device_ms=e.device_time_total / 1e3)
        for e in events
        if e.key.startswith("stage::") and e.device_type == DeviceType.CPU
    }
    return dict(
        wall_ms=wall_ms,
        busy_ms=busy_ms,
        busy_pct=busy_ms / wall_ms * 100,
        kernels=sum(e.count for e in kernels),
        launch_calls=sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")),
        graph_launches=sum(e.count for e in events if e.key in ("cudaGraphLaunch", "cuGraphLaunch")),
        by_kernel=by_kernel,
        by_kernel_count={e.key: e.count for e in kernels},
        stages=stage_ms,
    )


def log_profile(label, pr):
    log(f"  {label}: wall {pr['wall_ms']:.1f} ms (profiled); device busy {pr['busy_ms']:.2f} ms = {pr['busy_pct']:.1f} % of wall; "
        f"{pr['kernels']} kernels on the card; host launch calls {pr['launch_calls']}, graph launches {pr['graph_launches']}")
    for name, st in sorted(pr["stages"].items(), key=lambda kv: -kv[1]["host_ms"]):
        log(f"  stage {name}: host {st['host_ms']:.1f} ms, its kernels {st['device_ms']:.2f} ms")
    for name, ms in sorted(pr["by_kernel"].items(), key=lambda kv: -kv[1])[:6]:
        log(f"  kernel {name[:70]}: {ms:.3f} ms, {pr['by_kernel_count'][name]} launches")


def kernel_ms_in(pr, symbol):
    """Device ms and count of the kernels whose name holds ``symbol``."""
    hits = [k for k in pr["by_kernel"] if symbol in k]
    return sum(pr["by_kernel"][k] for k in hits), sum(pr["by_kernel_count"][k] for k in hits)


def profile_steady_frames(make_pipe, frames, stages, between=None):
    """Frame WARMUP of two fresh runs under the profiler: an eager one
    (``graphs=False``), with a span around each stage, for the host time of
    each stage and the device time of its kernels; and one replayed from the
    CUDA graph captured at frame WARMUP - 1, for the device's busy share and
    the kernels of a replayed frame.  Then count the call sites that
    synchronise the host while the replayed run dispatches four more frames,
    two fed as tensors on the card and two as numpy scans (the valid points
    only, as a sensor or a KITTI file gives them), with ``between(pipe,
    scan)`` called after each frame on its numpy scan; fail unless there are
    none.  Returns both profiles."""
    out = {}
    for label, graphs in (("eager", False), ("replayed", True)):
        pipe = make_pipe(graphs)
        for i in range(WARMUP):
            pipe.process_frame(*frames[i])
        pipe.flush()
        check(len(pipe.captures) == int(graphs), f"profile: {len(pipe.captures)} captures before the {label} frame")
        out[label] = profile_frame(pipe, frames, WARMUP, stages if not graphs else ())
        check(pipe.replays == int(graphs), f"profile: the {label} frame was {'not ' if graphs else ''}replayed")
        log_profile(f"{label} frame {WARMUP}", out[label])
    first = WARMUP + 1
    check_host_syncs(pipe, frames, range(first, first + 4), 2, "", between)
    return out


def check_host_syncs(pipe, frames, checked, n_tensor, name, between=None):
    """Count the call sites that synchronise the host while ``pipe`` (with
    its lagged fetch put out of reach) dispatches the frames ``checked``: the
    first ``n_tensor`` fed as tensors on the card, the rest as numpy scans
    (the valid points only, as a sensor or a KITTI file gives them), with
    ``between(pipe, scan)`` called after each frame on its numpy scan.
    PyTorch's sync debug mode warns at each synchronising call; fail unless
    there are none."""
    pipe.fetch_lag = 10**6
    first = checked[0]
    scans = {i: frames[i][0][frames[i][1]].cpu().numpy() for i in checked}  # read back before the check
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in checked:
                if i < first + n_tensor:
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
    n_numpy = len(checked) - n_tensor
    log(f"  {name}host syncs while dispatching {len(checked)} frames ({n_tensor} tensor-fed, {n_numpy} numpy-fed"
        f"{', a global-map update after each' if between else ''}): {len(syncs)} call sites {syncs}")
    check(not syncs, f"{name}a frame's dispatch synchronises the host at {syncs}")


def run_protocol(pipe, frames, gt, metrics, n_frames, keep_state_before=None):
    """Warm up, time the steady loop over ``n_frames``, score drift and ATE
    against ``gt``; with ``keep_state_before`` the state the pipeline held
    before that frame (a state a caller keeps is never written again)."""
    from pfilter_tpu_torch.utils import parity

    gt = gt[:n_frames]
    kept = None
    for i in range(WARMUP):
        pipe.process_frame(*frames[i])
    pipe.flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP, n_frames):
        if i == keep_state_before:
            kept = pipe.state
        pipe.process_frame(*frames[i])
    pipe.flush()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    q_est, t_est = pipe.trajectory
    est = metrics.poses_to_matrices(q_est, t_est)
    path = metrics.trajectory_distances(gt)[-1]
    # Every protocol length the path holds, as the KITTI runner scores (the
    # 100-frame paths, ~121 m, score their 100 m segments).
    lengths = tuple(length for length in LENGTHS if length <= path)
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
        captures=list(pipe.captures),
        replays=pipe.replays,
        graphs=pipe.graphs,
        n_frames=n_frames,
        state_before=kept,
        records=parity.records_arrays(pipe.records),
    )
    log(f"  frames/s {r['fps']:.3f}  ms/frame {r['ms']:.2f}  (steady {n_frames - WARMUP} of {n_frames} frames; "
        f"CUDA graphs captured {len(r['captures'])}, frames replayed {r['replays']})")
    for c in r["captures"]:
        log(f"  capture: {c}")
    log(f"  drift_t_pct {r['drift']:.4f}  r_err_deg_per_m {r['r_err']:.6f}  segments {r['segments']}  lengths {lengths}")
    log(f"  ate_rmse_m {r['ate']:.4f}  path_m {path:.1f}  overflow_total {r['overflow']}  n_dropped {r['dropped']}")
    return r


def gate_protocol(name, r):
    """Zero overflow, finite poses, drift below the reference's bar; a run
    with CUDA graphs captured one and replayed it for every frame after
    WARMUP - 1."""
    if r["graphs"]:
        check_graphs(name, r["captures"], r["replays"], r["n_frames"])
    check(r["overflow"] == 0, f"{name}: overflow_total {r['overflow']} != 0")
    check(np.isfinite(r["q"]).all() and np.isfinite(r["t"]).all(), f"{name}: non-finite poses")
    check(r["segments"] > 0 and r["drift"] < DRIFT_BAR, f"{name}: drift {r['drift']} not below {DRIFT_BAR}")


def check_graphs(name, captures, replays, n_frames, first=WARMUP - 1):
    """One CUDA graph captured (at frame ``first``), replayed for every
    frame after it."""
    check(len(captures) == 1, f"{name}: {len(captures)} CUDA graphs captured, not 1: {captures}")
    check(replays == n_frames - first - 1, f"{name}: {replays} frames replayed, not {n_frames - first - 1}")


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
    from pfilter_tpu_torch import bench, run_kitti
    from pfilter_tpu_torch.utils import kitti, metrics, synthetic

    dev = torch.device("cuda")
    sub = synthetic.make_loop_trajectory(RUNNER_FRAMES, speed=SPEED)
    t0 = time.perf_counter()
    xyz, valid = synthetic.render_sequence(world, sub, cfg.lidar, AZIMUTH, noise=0.008, device=dev)
    scans = [xyz[i][valid[i]].cpu().numpy() for i in range(RUNNER_FRAMES)]
    gt = bench.ground_truth(sub)
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
    log(f"  CUDA graphs captured {len(pipe.captures)} ({pipe.captures}), frames replayed {pipe.replays}")
    log(f"  frames/s {res['fps']}  mean ms/frame {res['mean_ms']} (frames 10-{RUNNER_FRAMES - 1}, sync=True: a fetch per frame)  "
        f"drift_t_pct {res.get('drift_t_pct')}  ate_rmse_m {res.get('ate_rmse_m')}  overflow {res['overflow_total']}  device {res['device']}")
    log(f"  kernel launches {counts}")
    check(res["device"] == torch.cuda.get_device_name(0), f"runner device {res['device']!r}")
    check(res["overflow_total"] == 0, f"runner: overflow_total {res['overflow_total']} != 0")
    check(np.isfinite(res.get("drift_t_pct", np.nan)) and res["drift_t_pct"] < DRIFT_BAR, f"runner: drift {res.get('drift_t_pct')} not below {DRIFT_BAR}")
    check(counts["knn_tiled"] == 2 * (RUNNER_FRAMES - 1), f"runner: kNN launches {counts} != {2 * (RUNNER_FRAMES - 1)}")
    check_graphs("runner", pipe.captures, pipe.replays, RUNNER_FRAMES)

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
    check_graphs(f"{name} before the checkpoint", first.captures, first.replays, RESUME_AT)
    resumed = (ESPipeline if name == "es" else BPFPipeline)(cfg, state=restored, sync=False, fetch_lag=4, device=dev)
    t0 = time.perf_counter()
    for i in range(RESUME_AT, 2 * RESUME_AT):
        resumed.process_frame(*frames[i])
    q2, t2 = resumed.trajectory
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / RESUME_AT * 1e3
    check_graphs(f"{name} resumed", resumed.captures, resumed.replays, RESUME_AT, first=0)
    size = sum(f.stat().st_size for f in ckpt_dir.iterdir())
    same1 = np.array_equal(q1, ref["q"][:RESUME_AT]) and np.array_equal(t1, ref["t"][:RESUME_AT])
    same2 = np.array_equal(q2, ref["q"][RESUME_AT : 2 * RESUME_AT]) and np.array_equal(t2, ref["t"][RESUME_AT : 2 * RESUME_AT])
    log(f"  {name}: checkpoint {size} bytes ({meta['n_leaves']} leaves); frames 0-{RESUME_AT - 1} equal to the uninterrupted run: {same1}; "
        f"resumed frames {RESUME_AT}-{2 * RESUME_AT - 1} equal: {same2} (max |dt| {np.abs(t2 - ref['t'][RESUME_AT : 2 * RESUME_AT]).max():.3e} m); "
        f"resumed run {ms:.2f} ms/frame")
    check(same1 and same2, f"{name}: the resumed run differs from the uninterrupted one")


class Recorder:
    """While installed, keeps the arguments of the last ``keep`` calls of
    ``module.name`` (references, no copies) and passes each call on."""

    def __init__(self, module, name, keep):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.calls = collections.deque(maxlen=keep)

    def __enter__(self):
        def recorded(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def recorded_are_last_frame(calls, state_before, map_names, name):
    """The arguments a ``Recorder`` kept are the tensors of the frame that
    was captured; every replay writes its own values into them, so after a
    run they hold the last frame's.  Checks that the map each call queried
    (the first calls: edge, then surf) equals the state the pipeline held
    before the last frame."""
    for args, map_name in zip(calls, map_names):
        want = getattr(state_before, map_name)
        same = all(torch.equal(getattr(args[0], f), getattr(want, f)) for f in ("xyz", "valid"))
        check(same, f"{name}: the recorded {map_name} is not the one the last frame queried")
    log(f"  recorded kNN inputs hold the last frame's: the maps they query equal the state before it")


def outer_iterations(cfg, n_frames):
    """Outer iterations of frames 1 .. n_frames-1, as ``es_step`` counts
    them: 12 after the first frame, one fewer each frame, at least 2."""
    o, count, total = cfg.odometry, cfg.odometry.max_outer_iters, 0
    for _ in range(1, n_frames):
        count = max(o.min_outer_iters, count - 1)
        total += count
    return total


def off_tile(knn, q, bounds, origin, params):
    """Sorted queries whose current position lies in another tile than the
    one they were sorted into, and the largest such move in tiles."""
    nt, tc, _ = params
    p = torch.arange(int(bounds[nt * nt]), dtype=torch.int32, device=q.device)
    tid = torch.clamp(torch.searchsorted(bounds, p, right=True) - 1, 0, nt * nt - 1)
    cur = knn._tile_ids(q[: p.shape[0]], torch.ones_like(p, dtype=torch.bool), origin, nt, tc)
    moved = torch.maximum((cur // nt - tid // nt).abs(), (cur % nt - tid % nt).abs())
    return int((moved > 0).sum()), int(moved.max()) if p.shape[0] else 0


def max_cell_occupancy(grid):
    """The largest number of valid points in one cell of a grid map."""
    ids = grid.cell_ids[grid.valid]
    return int(torch.unique_consecutive(ids, return_counts=True)[1].max()) if ids.numel() else 0


def compare_grid_knn(kg, args, name):
    """The grid kNN on the card against the same function on the CPU on the
    same inputs: distances and indices identical."""
    grid, q, qv, k, p = args
    rd = kg.knn_query(grid, q, qv, k, p)
    cpu = kg.HashGrid(*(x.cpu() for x in grid))
    rc = kg.knn_query(cpu, q.cpu(), qv.cpu(), k, p)
    dd, dc = rd.sqdist.cpu().numpy(), rc.sqdist.numpy()
    fin = np.isfinite(dc)
    err = float(np.max(np.abs(dd[fin] - dc[fin]))) if fin.any() else 0.0
    mismatch = int((rd.idx.cpu().numpy() != rc.idx.numpy()).sum())
    log(f"  {name}: Q={q.shape[0]} valid={int(qv.sum())} map={int(grid.valid.sum())} finite={int(fin.sum())} "
        f"idx_mismatch={mismatch} max_abs_err={err:.3e}")
    check(np.array_equal(dd, dc), f"{name}: grid kNN distances differ between the card and the CPU (max abs {err})")
    check(mismatch == 0, f"{name}: {mismatch} grid kNN indices differ between the card and the CPU")
    return time_cuda(lambda: kg.knn_query(grid, q, qv, k, p), 10)


def compare_fast_ground(fg, xyz, valid, fcfg, name):
    """``fast_ground_filter`` on the card against the port's CPU run of the
    same scan: masks equal, heights within HAG_TOL_M; for the TLS normals
    (``normal_method`` 1-3), both runs within NORMAL_TOL of a float64 TLS of
    each grid's ground points wherever that plane is determined (at least 3
    points, eigengap at least NORMAL_GAP of the trace), and every normal a
    unit vector with z >= 0; two card runs bitwise equal."""
    a = fg.fast_ground_filter(xyz, valid, fcfg)
    a2 = fg.fast_ground_filter(xyz, valid, fcfg)
    b = fg.fast_ground_filter(xyz.cpu(), valid.cpu(), fcfg)
    for f in ("ground_mask", "ground_down_mask", "nonground_mask"):
        diff = int((getattr(a, f).cpu() != getattr(b, f)).sum())
        check(diff == 0, f"{name}: {f} differs from the CPU run in {diff} points")
    d_hag = float((a.height_above_ground.cpu() - b.height_above_ground).abs().max())
    same = all(torch.equal(x, y) for x, y in zip(a, a2))
    ground = b.ground_mask.numpy()
    na, nb = a.normal.cpu().numpy(), b.normal.numpy()
    if fcfg.normal_method == 0:
        d_nrm, note = float(np.abs(na - nb).max()), "normals (0, 0, 1)"
        check(d_nrm == 0.0, f"{name}: normals differ")
    else:
        gid = fg.grid_layout(xyz.cpu(), valid.cpu(), fcfg)[2].numpy()
        exact, gap, enough = fg.tls_normals_float64(xyz.cpu().numpy(), ground, gid)
        sel = ground & enough & (gap >= NORMAL_GAP)
        d_nrm = float(np.abs(na[sel] - nb[sel]).max())
        d_a, d_b = float(np.abs(na[sel] - exact[sel]).max()), float(np.abs(nb[sel] - exact[sel]).max())
        unit = bool(np.allclose(np.linalg.norm(na[ground], axis=1), 1.0, atol=1e-5) and (na[ground, 2] >= 0).all())
        note = (f"normals on {int(sel.sum())} of {int(ground.sum())} ground points (grids whose plane is determined): "
                f"card vs CPU {d_nrm:.3e}, card vs float64 TLS {d_a:.3e}, CPU vs float64 TLS {d_b:.3e}; unit and +z: {unit}")
        check(unit and max(d_a, d_b) <= NORMAL_TOL, f"{name}: normals beyond {NORMAL_TOL} of the float64 TLS ({d_a}, {d_b}) or not unit")
    log(f"  {name}: N={xyz.shape[0]} ground {int(a.ground_mask.sum())} (down {int(a.ground_down_mask.sum())}) "
        f"non-ground {int(a.nonground_mask.sum())}; masks equal to the CPU run; |d height| {d_hag:.3e} m; {note}; run_to_run_equal={same}")
    check(d_hag <= HAG_TOL_M, f"{name}: heights differ by {d_hag} m")
    check(same, f"{name}: two runs on the card differ")
    return time_cuda(lambda: fg.fast_ground_filter(xyz, valid, fcfg), 10)


def option_phases(cfg, frames, gt, phase, zero_counts, read_counts, launches):
    """Phases 19-21: the options ES per-iteration, ES on the grid index and
    BPF per-iteration behind the fast ground filter, each driven through
    ``make_pipeline`` for OPTION_FRAMES frames and gated.  Adds each path's
    launch counts to ``launches``; returns the largest kNN kernel-vs-plain
    difference (0: bit for bit) and the three runs (``run_protocol``'s
    records) by path."""
    from pfilter_tpu_torch.ops import fast_ground
    from pfilter_tpu_torch.ops import knn as knn_grid
    from pfilter_tpu_torch.ops import knn_tiled as knn
    from pfilter_tpu_torch.pipeline import make_pipeline
    from pfilter_tpu_torch.utils import metrics

    knn_err = 0.0
    cfg_bpf = cfg.replace(mode="bpf")
    phase("phase 19: ES re-associating in every outer iteration (assoc_once=False, %d frames)" % OPTION_FRAMES)
    cfg_pi = cfg.replace(odometry=dataclasses.replace(cfg.odometry, assoc_once=False))
    pipe = make_pipeline(cfg_pi, sync=False, fetch_lag=4)
    zero_counts()
    with Recorder(knn, "query_tiled_sorted", 4) as rec:  # the captured frame's two iterations, edge and surf
        es_pi = run_protocol(pipe, frames, gt, metrics, OPTION_FRAMES, keep_state_before=OPTION_FRAMES - 1)
    launches["es_per_iteration"] = read_counts()
    want = 2 * outer_iterations(cfg_pi, OPTION_FRAMES)
    log(f"  kernel launches {launches['es_per_iteration']} (kNN wanted: 2 maps x {want // 2} outer iterations = {want})")
    gate_protocol("es per-iteration", es_pi)
    check(launches["es_per_iteration"]["knn_tiled"] == want, f"es per-iteration: kNN launches {launches['es_per_iteration']} != {want}")
    check(launches["es_per_iteration"]["pca_radius"] == 0, "es per-iteration: PCA launched")
    calls = [args for args, _ in rec.calls]
    check(len(calls) == 4, f"es per-iteration: recorded {len(calls)} kNN calls of the last frame")
    recorded_are_last_frame(calls, es_pi["state_before"], ("edge_map", "surf_map"), "es per-iteration")
    for kind, first, last in (("edge", calls[0], calls[2]), ("surf", calls[1], calls[3])):
        tmap, q, bounds, nt, tc, tcap = last[:6]
        n_q = int(bounds[nt * nt])
        moved = float((q[:n_q] - first[1][:n_q]).norm(dim=1).max())
        n_off, max_off = off_tile(knn, q, bounds, tmap.origin, (nt, tc, tcap))
        log(f"  {kind}: last frame's second iteration, queries at the refined pose in the predicted pose's tile order: "
            f"moved up to {moved:.4f} m from the first iteration's; {n_off} of {n_q} now in another tile (up to {max_off} tile)")
        knn_err = max(knn_err, compare(knn, tmap, q, bounds, (nt, tc, tcap), f"es per-iteration {kind} map, refined pose"))
    plain_knn_rerun(knn, lambda: make_pipeline(cfg_pi, sync=True, graphs=False), frames, es_pi, "es per-iteration", OPTION_PLAIN_FRAMES)
    check_host_syncs(pipe, frames, range(OPTION_FRAMES, OPTION_FRAMES + 2), 0, "es per-iteration: ")

    phase("phase 20: ES on the grid kNN index (knn_impl=grid, unfused merge, %d frames)" % OPTION_FRAMES)
    cfg_grid = cfg.replace(capacity=dataclasses.replace(cfg.capacity, knn_impl="grid"))
    pipe = make_pipeline(cfg_grid, sync=False, fetch_lag=4)
    zero_counts()
    with Recorder(knn_grid, "knn_query", 2) as rec:  # the captured frame's edge and surf queries
        es_grid = run_protocol(pipe, frames, gt, metrics, OPTION_FRAMES, keep_state_before=OPTION_FRAMES - 1)
    launches["es_grid"] = read_counts()
    log(f"  kernel launches {launches['es_grid']}")
    gate_protocol("es grid", es_grid)
    check(all(v == 0 for v in launches["es_grid"].values()), f"es grid: kernels launched {launches['es_grid']}")
    recorded_are_last_frame([args for args, _ in rec.calls], es_grid["state_before"], ("edge_map", "surf_map"), "es grid")
    per_cell = cfg_grid.capacity.knn_candidates_per_cell
    occupancy = {f"{kind} map queried by the last frame": max_cell_occupancy(args[0]) for kind, (args, _) in zip(("edge", "surf"), rec.calls)}
    occupancy.update({f"{kind} map after it": max_cell_occupancy(getattr(pipe.state, kind + "_map")) for kind in ("edge", "surf")})
    log(f"  largest points per 1 m cell {occupancy} (candidates read per cell: {per_cell})")
    check(len(occupancy) == 4 and max(occupancy.values()) <= per_cell, f"es grid: a cell holds more than {per_cell} points: {occupancy}")
    grid_ms = {kind: compare_grid_knn(knn_grid, args, f"grid kNN, {kind} map, last frame") for kind, (args, _) in zip(("edge", "surf"), rec.calls)}
    log(f"  grid kNN on the card (CUDA events, 10 calls): {grid_ms} ms")
    check_host_syncs(pipe, frames, range(OPTION_FRAMES, OPTION_FRAMES + 2), 0, "es grid: ")

    phase("phase 21: BPF re-associating in every outer iteration, fast ground filter (%d frames)" % OPTION_FRAMES)
    cfg_bpf_pi = cfg_bpf.replace(
        odometry=dataclasses.replace(cfg.odometry, assoc_once=False), ground=dataclasses.replace(cfg.ground, method="fast")
    )
    pipe = make_pipeline(cfg_bpf_pi, sync=False, fetch_lag=4)
    zero_counts()
    bpf_pi = run_protocol(pipe, frames, gt, metrics, OPTION_FRAMES)
    launches["bpf_per_iteration_fast"] = read_counts()
    want = 3 * outer_iterations(cfg_bpf_pi, OPTION_FRAMES)
    log(f"  kernel launches {launches['bpf_per_iteration_fast']} (kNN wanted: 3 maps x {want // 3} outer iterations = {want}); "
        f"map sizes {pipe.records[-1].map_sizes.tolist()}")
    gate_protocol("bpf per-iteration fast ground", bpf_pi)
    check(launches["bpf_per_iteration_fast"]["knn_tiled"] == want, f"bpf per-iteration: kNN launches {launches['bpf_per_iteration_fast']} != {want}")
    xyz_f, valid_f = frames[OPTION_FRAMES - 1]
    fg_ms = {}
    for label, fcfg in (("path config", cfg_bpf_pi.fast_ground), ("normal_method=1", dataclasses.replace(cfg_bpf_pi.fast_ground, normal_method=1))):
        fg_ms[label] = compare_fast_ground(fast_ground, xyz_f, valid_f, fcfg, f"fast ground filter ({label}), last frame")
    log(f"  fast_ground_filter on the card (CUDA events, 10 calls): {fg_ms} ms")
    return knn_err, {"es_per_iteration": es_pi, "es_grid": es_grid, "bpf_per_iteration_fast": bpf_pi}


def sharded_collectives(cfg, n_maps: int, opt_count):
    """(all-gathers, all-reduces) of one frame of the map-sharded step, from
    its structure (``parallel/es_sharded.py``): the first frame
    (``opt_count`` None) all-reduces its map sizes once; a later frame
    all-reduces the map sizes once, then per map all-gathers the kNN
    candidates and the g increments and writebacks (once per frame with
    ``assoc_once``, else in every outer iteration), all-reduces H and b in
    each of the ``inner_gn_iters`` Gauss-Newton steps of each outer iteration
    (and the weights' ranges once per outer iteration when ``weight_type`` >
    0), and all-reduces its counts and overflow lanes once at the end."""
    o = cfg.odometry
    if opt_count is None:
        return 0, 1
    gathers = 2 * n_maps * (1 if o.assoc_once else opt_count)
    return gathers, 2 + opt_count * (o.inner_gn_iters + (1 if o.weight_type else 0))


def outer_counts(cfg, n_frames):
    """Outer iterations of each frame 0 .. n_frames-1 (None for the first)."""
    o, count, out = cfg.odometry, cfg.odometry.max_outer_iters, [None]
    for _ in range(1, n_frames):
        count = max(o.min_outer_iters, count - 1)
        out.append(count)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def timed_frames(pipe, frames, start, stop, after=None):
    """Dispatch frames start..stop-1 (calling ``after(i)`` after each), drain
    the lagged fetches and wait for the card: ms/frame."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(start, stop):
        pipe.process_frame(*frames[i])
        if after is not None:
            after(i)
    pipe.flush()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (stop - start) * 1e3


def single_device_near(make_pipeline, cfg, frames):
    """The single-device pipeline on frames 0..NEAR_FRAMES-1, frames
    WARMUP..NEAR_FRAMES-1 timed: the figure beside a sharded phase's."""
    pipe = make_pipeline(cfg, sync=False, fetch_lag=4)
    timed_frames(pipe, frames, 0, WARMUP)
    ms = timed_frames(pipe, frames, WARMUP, NEAR_FRAMES)
    check_graphs("single-device rerun", pipe.captures, pipe.replays, NEAR_FRAMES)
    return ms


def nccl_group():
    """An NCCL process group of one rank on this card (``tcp://127.0.0.1`` at
    a free port) and its 1 x 1 mesh; destroy the group after use."""
    import torch.distributed as dist

    from pfilter_tpu_torch.parallel import mesh as meshlib

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    mesh = meshlib.make_mesh(1, 1)
    check(mesh.backend == "nccl", f"sharded: backend {mesh.backend!r}, not nccl")
    return mesh


def sharded_paths(cfg, cfg_bpf, es, bpf):
    """(name, config, pipeline class, frames, maps, single-device run) of
    phases 22-23 and 25."""
    from pfilter_tpu_torch.parallel.pipeline import ShardedBPFPipeline, ShardedESPipeline

    return (("es", cfg, ShardedESPipeline, ES_FRAMES, 2, es), ("bpf", cfg_bpf, ShardedBPFPipeline, SHARDED_BPF_FRAMES, 3, bpf))


def sharded_phases(cfg, cfg_bpf, frames, gt, es, bpf, phase, zero_counts, read_counts, launches):
    """Phases 22-23: the map-sharded ES and BPF steps over an NCCL process
    group of one rank on this card, replayed from a CUDA graph with their
    collectives from frame 11 on, each held to its single-device path of
    phases 3 and 8 bit for bit.  Adds each path's launch counts to
    ``launches``; returns their timing and collective records, their poses,
    and their per-frame records (``parity.records_arrays``)."""
    import torch.distributed as dist

    from pfilter_tpu_torch.pipeline import make_pipeline
    from pfilter_tpu_torch.utils import metrics, parity

    out, poses, records = {}, {}, {}
    mesh = nccl_group()
    try:
        for name, c, pipe_cls, n_frames, n_maps, ref in sharded_paths(cfg, cfg_bpf, es, bpf):
            if name == "es":
                phase("phase 22: map-sharded ES, n_seq = n_map = 1 over NCCL, replayed (%d frames)" % n_frames)
            else:
                phase("phase 23: map-sharded BPF, default front-end, n_seq = n_map = 1 over NCCL, replayed (%d frames)" % n_frames)
            pipe = pipe_cls(c, mesh=mesh, sync=False, fetch_lag=4)
            zero_counts()
            mesh.reset_counts()
            per_frame, prev = [], dict(mesh.counts)

            def after(i):
                nonlocal prev
                cur = dict(mesh.counts)
                per_frame.append((cur["all_gather"] - prev["all_gather"], cur["all_reduce"] - prev["all_reduce"]))
                prev = cur

            timed_frames(pipe, frames, 0, WARMUP, after)  # frame 0 builds the NCCL communicator; frame 10 captures
            ms_near = timed_frames(pipe, frames, WARMUP, NEAR_FRAMES, after)
            last = n_frames - SHARDED_SYNC_FRAMES
            ms_steady = (ms_near * (NEAR_FRAMES - WARMUP) + timed_frames(pipe, frames, NEAR_FRAMES, last, after) * (last - NEAR_FRAMES)) / (last - WARMUP)
            before = dict(mesh.counts)
            check_host_syncs(pipe, frames, range(last, n_frames), SHARDED_SYNC_FRAMES, f"{name} sharded: ")
            pipe.flush()
            per_frame.append((mesh.counts["all_gather"] - before["all_gather"], mesh.counts["all_reduce"] - before["all_reduce"]))
            launches[f"{name}_sharded"] = read_counts()
            q, t = pipe.trajectory
            for cap in pipe.captures:
                log(f"  capture: {cap}")
            check_graphs(f"{name} sharded", pipe.captures, pipe.replays, n_frames)
            want = [sharded_collectives(c, n_maps, k) for k in outer_counts(c, n_frames)]
            tail = want[last:]
            want = want[:last] + [(sum(w[0] for w in tail), sum(w[1] for w in tail))]
            total = (sum(w[0] for w in per_frame), sum(w[1] for w in per_frame))
            log(f"  backend {mesh.backend}; CUDA graphs captured {len(pipe.captures)}, frames replayed {pipe.replays}; kernel launches "
                f"{launches[f'{name}_sharded']}; collectives {total[0]} all-gathers, {total[1]} all-reduces (a steady frame: "
                f"{per_frame[WARMUP]}, wanted {want[WARMUP]}); overflow {pipe.overflow_total}")
            check(per_frame == want, f"{name} sharded: collectives per frame {per_frame} != {want}")
            check(launches[f"{name}_sharded"]["knn_tiled"] == n_maps * (n_frames - 1), f"{name} sharded: kNN launches {launches[f'{name}_sharded']}")
            check(pipe.overflow_total == 0, f"{name} sharded: overflow_total {pipe.overflow_total}")
            same = np.array_equal(q, ref["q"][:n_frames]) and np.array_equal(t, ref["t"][:n_frames])
            log(f"  poses equal to phase {3 if name == 'es' else 8}'s over {n_frames} frames: {same} (max |dt| {np.abs(t - ref['t'][:n_frames]).max():.3e} m)")
            check(same, f"{name} sharded: poses differ from the single-device path's")
            rec = dict(
                ms_near=ms_near, ms_steady=ms_steady, collectives=dict(all_gather=total[0], all_reduce=total[1]),
                steady_frame_collectives=per_frame[WARMUP], captures=len(pipe.captures), replays=pipe.replays,
                capture_s=pipe.captures[0]["seconds"],
            )
            poses[name] = (q, t)
            records[name] = parity.records_arrays(pipe.records)
            if name == "es":
                est = metrics.poses_to_matrices(q, t)
                drift = metrics.kitti_drift(gt[:n_frames], est, lengths=(100.0,), step=10)
                rec["drift"] = drift["t_err_pct"]
                log(f"  drift_t_pct {rec['drift']:.4f} (100 m segments: {drift['n_segments']})")
                check(drift["n_segments"] > 0 and rec["drift"] < DRIFT_BAR, f"es sharded: drift {rec['drift']} not below {DRIFT_BAR}")
            rec["single_ms_near"] = single_device_near(make_pipeline, c, frames)
            log(f"  ms/frame, frames {WARMUP}-{NEAR_FRAMES - 1}: sharded replayed {ms_near:.2f}, single-device rerun right after {rec['single_ms_near']:.2f} "
                f"(ratio {ms_near / rec['single_ms_near']:.3f}); sharded steady over frames {WARMUP}-{last - 1}: {ms_steady:.2f}")
            out[name] = rec
    finally:
        dist.destroy_process_group()
    return out, poses, records


def sharded_eager_phase(cfg, cfg_bpf, frames, es, bpf, sharded, poses, phase):
    """Phase 25: the map-sharded steps eagerly (``graphs=False``) and
    replayed again, over a new NCCL group of one rank, frames
    0..EAGER_FRAMES-1 of each: the eager poses equal the replayed ones of
    phases 22-23 bit for bit, the replayed rerun captures one graph and
    equals them too; frames WARMUP..EAGER_FRAMES-1 timed in both, beside the
    replayed single-device rerun; frame EAGER_FRAMES of the replayed rerun
    under the profiler: the device's busy time over the unprofiled replayed
    ms/frame, its kernels, the NCCL kernels' time (none at ``n_map = 1``,
    where NCCL runs a collective as a device-to-device copy, so the copies'
    time is reported beside it) and the kNN kernel's.  ``poses``: phases
    22-23's by path.  Adds the figures to ``sharded``."""
    import torch.distributed as dist

    from pfilter_tpu_torch.pipeline import make_pipeline

    phase("phase 25: map-sharded ES and BPF eager against replayed, n_seq = n_map = 1 over NCCL, frames 0-%d" % (EAGER_FRAMES - 1))
    mesh = nccl_group()
    try:
        for name, c, pipe_cls, _, _, _ in sharded_paths(cfg, cfg_bpf, es, bpf):
            rec = sharded[name]
            eager = pipe_cls(c, mesh=mesh, sync=False, fetch_lag=4, graphs=False)
            timed_frames(eager, frames, 0, WARMUP)
            ms_eager = timed_frames(eager, frames, WARMUP, EAGER_FRAMES)
            replayed = pipe_cls(c, mesh=mesh, sync=False, fetch_lag=4)
            timed_frames(replayed, frames, 0, WARMUP)
            ms_replayed = timed_frames(replayed, frames, WARMUP, EAGER_FRAMES)
            check_graphs(f"{name} sharded rerun", replayed.captures, replayed.replays, EAGER_FRAMES)
            eq, et = eager.trajectory
            rq, rt = replayed.trajectory
            q, t = (a[:EAGER_FRAMES] for a in poses[name])
            same = np.array_equal(eq, q) and np.array_equal(et, t)
            rerun_same = np.array_equal(rq, eq) and np.array_equal(rt, et)
            gap = float(np.abs(et - t).max())
            log(f"  {name} sharded: eager poses equal the replayed run's of phase {22 if name == 'es' else 23} over frames 0-{EAGER_FRAMES - 1}: "
                f"{same} (max |dt| {gap:.3e} m); the replayed rerun (one capture) equal too: {rerun_same}")
            check(same and rerun_same, f"{name} sharded: eager and replayed poses differ (max |dt| {gap} m)")
            prof = profile_frame(replayed, frames, EAGER_FRAMES)
            log_profile(f"{name} sharded replayed frame {EAGER_FRAMES}", prof)
            single_ms = single_device_near(make_pipeline, c, frames)
            nccl = [k for k in prof["by_kernel"] if "nccl" in k.lower()]
            copies = [k for k in prof["by_kernel"] if k.startswith("Memcpy DtoD")]
            rec.update(
                ms_eager=ms_eager, ms_replayed=ms_replayed, speedup=ms_eager / ms_replayed, single_ms_replayed=single_ms,
                replayed_busy_ms=prof["busy_ms"], busy_of_steady_pct=prof["busy_ms"] / ms_replayed * 100, replayed_wall_ms=prof["wall_ms"],
                replayed_kernels=prof["kernels"], graph_launches=prof["graph_launches"],
                nccl_ms=sum(prof["by_kernel"][k] for k in nccl), nccl_kernels=sum(prof["by_kernel_count"][k] for k in nccl), nccl_names=nccl,
                dtod_copy_ms=sum(prof["by_kernel"][k] for k in copies), dtod_copies=sum(prof["by_kernel_count"][k] for k in copies),
                knn_in_replay=kernel_ms_in(prof, "knn_tiled_kernel"),
            )
            log(f"  {name} sharded: ms/frame over frames {WARMUP}-{EAGER_FRAMES - 1}: eager {ms_eager:.2f}, replayed {ms_replayed:.2f} "
                f"(x{rec['speedup']:.1f}), the replayed single-device rerun {single_ms:.2f}; a replayed frame: device busy {prof['busy_ms']:.2f} ms "
                f"= {rec['busy_of_steady_pct']:.1f} % of the unprofiled replayed ms/frame, {prof['kernels']} kernels; NCCL kernels "
                f"{rec['nccl_ms']:.4f} ms ({rec['nccl_kernels']}: {nccl}); device-to-device copies {rec['dtod_copy_ms']:.4f} ms "
                f"({rec['dtod_copies']}); kNN {rec['knn_in_replay'][0]:.4f} ms ({rec['knn_in_replay'][1]} launches)")
    finally:
        dist.destroy_process_group()


def eager_phase(paths, frames, phase):
    """Phase 24: frames 0..EAGER_FRAMES-1 of each path in ``paths`` ((name,
    config, the replayed run of its earlier phase)) run eagerly
    (``graphs=False``) and then replayed: the eager poses equal the
    replayed ones bit for bit, and the rerun captures one graph; frames
    WARMUP..EAGER_FRAMES-1 timed in both, near in time; a replayed frame
    under the profiler (the device's busy share, the kernels it runs and
    their times; its busy time over the unprofiled replayed ms/frame, since
    the profiler inflates a frame's wall several times); the pose graph's
    device time, a CUDA graph of POSE_GRAPH_REPEATS calls of
    ``smoothed_newest`` on the first eager run's last window (capturing a
    call takes as long as an eager one, ~1 s of host time)."""
    from pfilter_tpu_torch.ops import pose_graph
    from pfilter_tpu_torch.pipeline import make_pipeline

    phase("phase 24: eager against replayed, frames 0-%d (ES, default BPF, radius BPF)" % (EAGER_FRAMES - 1))
    out, pg_ms = {}, None
    for name, c, ref in paths:
        eager = make_pipeline(c, sync=False, fetch_lag=4, graphs=False)
        timed_frames(eager, frames, 0, WARMUP)
        ms_eager = timed_frames(eager, frames, WARMUP, EAGER_FRAMES)
        replayed = make_pipeline(c, sync=False, fetch_lag=4)
        timed_frames(replayed, frames, 0, WARMUP)
        ms_replayed = timed_frames(replayed, frames, WARMUP, EAGER_FRAMES)
        check_graphs(f"{name} rerun", replayed.captures, replayed.replays, EAGER_FRAMES)
        eq, et = eager.trajectory
        rq, rt = replayed.trajectory
        same = np.array_equal(eq, ref["q"][:EAGER_FRAMES]) and np.array_equal(et, ref["t"][:EAGER_FRAMES])
        rerun_same = np.array_equal(rq, eq) and np.array_equal(rt, et)
        gap = float(np.abs(et - ref["t"][:EAGER_FRAMES]).max())
        log(f"  {name}: eager poses equal the replayed run's (one capture, {ref['replays']} frames replayed) over frames 0-{EAGER_FRAMES - 1}: "
            f"{same} (max |dt| {gap:.3e} m); the replayed rerun equal too: {rerun_same}")
        check(same and rerun_same, f"{name}: eager and replayed poses differ (max |dt| {gap} m)")
        prof = profile_frame(replayed, frames, EAGER_FRAMES)
        log_profile(f"{name} replayed frame {EAGER_FRAMES}", prof)
        if pg_ms is None:  # every path smooths the same window shapes with the same kernels
            st = eager.state
            pg_ms = graph_ms(lambda: pose_graph.smoothed_newest(st.pg_q, st.pg_t, st.pg_h, st.pg_valid, st.pose, c.pose_graph), POSE_GRAPH_REPEATS)
        rec = dict(
            ms_eager=ms_eager, ms_replayed=ms_replayed, speedup=ms_eager / ms_replayed,
            replayed_busy_ms=prof["busy_ms"], replayed_busy_pct=prof["busy_pct"], replayed_wall_ms=prof["wall_ms"],
            busy_of_steady_pct=prof["busy_ms"] / ms_replayed * 100,
            replayed_kernels=prof["kernels"], graph_launches=prof["graph_launches"], pose_graph_device_ms=pg_ms,
            knn_in_replay=kernel_ms_in(prof, "knn_tiled_kernel"), pca_in_replay=kernel_ms_in(prof, "pca_radius_kernel"),
            work_list_in_replay=kernel_ms_in(prof, "work_list_kernel"),
        )
        log(f"  {name}: ms/frame over frames {WARMUP}-{EAGER_FRAMES - 1}: eager {ms_eager:.2f}, replayed {ms_replayed:.2f} "
            f"(x{rec['speedup']:.1f}); a replayed frame: device busy {prof['busy_ms']:.2f} ms = {rec['busy_of_steady_pct']:.1f} % of the "
            f"unprofiled replayed ms/frame ({prof['busy_pct']:.1f} % of its profiled wall), "
            f"{prof['kernels']} kernels; pose graph {pg_ms:.4f} ms on the card (CUDA graph of {POSE_GRAPH_REPEATS} calls, one window for every path); "
            f"kNN in the replayed frame {rec['knn_in_replay'][0]:.4f} ms ({rec['knn_in_replay'][1]} launches), "
            f"PCA {rec['pca_in_replay'][0]:.4f} ms ({rec['pca_in_replay'][1]}), work list {rec['work_list_in_replay'][0]:.4f} ms ({rec['work_list_in_replay'][1]})")
        out[name] = rec
    return out


def dcvc_binning_check(cfg, frames, picks):
    """DCVC's azimuths on the card: ``dcvc.atan2_f32`` equal to its CPU run
    bit for bit on the valid rays of frames ``picks`` (the card's own
    ``torch.atan2`` differs on many), and the clusters of each frame's
    non-ground points on the card against the CPU's (labels differing:
    logged)."""
    from pfilter_tpu_torch.ops import dcvc, ground

    for i in picks:
        xyz, valid = frames[i]
        card = dcvc.atan2_f32(xyz[:, 1], xyz[:, 0]).cpu()
        host = dcvc.atan2_f32(xyz[:, 1].cpu(), xyz[:, 0].cpu())
        v = valid.cpu()
        same = torch.equal(card.view(torch.int32), host.view(torch.int32))
        n_lib = int((torch.atan2(xyz[:, 1], xyz[:, 0]).cpu() != host)[v].sum())
        ng = ground.segment_ground_dispatch(xyz, valid, cfg).nonground_mask
        lc = dcvc.cluster(xyz, ng, cfg.dcvc, cfg.lidar)
        lh = dcvc.cluster(xyz.cpu(), ng.cpu(), cfg.dcvc, cfg.lidar)
        d_label = int((lc.label.cpu() != lh.label).sum())
        d_keep = int((lc.keep.cpu() != lh.keep).sum())
        log(f"  frame {i}: atan2_f32 on the card equal to the CPU on all {int(v.sum())} valid rays: {same} (the card's torch.atan2 "
            f"differs on {n_lib}); DCVC of {int(ng.sum())} non-ground points, card vs CPU: labels differ on {d_label}, keep on {d_keep}")
        check(same, f"frame {i}: atan2_f32 differs between the card and the CPU")


def parity_phase(runs, gt, phase, cfg_bpf, frames):
    """Phase 26: DCVC's azimuth binning on the card against the CPU
    (``dcvc_binning_check``), then every path's run above (``runs``: path
    name -> its ``parity.records_arrays``, on the shared scans) held to the
    reference package's own run of that path, stored in
    ``tests/data/torch_reference_v1.npz``, over the frames both hold, with
    the gates of ``parity.compare``; the per-frame gaps logged.  Fails if any
    path misses a gate (after logging every path)."""
    from pfilter_tpu_torch.utils import metrics, parity

    phase("phase 26: the port against the reference package's own trajectories (%s)" % REFERENCE.relative_to(REFERENCE.parents[2]))
    dcvc_binning_check(cfg_bpf, frames, (0, 33, BPF_FRAMES - 1))
    ref, side = parity.load_reference(REFERENCE)
    log(f"  reference: {side['generator']}, {side['platform']}, jax {side['jax']}, commit {side['commit']['head']}")
    log(f"  scans: {side['noise']}")
    log(f"  gates: frames 0-{parity.COLD_FRAMES - 1} within {parity.COLD_TOL_M} m / {parity.COLD_TOL_RAD} rad; every frame within "
        f"{parity.TOL_M} m / {parity.TOL_RAD} rad; overflow lanes equal; map sizes within {parity.MAP_SIZE_TOL:.0%}; drift at "
        f"{parity.SCORE_AT} frames within {parity.DRIFT_TOL_POINTS} points")
    failed = []
    n = parity.SCORE_AT
    for name, run in runs.items():
        scored = min(len(run["t"]), len(ref[name]["t"])) >= n
        drift = metrics.kitti_drift(gt[:n], metrics.poses_to_matrices(run["q"][:n], run["t"][:n]), lengths=LENGTHS, step=10)["t_err_pct"] if scored else None
        ref_drift = side["paths"][name]["scores"][str(n)]["drift_t_pct"] if scored else None
        res = parity.compare(run, ref[name], drift, ref_drift)
        log("  " + parity.summary(name, res))
        log(f"  {name} gap per frame, cm: " + " ".join(f"{g * 100:.2f}" for g in res["gap_t_m"]))
        log(f"  {name} gap per frame, mrad: " + " ".join(f"{g * 1e3:.3f}" for g in res["gap_rad"]))
        failed += [f"{name}: {f}" for f in res["failures"]]
    check(not failed, f"parity with the reference: {failed}")


def bench_phase(frames, gt, render_s, es, bpf, phase, launches):
    """Phase 27: the bench protocol through the runner's own function
    (``pfilter_tpu_torch.bench.run_bench``, as ``python -m
    pfilter_tpu_torch.bench --reference REFERENCE --states STATES`` runs it)
    on the scans rendered up front: 850 ES frames, then BPF over the first
    300, at ``kitti_config()``, then the windows of STATES.  Gates: the
    runner's own (overflow 0, one capture and every later frame replayed,
    kNN launches, drift below DRIFT_BAR, the free runs' parity of
    ``parity.compare_long``, every window's parity, capture and launches),
    the whole protocol run (no deviation), each path's and each window's
    launch counts (set to 0 just before it and read just after it by the
    runner) with one work-list launch per kNN launch and no PCA launch, and
    frames 0-99 bit for bit phases 3 and 8."""
    from pfilter_tpu_torch import bench
    from pfilter_tpu_torch.config import kitti_config
    from pfilter_tpu_torch.utils import parity

    p = bench.PROTOCOL
    root = REFERENCE.parents[2]
    phase("phase 27: the bench protocol (pfilter_tpu_torch.bench.run_bench --reference %s --states %s): %d ES frames, then %d BPF, "
          "then %d windows" % (REFERENCE.relative_to(root), STATES.relative_to(root), p["frames"], p["bpf_frames"], len(parity.WINDOW_LENGTHS)))
    args = bench.parse_args(["--reference", str(REFERENCE), "--states", str(STATES)])
    cap = kitti_config().capacity
    t0 = time.perf_counter()
    r, detail = bench.run_bench(args, kitti_config(), frames, gt, t0, render_s)
    log("  " + json.dumps(r))
    n_es, n_bpf = p["frames"], p["bpf_frames"]
    log(f"  ES: {r['frames']} frames, protocol ms/frame {r['mean_ms_per_frame']:.2f} over {r['frames'] - p['warmup']} frames, replayed "
        f"{r['replayed_ms_per_frame']['es']:.2f} over {r['replays']['es']}; drift v1 {r['drift_t_pct']:.4f} %, full "
        f"{r['drift_t_pct_full_protocol']:.4f} %, ATE {r['ate_rmse_m']:.4f} m; overflow {r['overflow_total']}")
    log(f"  ES maps: edge peak {r['edge_map_peak']} of {cap.edge_map_points}, surf peak {r['surf_map_peak']} of {cap.surf_map_points} "
        f"(frame 0's seed), after frame 0 {r['map_peaks_after_seed']}; last {r['edge_map_size']}, {r['surf_map_size']}")
    log(f"  BPF: {r['bpf_frames']} frames, protocol ms/frame {1e3 / r['bpf_fps']:.2f}, replayed {r['replayed_ms_per_frame']['bpf']:.2f} "
        f"over {r['replays']['bpf']}; drift v1 {r['bpf_drift_t_pct']:.4f} %; overflow {r['bpf_overflow_total']}; maps (beam, pillar, "
        f"facade) last {r['bpf_map_sizes']}, peaks {r['bpf_map_peaks']} of {[cap.bpf_line_map_points] * 2 + [cap.bpf_plane_map_points]}")
    for name in ("es", "bpf"):
        res = detail["parity"][name]
        log("  " + parity.summary_long(name, res))
        log(f"  {name} gap every 50 frames (after 50, 100, ...), cm: " + " ".join(f"{g * 100:.2f}" for g in res["gap_t_m"][49::50]))
        log(f"  {name} gap every 50 frames, mrad: " + " ".join(f"{g * 1e3:.3f}" for g in res["gap_rad"][49::50]))
    windows = r["reference"]["windows"]
    for name, w in windows.items():
        res = detail["windows"][name]
        log(f"  window {name}: gap per frame, cm: " + " ".join(f"{g * 100:.2f}" for g in res["all"]["gap_t_m"]))
        per = bench.KNN_PER_FRAME[w["path"]] * w["frames"]
        check(w["kernel_launches"] == {"knn_tiled": per, "pca_radius": 0, "work_list": per} and w["captures"] == 1 and w["replays"] == w["frames"] - 1,
              f"window {name}: launches {w['kernel_launches']}, captures {w['captures']}, replays {w['replays']}")
        launches[f"window_{name}"] = w["kernel_launches"]
    check(sorted(windows) == sorted(parity.WINDOW_LENGTHS), f"bench protocol: windows {sorted(windows)}")
    check(not r["failures"], f"bench protocol: {r['failures']}")
    check(r["frames"] == n_es and r.get("bpf_frames") == n_bpf and not r["protocol_deviation"],
          f"bench protocol: {r['frames']} ES and {r.get('bpf_frames')} BPF frames, deviation {r['protocol_deviation']}")
    check(r["overflow_total"] == 0 and r["bpf_overflow_total"] == 0, "bench protocol: overflow")
    check(r["captures"] == {"es": 1, "bpf": 1} and r["replays"] == {"es": n_es - WARMUP, "bpf": n_bpf - WARMUP},
          f"bench protocol: captures {r['captures']}, replays {r['replays']}")
    want = {"es": 2 * (n_es - 1), "bpf": 3 * (n_bpf - 1)}
    check(r["knn_launches"] == want, f"bench protocol: kNN launches {r['knn_launches']} != {want}")
    for name in ("es", "bpf"):
        c = r["kernel_launches"][name]
        log(f"  bench_{name}: launches read around the path {c}")
        check(c == {"knn_tiled": want[name], "pca_radius": 0, "work_list": want[name]},
              f"bench protocol: {name} launches {c}, not {want[name]} kNN, 0 PCA, one work list per kNN and PCA launch")
        launches[f"bench_{name}"] = c
    check(min(r["n_segments"], r["full_protocol_n_segments"]) > 0 and max(r["drift_t_pct"], r["drift_t_pct_full_protocol"], r["bpf_drift_t_pct"]) < DRIFT_BAR,
          f"bench protocol: drift {r['drift_t_pct']} / {r['drift_t_pct_full_protocol']} / {r['bpf_drift_t_pct']} not below {DRIFT_BAR}")
    for name, ref, ph in (("es", es, 3), ("bpf", bpf, 8)):
        run = detail["records"][name]
        n = len(ref["t"])
        same = np.array_equal(run["q"][:n], ref["q"]) and np.array_equal(run["t"][:n], ref["t"])
        log(f"  {name}: frames 0-{n - 1} bit for bit phase {ph}'s: {same}")
        check(same, f"bench protocol: {name} frames 0-{n - 1} differ from phase {ph}'s")
    log(f"  phase 27 wall {time.perf_counter() - t0:.1f} s")


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
    from pfilter_tpu_torch import bench
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
    smi = bench.device_line(dev)
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
    # The bench protocol's 850 scans, rendered once: every path runs a prefix
    # of the same loop (the first FRAMES poses are the FRAMES-frame loop's).
    n_render = bench.PROTOCOL["frames"]
    poses = synthetic.make_loop_trajectory(n_render, speed=SPEED)
    short = synthetic.make_loop_trajectory(FRAMES, speed=SPEED)
    same = np.array_equal(np.asarray(poses.q)[:FRAMES], np.asarray(short.q)) and np.array_equal(np.asarray(poses.t)[:FRAMES], np.asarray(short.t))
    log(f"  make_loop_trajectory({n_render})'s first {FRAMES} poses equal make_loop_trajectory({FRAMES})'s: {same}")
    check(same, f"the {n_render}-frame loop does not start with the {FRAMES}-frame loop")
    t0 = time.perf_counter()
    frames = render_all(cfg, world, poses, synthetic, dev)
    render_s = time.perf_counter() - t0
    log(f"  rendered {n_render} scans on the card in {render_s:.1f} s")
    gt = bench.ground_truth(poses)
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
    plain_knn_rerun(knn, lambda: make_pipeline(cfg, sync=True, graphs=False), frames, es, "es")

    phase("phase 6: kNN times (device: CUDA graph of %d calls; call: CUDA events)" % REPEATS)
    per_shape = time_knn(knn, inputs, "es")

    phase("phase 7: where an ES frame's time goes (torch.profiler: frame %d eager and replayed)" % WARMUP)
    gmap = GlobalMap(resolution=cfg.odometry.map_resolution, device=dev)

    def map_update(pipe, scan):
        rec = pipe.records[-1]  # the newest fetched pose: host data
        sub = scan[:: max(1, len(scan) // 30000)]
        gmap.update(rec.pose_q, rec.pose_t, sub, np.ones(len(sub), bool))

    profiles = {}
    profiles["es"] = profile_steady_frames(
        lambda graphs: make_pipeline(cfg, sync=False, fetch_lag=4, graphs=graphs),
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
    plain_knn_rerun(knn, lambda: make_pipeline(cfg_bpf, sync=True, graphs=False), frames, bpf, "bpf")

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
    widest = [int(knn._halo_ranges(tiled_cloud(knn, x, nonground_cloud(cfg_rad, x, v), nt, tc, tcap), nt, 2**31 - 1)[1].max()) for x, v in frames[:FRAMES]]
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
        plain = make_pipeline(cfg_rad, sync=True, graphs=False)
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

    phase("phase 16: where a radius-BPF frame's time goes (torch.profiler: frame %d eager and replayed)" % WARMUP)
    profiles["bpf_radius"] = profile_steady_frames(
        lambda graphs: make_pipeline(cfg_rad, sync=False, fetch_lag=4, graphs=graphs),
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
    option_err, option_runs = option_phases(cfg, frames, gt, phase, zero_counts, read_counts, launches)
    knn_err = max(knn_err, option_err)
    sharded, sharded_poses, sharded_records = sharded_phases(cfg, cfg_bpf, frames, gt, es, bpf, phase, zero_counts, read_counts, launches)
    replay = eager_phase((("es", cfg, es), ("bpf_voxel", cfg_bpf, bpf), ("bpf_radius", cfg_rad, rad)), frames, phase)
    sharded_eager_phase(cfg, cfg_bpf, frames, es, bpf, sharded, sharded_poses, phase)
    parity_runs = {"es": es["records"], "bpf": bpf["records"], "bpf_radius": rad["records"]}
    parity_runs.update({name: r["records"] for name, r in option_runs.items()})
    parity_runs.update({"es_sharded_m1": sharded_records["es"], "bpf_sharded_m1": sharded_records["bpf"]})
    parity_phase(parity_runs, gt, phase, cfg_bpf, frames)
    bench_phase(frames, gt, render_s, es, bpf, phase, launches)
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
                "per_path_frame": knn_tot,
                "per_frame_shapes": per_shape,
                "sharded": sharded,
                "replayed_frame_ms": {k: v["knn_in_replay"][0] for k, v in replay.items()},
                "replayed_frame_launches": {k: v["knn_in_replay"][1] for k, v in replay.items()},
                "replay": replay,
                "profiles": {k: {g: {f: v[f] for f in ("wall_ms", "busy_ms", "busy_pct", "kernels", "launch_calls", "graph_launches", "stages")} for g, v in p.items()} for k, p in profiles.items()},
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
                "replayed_frame_ms": replay["bpf_radius"]["pca_in_replay"][0],
                "replayed_frame_launches": replay["bpf_radius"]["pca_in_replay"][1],
            },
            {
                "name": "work_list",
                "route": "cuda",
                "source": "pfilter_tpu_torch/csrc/work_list.cu",
                # No kernel of its own on the TPU: the work items of both
                # kernels, in place of the Pallas grid's walk over the query
                # tiles with their scalar-prefetched ranges.
                "replaces": "pfilter_tpu/ops/knn_tiled.py:405",
                "launches": launches["es"]["work_list"],
                "max_abs_err": WORK_LIST_ERR[0],
                "ms": knn_tot["es"]["work_list_device_ms"],
                "plain_ms": knn_tot["es"]["work_list_plain_ms"],
                "bound_ms": knn_tot["es"]["work_list_bound_ms"],
                "bound_by": "bytes",
                "library_ms": None,
                "launches_by_path": {k: v["work_list"] for k, v in launches.items()},
                "replayed_frame_ms": {k: v["work_list_in_replay"][0] for k, v in replay.items()},
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
