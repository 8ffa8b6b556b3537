"""Map-sharded odometry across processes, one per cell of a seq x map grid:
the port's counterpart of ``tools/run_distributed.py``.

Every process runs this module; ``torch.distributed`` joins them (NCCL on
CUDA cards, gloo with ``--device cpu``), and the sharded step
(``pfilter_tpu_torch/parallel/``) runs each sequence row's map across its
``n_map`` ranks: kNN candidates and scan writebacks are all-gathered, the
Gauss-Newton normal equations all-reduced.

Launch on one host with several cards (``torchrun`` sets the ranks)::

  torchrun --nproc-per-node 4 -m pfilter_tpu_torch.run_distributed --n-map 4
  torchrun --nproc-per-node 4 -m pfilter_tpu_torch.run_distributed --n-seq 2 --n-map 2 --mode bpf

or give each process its place yourself::

  python -m pfilter_tpu_torch.run_distributed --device cpu --rank 0 --world-size 2 \\
      --init-method file:///tmp/pg --preset small --frames 2

Without ``--jobs`` it renders each row's scans (``--preset kitti``: the
city world and loop of the v1 protocol at ``kitti_config()``; ``small``: a
16-beam corridor), runs ``--frames`` frames, and rank 0 prints one JSON line
(``distributed``, ``processes``, ``n_seq``, ``n_map``, each row's final
pose, drift, ATE and overflow, the CUDA graphs captured and the frames
replayed, and the collectives of one steady frame).  On cards the steady
frames replay a CUDA graph captured at the first frame whose outer
iterations are at their floor (frame 10 of ``kitti_config()``); ``--eager``
runs every frame eagerly (the comparison run).  Frame 0 (the seed and the
communicators) is not timed; the frames before the capture frame, the
capture frame and the frames after it are timed apart (``ms_before``,
``capture_ms``, ``ms_per_frame``; a run too short to reach a frame after
the capture times every frame after frame 0 as ``ms_per_frame``, and
``timed_frames`` says which).  ``--profile N`` then runs N more frames with
rank 0 under ``torch.profiler`` (the device's busy time over them, its
share of the unprofiled ms/frame, the kernels, the NCCL kernels' time);
``--poses-out FILE`` writes every row's poses (``q [n_seq, F, 4]``, ``t
[n_seq, F, 3]``) and ``--poses-ref FILE`` holds each row to the same row of
such a file (the gaps in m and rad per frame, and the largest and its
frame).  ``--reference FILE`` (the stored reference trajectories,
``tests/data/torch_reference_v1.npz`` in the repository) holds row 0 to the
reference package's map-sharded run at the same ``n_map`` on the same scans
(the kitti preset renders them with the reference's range noise,
``synthetic.render_shared_sequence``), with the gates of ``utils/parity.py``.

With ``--jobs FILE`` it runs file in, file out: FILE is a JSON
``{"jobs": [...]}``; each job names ``mode``, ``n_seq``, ``n_map`` (their
product the world size), ``config`` (nested dict of ``PipelineConfig``
fields), ``scans`` (an ``.npz`` with ``xyz [n_seq, F, N, 3]`` float32 and
``mask [n_seq, F, N]`` bool), optionally ``states`` (frame index -> ``.npz``
of the reference package's global sharded state as dotted leaves, from
which each rank's block is cut before that frame), ``save_states`` (frame
indices after which to save this rank's block), ``checkpoint`` (``{"frame":
i, "dir": D}``: after frame i every rank saves the run's state to the
checkpoint directory D, ``utils.checkpoint.save_sharded_state``),
``restore`` (``{"frame": i, "dir": D}``: the run starts at frame i from the
checkpoint in D, ``restore_sharded_state``), ``frames`` (the frames to run
to, default all) and ``out`` (a directory).  Each rank writes
``out/rank<r>.npz``: its row's poses and diagnostics per frame run, its
saved blocks (``state<i>.<leaf>``) and its final block (``state.<leaf>``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pfilter_tpu_torch import convert
from pfilter_tpu_torch.config import (
    CapacityConfig,
    DCVCConfig,
    LidarConfig,
    OdometryConfig,
    PipelineConfig,
    kitti_config,
)
from pfilter_tpu_torch.parallel import mesh as meshlib
from pfilter_tpu_torch.parallel.pipeline import make_sharded_pipeline
from pfilter_tpu_torch.utils import checkpoint, metrics, parity, synthetic

V1_AZIMUTH = 1800  # the v1 protocol's scans (bench.py): HDL-64 at 1800 azimuth, 0.008 m range noise


def config_from_dict(d: dict) -> PipelineConfig:
    """A ``PipelineConfig`` from the nested dict of ``dataclasses.asdict``
    (JSON lists back to tuples)."""
    base = PipelineConfig()
    kwargs = {}
    for name, value in d.items():
        ref = getattr(base, name)
        if dataclasses.is_dataclass(ref):
            value = type(ref)(**{k: tuple(v) if isinstance(v, list) else v for k, v in value.items()})
        kwargs[name] = value
    return PipelineConfig(**kwargs)


def small_config(scan_points: int, n_map: int, mode: str) -> PipelineConfig:
    """The 16-beam corridor config of ``tools/run_distributed.py`` (maps of
    8192 edge and 32768 surf points per shard), with the DCVC geometry of a
    16-beam, 512-azimuth scan so that BPF finds pillars."""
    return PipelineConfig(
        mode=mode,
        lidar=LidarConfig(num_lines=16, min_distance=1.0, max_distance=60.0),
        dcvc=DCVCConfig(delta_p=2.5, min_seg=25),
        odometry=OdometryConfig(map_resolution=0.4, max_outer_iters=4),
        capacity=CapacityConfig(
            scan_points=scan_points,
            ring_points=512,
            edge_points=1024,
            surf_points=scan_points,
            ds_edge_points=1024,
            ds_surf_points=4096,
            edge_map_points=8192 * n_map,
            surf_map_points=32768 * n_map,
        ),
    )


def init_process_group(args) -> None:
    """The default group: NCCL on CUDA, gloo on the CPU; the place from the
    flags, else from ``torchrun``'s environment."""
    if args.device != "cpu":
        local = int(os.environ.get("LOCAL_RANK", args.rank or 0))
        torch.cuda.set_device(local % max(torch.cuda.device_count(), 1))
    backend = "gloo" if args.device == "cpu" else "nccl"
    if args.init_method is not None:
        dist.init_process_group(backend, init_method=args.init_method, rank=args.rank, world_size=args.world_size)
    else:
        dist.init_process_group(backend, init_method="env://")


def _device_arg(args):
    return "cpu" if args.device == "cpu" else None


def render_rows(args, cfg, mesh, n_frames: int):
    """This rank's row's scans, rendered on its device and padded to
    ``scan_points`` (each row its own world: the seed offset by the row),
    and the row's ground-truth poses as 4x4 matrices relative to frame 0.
    The kitti preset's scans carry the range noise of the reference's
    stored trajectories (``synthetic.render_shared_sequence``), so that row
    0 can be held to them (``--poses-ref``)."""
    dev = mesh.device
    if args.preset == "kitti":
        world = synthetic.make_city_world(seed=7 + mesh.seq_index)
        poses = synthetic.make_loop_trajectory(n_frames, speed=1.5)
        xyz, valid = synthetic.render_shared_sequence(world, poses, cfg.lidar, V1_AZIMUTH, device=dev)
    else:
        world = synthetic.make_world(seed=3 + mesh.seq_index, corridor_len=50.0)
        poses = synthetic.make_trajectory(n_frames, speed=0.5)
        xyz, valid = synthetic.render_sequence(world, poses, cfg.lidar, 512, noise=0.005, device=dev)
    cap = cfg.capacity.scan_points
    n = min(xyz.shape[1], cap)
    x = torch.zeros((n_frames, cap, 3), dtype=torch.float32, device=dev)
    v = torch.zeros((n_frames, cap), dtype=torch.bool, device=dev)
    x[:, :n], v[:, :n] = xyz[:, :n], valid[:, :n]
    gt = metrics.poses_to_matrices(np.asarray(poses.q), np.asarray(poses.t))
    return x, v, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)


def _score(q, t, gt) -> list:
    """Drift (%, v1 protocol: 100, 200, 300 m segments that fit the path,
    every 10 frames; nan when none fits) and ATE (m) of a row's poses."""
    path = metrics.trajectory_distances(gt)[-1]
    est = metrics.poses_to_matrices(q, t)
    lengths = tuple(length for length in (100.0, 200.0, 300.0) if length <= path)
    drift = metrics.kitti_drift(gt, est, lengths=lengths, step=10)["t_err_pct"] if lengths else float("nan")
    return [drift, metrics.ate_rmse(gt, est)]


def capture_frame(cfg) -> int:
    """The first frame whose outer iterations are at their floor: the frame a
    pipeline captures on a card (frame 0 seeds at ``max_outer_iters``, each
    later frame runs one fewer, down to ``min_outer_iters``)."""
    o = cfg.odometry
    return max(1, o.max_outer_iters - o.min_outer_iters)


def _timed(pipe, xyz, valid, start: int, stop: int, cuda: bool, device) -> float:
    """Dispatch frames start..stop-1, drain the lagged fetches and wait for
    the card: seconds."""
    t0 = time.perf_counter()
    for i in range(start, stop):
        pipe.process_frame(xyz[i], valid[i])
    pipe.flush()
    if cuda:
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _profile(pipe, xyz, valid, start: int, stop: int, device) -> dict:
    """Frames start..stop-1 under ``torch.profiler`` (CPU and CUDA
    activities): the device's busy time (every kernel and copy on the card;
    the device rows of annotated ranges, such as ``nccl:all_reduce``, are
    spans, not work), the kernels, and the NCCL kernels' time and count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _timed(pipe, xyz, valid, start, stop, True, device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    nccl = [e for e in events if e.key.startswith("nccl") and not e.key.startswith("nccl:")]
    n = stop - start
    return dict(
        frames=n,
        wall_ms_profiled=wall_ms,
        busy_ms_per_frame=sum(e.self_device_time_total for e in events) / 1e3 / n,
        kernels_per_frame=sum(e.count for e in events) / n,
        nccl_ms_per_frame=sum(e.self_device_time_total for e in nccl) / 1e3 / n,
        nccl_kernels_per_frame=sum(e.count for e in nccl) / n,
        nccl_names=sorted({e.key[:60] for e in nccl}),
    )


def _gaps(rows, refs) -> dict:
    """Per-frame and largest gaps of each row's poses to its reference
    poses (``rows``, ``refs``: lists of ``(q, t)``)."""
    gaps = [parity.pose_gaps(q, t, rq, rt) for (q, t), (rq, rt) in zip(rows, refs)]
    return dict(
        gap_t_m=[float(g[0].max()) for g in gaps],
        gap_t_frame=[int(g[0].argmax()) for g in gaps],
        gap_rad=[float(g[1].max()) for g in gaps],
        gap_rad_frame=[int(g[1].argmax()) for g in gaps],
        gap_t_m_per_frame=[g[0].tolist() for g in gaps],
        gap_rad_per_frame=[g[1].tolist() for g in gaps],
    )


def hold_to_poses(path, rq, rt) -> dict:
    """``--poses-ref``: each row's poses (``rq [n_seq, F, 4]``, ``rt``)
    against the same row of a ``--poses-out`` file."""
    with np.load(path) as z:
        refs = [(z["q"][s], z["t"][s]) for s in range(min(len(rq), z["q"].shape[0]))]
    return {"poses_ref": str(path), **_gaps(list(zip(rq, rt)), refs)}


def hold_to_reference(path, mode: str, n_map: int, rq, rt, records, gt) -> dict:
    """``--reference``: row 0's poses (``rq [n_seq, F, 4]``, ``rt``) against
    the reference package's map-sharded run of ``mode`` at this ``n_map`` in
    the stored trajectories ``path``, per frame, held to the gates of
    ``parity.compare`` with row 0's ``records`` (overflow, map sizes) and
    drift at ``parity.SCORE_AT`` frames against ``gt``."""
    runs, side = parity.load_reference(path)
    name = f"{mode}_sharded_m{n_map}"
    ref = runs[name]
    scored = min(rt.shape[1], ref["t"].shape[0]) >= parity.SCORE_AT
    drift = _score(rq[0][: parity.SCORE_AT], rt[0][: parity.SCORE_AT], gt[: parity.SCORE_AT])[0] if scored else None
    ref_drift = side["paths"][name]["scores"][str(parity.SCORE_AT)]["drift_t_pct"] if scored else None
    res = parity.compare(parity.records_arrays(records[: rt.shape[1]]), ref, drift, ref_drift)
    return {
        "reference": str(path),
        "reference_path": name,
        "parity": {f: v for f, v in res.items() if f not in ("gap_t_m", "gap_rad")},
        "parity_summary": parity.summary(name, res),
        "reference_gap_t_m_per_frame": res["gap_t_m"].tolist(),
        "reference_gap_rad_per_frame": res["gap_rad"].tolist(),
    }


def run_rendered(args) -> None:
    world = dist.get_world_size()
    n_map = args.n_map or world // args.n_seq
    mesh = meshlib.make_mesh(args.n_seq, n_map, device=_device_arg(args))
    if args.preset == "kitti":
        cfg = kitti_config().replace(mode=args.mode)
    else:
        cfg = small_config(args.scan_points, n_map, args.mode)
    n = args.frames
    xyz, valid, gt = render_rows(args, cfg, mesh, n + args.profile)
    gt = gt[:n]
    cuda = mesh.device.type == "cuda"
    if cuda:
        from pfilter_tpu_torch.ops import _build

        _build.load()  # the kernels, before any frame is timed
    elif args.profile:
        raise ValueError("--profile needs CUDA cards")
    pipe = make_sharded_pipeline(cfg, mesh, sync=False, fetch_lag=4, graphs=False if args.eager else None)
    c = capture_frame(cfg)
    # Frame 0 builds the communicators and seeds the maps: not timed.
    _timed(pipe, xyz, valid, 0, 1, cuda, mesh.device)
    windows = {"before": (1, min(c, n)), "capture": (min(c, n), min(c + 1, n)), "steady": (min(c + 1, n), n)}
    seconds, collectives = {}, {}
    for name, (start, stop) in windows.items():
        before = dict(mesh.counts)
        seconds[name] = _timed(pipe, xyz, valid, start, stop, cuda, mesh.device)
        collectives[name] = {k: mesh.counts[k] - before[k] for k in before}
    start, stop = windows["steady"] if n > c + 1 else (1, n)
    timed_s = seconds["steady"] if n > c + 1 else sum(seconds.values())
    ms_per_frame = timed_s / max(stop - start, 1) * 1e3
    prof = _profile(pipe, xyz, valid, n, n + args.profile, mesh.device) if args.profile else None
    if prof is not None:
        prof["busy_share_pct"] = prof["busy_ms_per_frame"] / ms_per_frame * 100  # of the unprofiled ms/frame
    q, t = (a[:n] for a in pipe.trajectory)
    # Every row's poses, drift, ATE and overflow for rank 0 (outside the
    # step's collectives).
    mine = np.concatenate([q.ravel(), t.ravel(), _score(q, t, gt), [pipe.overflow_total]]).astype(np.float64)
    every = [torch.empty(mine.shape, dtype=torch.float64, device=mesh.device) for _ in range(world)]
    dist.all_gather(every, torch.from_numpy(mine).to(mesh.device))
    if dist.get_rank() != 0:
        return
    rows = [every[s * n_map].cpu().numpy() for s in range(args.n_seq)]
    rq = np.stack([r[: 4 * n].reshape(n, 4) for r in rows])
    rt = np.stack([r[4 * n : 7 * n].reshape(n, 3) for r in rows])
    if not (np.isfinite(rq).all() and np.isfinite(rt).all()):
        raise RuntimeError("non-finite poses")
    steady_frames = max(windows["steady"][1] - windows["steady"][0], 0)
    result = {
        "distributed": "ok",
        "processes": world,
        "backend": mesh.backend,
        "device": torch.cuda.get_device_name(mesh.device) if cuda else "cpu",
        "n_seq": args.n_seq,
        "n_map": n_map,
        "mode": args.mode,
        "preset": args.preset,
        "frames": n,
        "graphs": bool(pipe.graphs),
        "ms_per_frame": ms_per_frame,
        "timed_frames": [start, stop],
        "ms_before": seconds["before"] / max(windows["before"][1] - windows["before"][0], 1) * 1e3,
        "capture_frame": c,
        "capture_ms": seconds["capture"] * 1e3,
        "captures": len(pipe.captures),
        "replays": pipe.replays,
        "collectives_per_steady_frame": {k: v / steady_frames for k, v in collectives["steady"].items()} if steady_frames else None,
        "final_pose_q": [r[-1].tolist() for r in rq],
        "final_pose_t": [r[-1].tolist() for r in rt],
        "drift_t_pct": [float(r[7 * n]) for r in rows],
        "ate_rmse_m": [float(r[7 * n + 1]) for r in rows],
        "overflow_total": [int(r[7 * n + 2]) for r in rows],
        "collectives_rank0": dict(mesh.counts),
        "profile_rank0": prof,
    }
    if args.poses_out:
        np.savez(args.poses_out, q=rq, t=rt)
    if args.poses_ref:
        result.update(hold_to_poses(args.poses_ref, rq, rt))
    if args.reference:
        result.update(hold_to_reference(args.reference, args.mode, n_map, rq, rt, pipe.records, gt))
    print(json.dumps(result), flush=True)


def _records_arrays(records) -> dict:
    """Per-frame arrays of an ES or BPF pipeline's records:
    ``parity.records_arrays``, its poses as ``pose_q`` / ``pose_t`` and its
    overflow lanes in their own shape."""
    out = parity.records_arrays(records)
    out["pose_q"], out["pose_t"] = out.pop("q"), out.pop("t")
    out["overflow"] = np.stack([r.overflow for r in records])
    return out


def _block_leaves(state, prefix: str) -> dict:
    return {f"{prefix}.{k}": v for k, v in convert.flatten_leaves(convert.to_numpy(state)).items()}


def run_job(job: dict, device, graphs=None) -> None:
    """One file-in, file-out job (see the module docstring)."""
    cfg = config_from_dict(job["config"]).replace(mode=job["mode"])
    mesh = meshlib.make_mesh(job["n_seq"], job["n_map"], device=device)
    with np.load(job["scans"]) as z:
        xyz, mask = z["xyz"][mesh.seq_index], z["mask"][mesh.seq_index]
    states = {int(k): v for k, v in job.get("states", {}).items()}
    save = set(job.get("save_states", []))
    ckpt, restore = job.get("checkpoint"), job.get("restore")
    pipe = make_sharded_pipeline(cfg, mesh, sync=True, graphs=graphs)
    start = 0
    if restore is not None:
        start = restore["frame"]
        pipe.state, _ = checkpoint.restore_sharded_state(restore["dir"], cfg, mesh)
    saved = {}
    for i in range(start, job.get("frames", xyz.shape[0])):
        if i in states:
            with np.load(states[i]) as z:
                tree = convert.nest_leaves(dict(z))
            pipe.state = convert.sharded_state_from_jax_numpy(tree, cfg, mesh.seq_index, mesh.map_index, mesh.n_map, mesh.device)
        pipe.process_frame(torch.from_numpy(xyz[i]).to(mesh.device), torch.from_numpy(mask[i]).to(mesh.device))
        if i in save:
            saved.update(_block_leaves(pipe.state, f"state{i}"))
        if ckpt is not None and i == ckpt["frame"]:
            checkpoint.save_sharded_state(ckpt["dir"], pipe.state, mesh, step=i + 1, extra={"mode": cfg.mode})
    out = Path(job["out"])
    out.mkdir(parents=True, exist_ok=True)
    arrays = _records_arrays(pipe.records)
    arrays.update(saved)
    arrays.update(_block_leaves(pipe.state, "state"))
    arrays["collectives"] = np.array([mesh.counts["all_gather"], mesh.counts["all_reduce"]])
    np.savez(out / f"rank{dist.get_rank()}.npz", **arrays)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help="cuda (NCCL) unless cpu (gloo)")
    ap.add_argument("--rank", type=int, default=None, help="with --init-method; else torchrun's RANK")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--init-method", default=None, help="e.g. tcp://host:port or file:///path; else env://")
    ap.add_argument("--n-seq", type=int, default=1)
    ap.add_argument("--n-map", type=int, default=0, help="map shards per row (0: world size / n_seq)")
    ap.add_argument("--mode", default="es", choices=("es", "bpf"))
    ap.add_argument("--preset", default="kitti", choices=("kitti", "small"))
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--scan-points", type=int, default=8192, help="--preset small only")
    ap.add_argument("--jobs", default=None, help="file-in, file-out mode: a JSON list of jobs")
    ap.add_argument("--eager", action="store_true", help="run every frame eagerly (graphs=False), the comparison run")
    ap.add_argument("--profile", type=int, default=0, help="then profile this many more frames on rank 0 (cards only)")
    ap.add_argument("--poses-out", default=None, help="write every row's poses to this .npz (rank 0)")
    ap.add_argument("--poses-ref", default=None, help="hold each row's poses to the same row of this --poses-out .npz")
    ap.add_argument(
        "--reference", default=None,
        help="hold row 0 to the reference's sharded run at this n_map in these stored trajectories "
        "(tests/data/torch_reference_v1.npz; --preset kitti)",
    )
    args = ap.parse_args(argv)
    if args.reference is not None and args.preset != "kitti":
        ap.error("--reference holds the kitti preset's scans")
    if args.init_method is not None and (args.rank is None or args.world_size is None):
        ap.error("--init-method needs --rank and --world-size")

    init_process_group(args)
    try:
        if args.jobs is None:
            run_rendered(args)
        else:
            jobs = json.loads(Path(args.jobs).read_text())["jobs"]
            for job in jobs:
                run_job(job, _device_arg(args), graphs=False if args.eager else None)
            if dist.get_rank() == 0:
                print(json.dumps({"distributed": "ok", "processes": dist.get_world_size(), "jobs": len(jobs)}), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
