"""KITTI sequence runner and parameter sweep — port of ``tools/run_kitti.py``
(the in-repo replacement for the reference's ``runkitti.py`` and external
evaluation tool, ref: runkitti.py:86-213).  Runs the ES or BPF pipeline over
a KITTI odometry sequence (or a synthetic corridor), writes the KITTI-format
trajectory ``{tag}.txt`` and per-frame JSONL ``{tag}_frames.jsonl``,
optionally the global map ``{tag}_map.npz`` / ``{tag}_map.ply``, and scores
drift in-process.  Runs on the CUDA device unless ``--device cpu`` is given.

Examples:
  python -m pfilter_tpu_torch.run_kitti --root /data/kitti --sequence 07
  python -m pfilter_tpu_torch.run_kitti --root /data/kitti --sequence 07 --global-map
  python -m pfilter_tpu_torch.run_kitti --root /data/kitti --sequence 00 --mode bpf \\
      --set odometry.theta_p=0.4 --set odometry.k_new=0
  python -m pfilter_tpu_torch.run_kitti --synthetic --frames 100      # no dataset
  python -m pfilter_tpu_torch.run_kitti --root /data/kitti --sweep theta_p=0.2,0.4,0.6
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

from pfilter_tpu_torch.config import load_config
from pfilter_tpu_torch.models.global_map import GlobalMap
from pfilter_tpu_torch.pipeline import make_pipeline
from pfilter_tpu_torch.utils import checkpoint, metrics


def run_sequence(cfg, scans, gt_mats, out_dir: Path, tag: str, global_map_stride: int = 0, device=None) -> dict:
    """Run ``cfg``'s pipeline over ``scans`` ([N,3+] numpy arrays) on
    ``device``, write the trajectory, the per-frame records and (with
    ``global_map_stride`` > 0) the global map of every stride-th frame into
    ``out_dir``, and return the result record; drift and ATE where
    ``gt_mats`` covers the frames."""
    pipe = make_pipeline(cfg, device=device)
    gm = GlobalMap(resolution=cfg.odometry.map_resolution, device=pipe.device) if global_map_stride > 0 else None

    t0 = time.perf_counter()
    n = 0
    for scan in scans:
        xyz = scan[:, :3] if scan.shape[1] >= 4 else scan
        xyz = np.ascontiguousarray(xyz, np.float32)
        rec = pipe.process_frame(xyz)
        # Global visualization map (ref laserMappingNode, fed /odom and the
        # filtered cloud, src/laserMappingNode.cpp:51-136): the frame's
        # record pose and a strided scan, all host data.
        if gm is not None and rec is not None and n % global_map_stride == 0:
            sub = xyz[:: max(1, len(xyz) // 30000)]
            gm.update(np.asarray(rec.pose_q), np.asarray(rec.pose_t), sub, np.ones(len(sub), bool))
        n += 1
    wall = time.perf_counter() - t0

    q, t = pipe.trajectory
    est = metrics.poses_to_matrices(q, t)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    metrics.save_kitti_format(out_dir / f"{tag}.txt", est)
    checkpoint.save_trajectory(out_dir / f"{tag}_frames.jsonl", pipe.records)
    if gm is not None:
        pts = gm.get_map()
        np.savez_compressed(out_dir / f"{tag}_map.npz", xyz=pts)
        _save_ply(out_dir / f"{tag}_map.ply", pts)

    ms = [r.ms for r in pipe.records[max(1, n // 10) :]]
    result = {
        "tag": tag,
        "frames": n,
        "fps": round(n / wall, 2),
        "mean_ms": round(float(np.mean(ms)), 2),
        "overflow_total": pipe.overflow_total,
        "device": torch.cuda.get_device_name(pipe.device) if pipe.device.type == "cuda" else "cpu",
    }
    if gt_mats is not None and len(gt_mats) >= n:
        gt = np.einsum("ij,njk->nik", np.linalg.inv(gt_mats[0]), gt_mats[:n])
        drift = metrics.kitti_drift(gt, est)
        result.update(
            drift_t_pct=round(drift["t_err_pct"], 4),
            drift_r_deg_per_m=round(drift["r_err_deg_per_m"], 6),
            ate_rmse_m=round(metrics.ate_rmse(gt, est), 4),
        )
    return result


def _save_ply(path: Path, pts: np.ndarray) -> None:
    """ASCII PLY (the standard viewer format for the /map artifact)."""
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\nend_header\n"
        )
        np.savetxt(f, pts, fmt="%.3f")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m pfilter_tpu_torch.run_kitti")
    ap.add_argument("--root", help="KITTI odometry root (sequences/, poses/)")
    ap.add_argument("--sequence", default="07")
    ap.add_argument("--preset", default="kitti")
    ap.add_argument("--mode", choices=("es", "bpf"), default=None)
    ap.add_argument("--config", help="YAML config overrides", default=None)
    ap.add_argument("--set", action="append", default=[], help="dotted override k=v")
    ap.add_argument("--sweep", action="append", default=[], help="param=v1,v2,... (odometry.*)")
    ap.add_argument("--out", default="runs")
    ap.add_argument("--frames", type=int, default=0, help="limit frames (0 = all)")
    ap.add_argument("--synthetic", action="store_true", help="synthetic world instead of KITTI")
    ap.add_argument(
        "--global-map",
        type=int,
        nargs="?",
        const=5,
        default=0,
        metavar="STRIDE",
        help="build the tiled global map from every STRIDE-th frame (default "
        "5 when given bare) and save {tag}_map.npz/.ply",
    )
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; never falls back to the CPU)")
    args = ap.parse_args(argv)

    base_overrides = list(args.set)
    if args.mode:
        base_overrides.append(f"mode={args.mode}")

    sweep_axes = []
    for s in args.sweep:
        name, _, vals = s.partition("=")
        if "." not in name:
            name = f"odometry.{name}"
        sweep_axes.append((name, vals.split(",")))

    def configs():
        if not sweep_axes:
            yield "run", base_overrides
            return
        for combo in itertools.product(*(v for _, v in sweep_axes)):
            ov = base_overrides + [f"{n}={v}" for (n, _), v in zip(sweep_axes, combo)]
            tag = "_".join(f"{n.split('.')[-1]}{v}" for (n, _), v in zip(sweep_axes, combo))
            yield tag, ov

    out_dir = Path(args.out)
    results = []
    for tag, overrides in configs():
        cfg = load_config(args.preset, yaml_path=args.config, cli_overrides=overrides)
        if args.synthetic:
            from pfilter_tpu_torch.utils import synthetic

            n_frames = args.frames or 60
            world = synthetic.make_world(seed=7, corridor_len=n_frames * 1.5 + 60.0)
            poses = synthetic.make_trajectory(n_frames, speed=1.5)
            xyz, valid = synthetic.render_sequence(world, poses, cfg.lidar, n_azimuth=1800, device=args.device)
            scans = (xyz[i][valid[i]].cpu().numpy() for i in range(n_frames))
            gt = metrics.poses_to_matrices(np.asarray(poses.q), np.asarray(poses.t))
        else:
            from pfilter_tpu_torch.utils import kitti

            seq = kitti.KittiSequence(args.root, args.sequence)
            gt = seq.gt_velodyne
            limit = args.frames or None
            scans = itertools.islice(seq.scans(), limit)
        res = run_sequence(cfg, scans, gt, out_dir, f"{args.sequence}_{tag}", global_map_stride=args.global_map, device=args.device)
        print(json.dumps(res), flush=True)
        results.append(res)

    if len(results) > 1:
        best = min(results, key=lambda r: r.get("drift_t_pct", r.get("ate_rmse_m", 1e9)))
        print(json.dumps({"best": best}))
    return results


if __name__ == "__main__":
    main()
