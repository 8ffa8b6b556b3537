#!/usr/bin/env python3
"""DCVC's azimuth ``atan2`` on the card: ``dcvc.atan2_f32`` (the reference's
XLA CPU ``atan2``, written in float32 elementwise operations) against the
card's own ``torch.atan2``, in the BPF paths' parity with the reference and
in device time.

    python3 tools/torch_dcvc_atan2_ab.py [--out FILE.json]

Needs one CUDA card and nvcc.  Renders the v1 protocol's shared scans on the
card (``chip_smoke.render_all``) and, for each ``atan2`` in turn (set as
``dcvc.atan2_f32``, the function ``dcvc.cluster`` bins azimuths with), runs the
three single-device paths that cluster with DCVC (default BPF, radius BPF,
BPF per-iteration with the fast ground filter) as ``chip_smoke.py`` does,
replayed from a CUDA graph, and holds each to the reference package's
stored run of the path with ``utils/parity.py``'s gates
(``chip_smoke.REFERENCE``).  The map-sharded BPF path at ``n_map = 1``
equals default BPF bit for bit (``chip_smoke.py`` phase 23) and is not run.
Then, on frames 0, 33 and 99: both ``atan2`` against ``atan2_f32`` on the
CPU (rays differing) and DCVC's labels on the card against the CPU's.
Last, each ``atan2`` and the whole ``dcvc.cluster`` timed on the card at the
shapes the paths give DCVC (``chip_smoke.graph_ms``: a CUDA graph of
``chip_smoke.REPEATS`` calls, the card alone), in turns f32, card, card,
f32, and each one's kernels counted under ``torch.profiler``.  Prints one
line per result and a JSON summary last; ``--out`` also writes the whole
record (per-frame gaps included) as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PATH_FRAMES = {"bpf": 100, "bpf_radius": 60, "bpf_per_iteration_fast": 100}  # the reference holds 60 radius frames
CHECK_FRAMES = (0, 33, 99)


def kernels_per_call(fn) -> int:
    """CUDA kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the whole record to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dcvc_atan2_ab: no CUDA device available", file=sys.stderr)
        return 2
    from pfilter_tpu_torch.config import apply_dotted_overrides, kitti_config
    from pfilter_tpu_torch.ops import _build, dcvc, ground
    from pfilter_tpu_torch.pipeline import make_pipeline
    from pfilter_tpu_torch.utils import metrics, parity, synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs.log(f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.load()
    dev = torch.device("cuda")
    cfg = kitti_config()
    cfg_bpf = cfg.replace(mode="bpf")
    configs = {
        "bpf": cfg_bpf,
        "bpf_radius": apply_dotted_overrides(cfg_bpf, cs.RADIUS_OVERRIDES),
        "bpf_per_iteration_fast": cfg_bpf.replace(
            odometry=dataclasses.replace(cfg.odometry, assoc_once=False), ground=dataclasses.replace(cfg.ground, method="fast")
        ),
    }
    n_frames = max(PATH_FRAMES.values())
    poses = synthetic.make_loop_trajectory(n_frames, speed=cs.SPEED)
    frames = cs.render_all(cfg, synthetic.make_city_world(seed=7), poses, synthetic, dev)
    gt = metrics.poses_to_matrices(np.asarray(poses.q), np.asarray(poses.t))
    gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    ref, side = parity.load_reference(cs.REFERENCE)
    f32 = dcvc.atan2_f32
    variants = {"atan2_f32": f32, "torch.atan2": torch.atan2}
    record = {"nvidia_smi": smi, "paths": {}, "rays": {}, "times": {}}
    n = parity.SCORE_AT
    try:
        for vname, fn in variants.items():
            dcvc.atan2_f32 = fn
            for name, c in configs.items():
                cs.log(f"== {name} with {vname} ({PATH_FRAMES[name]} frames, replayed)")
                r = cs.run_protocol(make_pipeline(c, sync=False, fetch_lag=4), frames, gt, metrics, PATH_FRAMES[name])
                run = r["records"]
                scored = min(len(run["t"]), len(ref[name]["t"])) >= n
                drift = metrics.kitti_drift(gt[:n], metrics.poses_to_matrices(run["q"][:n], run["t"][:n]), lengths=cs.LENGTHS, step=10)["t_err_pct"] if scored else None
                ref_drift = side["paths"][name]["scores"][str(n)]["drift_t_pct"] if scored else None
                res = parity.compare(run, ref[name], drift, ref_drift)
                cs.log("  " + parity.summary(name, res))
                record["paths"].setdefault(name, {})[vname] = {
                    **{f: v for f, v in res.items() if f not in ("gap_t_m", "gap_rad")},
                    "gap_t_m_per_frame": res["gap_t_m"].tolist(),
                    "ms_per_frame": r["ms"],
                    "replays": r["replays"],
                }
            for i in CHECK_FRAMES:
                xyz, valid = frames[i]
                v = valid.cpu()
                host = f32(xyz[:, 1].cpu(), xyz[:, 0].cpu())
                card = fn(xyz[:, 1], xyz[:, 0]).cpu()
                rays = int((card.view(torch.int32) != host.view(torch.int32))[v].sum())
                ng = ground.segment_ground_dispatch(xyz, valid, cfg_bpf).nonground_mask
                lc = dcvc.cluster(xyz, ng, cfg_bpf.dcvc, cfg_bpf.lidar)
                dcvc.atan2_f32 = f32  # the CPU's side: the reference's atan2
                lh = dcvc.cluster(xyz.cpu(), ng.cpu(), cfg_bpf.dcvc, cfg_bpf.lidar)
                dcvc.atan2_f32 = fn
                out = dict(valid=int(v.sum()), rays_differing=rays, nonground=int(ng.sum()),
                           labels_differing=int((lc.label.cpu() != lh.label).sum()), keep_differing=int((lc.keep.cpu() != lh.keep).sum()))
                record["rays"].setdefault(vname, {})[i] = out
                cs.log(f"  frame {i}, {vname} on the card against atan2_f32 on the CPU: {out}")
        # Device times at DCVC's input shapes: the voxel front-end clusters
        # its compacted cloud (scan_points // 2), the radius one the scan.
        xyz, valid = frames[0]
        ng = ground.segment_ground_dispatch(xyz, valid, cfg_bpf).nonground_mask
        for label, k in (("voxel front-end", cfg.capacity.scan_points // 2), ("radius front-end", cfg.capacity.scan_points)):
            x, y, m = xyz[:k, 0].contiguous(), xyz[:k, 1].contiguous(), ng[:k]
            pts = xyz[:k].contiguous()
            t = {}
            for vname in ("atan2_f32", "torch.atan2", "torch.atan2", "atan2_f32"):
                fn = variants[vname]
                t.setdefault(vname, []).append(cs.graph_ms(lambda: fn(y, x)))
                dcvc.atan2_f32 = fn
                t.setdefault(f"cluster with {vname}", []).append(cs.graph_ms(lambda: dcvc.cluster(pts, m, cfg_bpf.dcvc, cfg_bpf.lidar)))
            for vname, fn in variants.items():
                t[f"{vname} kernels"] = kernels_per_call(lambda: fn(y, x))
                dcvc.atan2_f32 = fn
                t[f"cluster with {vname} kernels"] = kernels_per_call(lambda: dcvc.cluster(pts, m, cfg_bpf.dcvc, cfg_bpf.lidar))
            record["times"][f"{label} ({k} points)"] = t
            cs.log(f"  device ms per call, {label} ({k} points; CUDA graph of {cs.REPEATS} calls, in turns f32, card, card, f32): {t}")
    finally:
        dcvc.atan2_f32 = f32
    failed = {name: {v: r["failures"] for v, r in by.items() if r["failures"]} for name, by in record["paths"].items()}
    record["failures"] = {k: v for k, v in failed.items() if v}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1, default=float))
    print(json.dumps({k: v for k, v in record.items() if k != "paths"} | {
        "gates": {name: {v: ("held" if not r["failures"] else r["failures"]) for v, r in by.items()} for name, by in record["paths"].items()},
        "max_gap_cm": {name: {v: r["max_gap_t_m"] * 100 for v, r in by.items()} for name, by in record["paths"].items()},
        "map_size_rel": {name: {v: r["map_size_rel"] for v, r in by.items()} for name, by in record["paths"].items()},
    }, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
