#!/usr/bin/env python3
"""Does the reference kNN's packed lane key make default ES part from the
reference?  An A/B of the port's default ES with two plain kNNs, and the
port's own sensitivity to a last-bit change.

    python3 tools/torch_knn_packed_keys_ab.py [--frames 850] [--device cuda] [--out FILE.json]
    python3 tools/torch_knn_packed_keys_ab.py --variants kernel ulp_up ulp_down [--mode bpf]
    python3 tools/torch_knn_packed_keys_ab.py --variants kernel nudge_x+ nudge_x- nudge_y+ nudge_y- nudge_z+ nudge_z-
    python3 tools/torch_knn_packed_keys_ab.py --classes 3 --device cpu

Runs the port's ES (``kitti_config()``; ``--mode bpf``: BPF, 300 frames) on
the bench protocol's shared scans (``pfilter_tpu_torch.bench.render``) once
per variant:

(a) ``plain``: every frame eagerly with ``knn_tiled.query_tiled_sorted_plain``
    as it is, exact fp32 (bit for bit the kernel: ``chip_smoke.py`` phase 5);
(b) ``packed``: every frame eagerly with the plain kNN computing what the
    reference package's Pallas kernel computes
    (``pfilter_tpu/ops/knn_tiled.py:236-300``): the squared distance as its
    augmented dot product ``[qx, qy, qz, |q|^2, 1] . [-2x, -2y, -2z, 1,
    |c|^2]`` about the query tile's centre, accumulated in that order with
    fused multiply-adds (``|q|^2`` and ``|c|^2`` too), as the XLA CPU dot
    that ran the stored reference does; the low 13 mantissa bits replaced by
    the candidate's halo lane; the top 5 by that packed key; the distance
    returned without its lane bits;
(c) ``kernel``: the CUDA kernel, steady frames replayed from a CUDA graph, as
    ``make_pipeline`` runs on the card;
(d) ``ulp_up`` / ``ulp_down``: as (c), every valid scan coordinate moved one
    float32 ulp up / down (``torch.nextafter``): how far a last-bit change
    alone carries the port's own trajectory.  This changes the scans'
    classes from frame 0 on: some 800 points a scan sit exactly on a half
    of a DCVC azimuth bin, where the last bit decides the bin, and the PCA
    classes' thresholds move hundreds of points more;
(e) ``nudge_<axis><sign>``: as (c), the scans untouched, and the pose in the
    pipeline's state moved one float32 ulp along one axis once, after frame
    NUDGE_FRAME (an eager frame): a last-bit change downstream of the
    front end, as the reference's arithmetic differs from the port's.

Each variant runs in a process of its own (``--jobs`` at a time).  Every run
is held to the reference package's stored run of the path
(``tests/data/torch_reference_v1.npz``, ``--reference``) with
``utils/parity.compare_long``, and, where ``kernel`` ran too, to the
``kernel`` run the same way.  Prints, for each, the gap after 10, 50, 100,
300 and 850 frames in cm and mrad, the largest gap, the drift (v1, full)
beside the other run's, and a JSON summary last; ``--out`` writes the
per-frame gaps, poses and map sizes too.  With two or more of the port's
runs on the card (every variant but ``plain``, bit for bit ``kernel``), it
first prints their spread, the reference left out (``spread``): the largest
gap in m and rad, map-size difference and drift difference between any two
of them, and their drift's range; then the reference's gaps to each run,
and whether the reference stands inside that spread: its gaps to the
``kernel`` run no larger than the largest between two of the port's runs,
its drift within their range.

``--classes N`` runs nothing of the above: on the first N scans it counts
what a one-ulp shift of the scan does to BPF's front end: the points whose
DCVC azimuth bin moves, and the points whose class (ground, non-ground,
beam, pillar, facade) moves, for ``ulp_up``, ``ulp_down``, and a shift of
random sign (seeded) that leaves alone the points on a bin's half.  ``--set`` and ``--azimuth`` change the config and the
scans, for a quick check at a small size.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pfilter_tpu_torch.ops import knn_tiled  # noqa: E402

REFERENCE = ROOT / "tests" / "data" / "torch_reference_v1.npz"
NUDGES = tuple(f"nudge_{axis}{sign}" for axis in "xyz" for sign in "+-")
VARIANTS = ("plain", "packed", "kernel", "ulp_up", "ulp_down") + NUDGES
EAGER = ("plain", "packed")  # a plain kNN reads sizes on the host: no CUDA graph
NUDGE_FRAME = 5  # the nudge follows this frame, before the first capture (frame 10)
# The reference kernel's key layout (pfilter_tpu/ops/knn_tiled.py:46-53).
ALIGN = 128  # halo rows are read from 128-slot-aligned starts
IDX_BITS = 13
IDX_MASK = (1 << IDX_BITS) - 1
INT_MAX = 2**31 - 1


def _fma(a, b, c):
    """float32 ``a * b + c`` with one rounding (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def query_tiled_sorted_packed(tmap, sq_world, bounds, nt: int, tile_cells: int, tile_cap: int, k: int = 5):
    """``knn_tiled.query_tiled_sorted_plain`` with the reference kernel's
    distances and packed keys: on the same halo rows and caps, the squared
    distance as the kernel's augmented dot product about the tile centre,
    its low IDX_BITS bits replaced by the halo lane (row ``r`` of the halo
    at lane ``r * (3 * tile_cap + ALIGN)`` plus the slot's offset from the
    row's aligned start), the k smallest keys, and each key's distance bits."""
    knn_tiled._check_inputs(tmap, sq_world, bounds, nt)
    q, nt2, dev = sq_world.shape[0], nt * nt, sq_world.device
    w = 3 * tile_cap
    c_start, c_cnt = knn_tiled._halo_ranges(tmap, nt, w)
    ctr = knn_tiled._tile_centers(tmap.origin, nt, tile_cells)
    p = torch.arange(q, dtype=torch.int32, device=dev)
    tid = torch.clamp(torch.searchsorted(bounds, p, right=True) - 1, 0, nt2 - 1)
    processed = p < bounds[nt2]
    width = max(int(c_cnt.max()), 1)
    j = torch.arange(width, dtype=torch.int32, device=dev)
    cnt_q, start_q = c_cnt[tid], c_start[tid]
    ok = (j[None, None, :] < cnt_q[:, :, None]).reshape(q, 3 * width)
    slots = torch.where(ok, (start_q[:, :, None] + j).reshape(q, 3 * width), 0).long()
    row = torch.arange(3, dtype=torch.int32, device=dev)
    lane = (row[None, :, None] * (w + ALIGN) + (start_q % ALIGN)[:, :, None] + j).reshape(q, 3 * width)
    cq = ctr[tid]
    qx, qy, qz = (sq_world[:, i : i + 1] - cq[:, i : i + 1] for i in range(3))
    xs, ys, zs = (tmap.xyz_t[i][slots] - cq[:, i : i + 1] for i in range(3))
    qq = _fma(qz, qz, _fma(qy, qy, qx * qx))
    cc = _fma(zs, zs, _fma(ys, ys, xs * xs))
    d = qx * (-2.0 * xs)
    for a, b in ((qy, -2.0 * ys), (qz, -2.0 * zs), (qq, torch.ones_like(cc))):
        d = _fma(a.expand_as(b), b, d)
    d = _fma(torch.ones_like(cc), cc, d)
    key = torch.where(ok, (torch.clamp(d, min=0.0).view(torch.int32) & ~IDX_MASK) | lane, INT_MAX)
    top, pos = torch.topk(key, min(k, key.shape[1]), dim=1, largest=False, sorted=True)
    idx = torch.take_along_dim(slots, pos, 1).to(torch.int32)
    sd = torch.where(top == INT_MAX, float("inf"), (top & ~IDX_MASK).view(torch.float32))
    if sd.shape[1] < k:  # fewer candidate columns than k
        fill = k - sd.shape[1]
        sd = torch.cat([sd, torch.full((q, fill), float("inf"), device=dev)], 1)
        idx = torch.cat([idx, torch.zeros((q, fill), dtype=torch.int32, device=dev)], 1)
    sd = torch.where(processed[:, None], sd, float("inf"))
    idx = torch.where(torch.isfinite(sd), idx, 0)
    return knn_tiled.TiledKnnResult(idx=idx, sqdist=sd)


def nudge_pose(state, variant: str):
    """``state`` (``ESState`` or ``BPFState``) with its pose's translation
    moved one float32 ulp along the axis and toward the sign of ``variant``
    (``nudge_x+`` ... ``nudge_z-``)."""
    axis, up = "xyz".index(variant[-2]), variant[-1] == "+"
    t = state.pose.t.clone()
    t[axis] = torch.nextafter(t[axis], torch.tensor(float("inf") if up else float("-inf"), device=t.device))
    return state._replace(pose=state.pose._replace(t=t))


def run_variant(args) -> None:
    """One variant's run over ``--frames`` scans; its
    ``parity.records_arrays``, seconds and kNN kernel launches to
    ``--records-out``."""
    from pfilter_tpu_torch import bench, resolve_device
    from pfilter_tpu_torch.config import apply_dotted_overrides, kitti_config
    from pfilter_tpu_torch.pipeline import make_pipeline
    from pfilter_tpu_torch.utils import parity

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = apply_dotted_overrides(kitti_config(), args.set) if args.set else kitti_config()
    frames, _ = bench.render(cfg, args.frames, args.azimuth, bench.PROTOCOL["speed_m_per_frame"], dev)
    if args.variant.startswith("ulp_"):
        to = float("inf") if args.variant == "ulp_up" else float("-inf")
        frames = [(torch.where(v[:, None], torch.nextafter(x, torch.full_like(x, to)), x), v) for x, v in frames]
    if args.variant in EAGER:
        knn_tiled.query_tiled_sorted = query_tiled_sorted_packed if args.variant == "packed" else knn_tiled.query_tiled_sorted_plain
    pipe = make_pipeline(cfg.replace(mode=args.mode), device=dev, sync=False, fetch_lag=4, graphs=False if args.variant in EAGER else None)
    t0 = time.perf_counter()
    for i, scan in enumerate(frames):
        pipe.process_frame(*scan)
        if args.variant in NUDGES and i == NUDGE_FRAME:
            pipe.state = nudge_pose(pipe.state, args.variant)
        if (i + 1) % 50 == 0:
            print(f"[{args.variant}] {i + 1} frames, {time.perf_counter() - t0:.0f} s", file=sys.stderr, flush=True)
    pipe.flush()
    rec = parity.records_arrays(pipe.records)
    np.savez(args.records_out, seconds=time.perf_counter() - t0, kernel_launches=knn_tiled.KERNEL_LAUNCHES, **rec)


def drifts(run: dict, gt: np.ndarray, scores: dict) -> dict:
    """A run's drift, %, under each stored score (``"v1"``, ``"full"``)
    whose frames it holds, over the same frames and lengths."""
    from pfilter_tpu_torch.utils import metrics

    out = {}
    for name in ("v1", "full"):
        s = scores.get(name)
        if s and s["lengths"] and s["frames"] <= len(run["t"]):
            est = metrics.poses_to_matrices(run["q"][: s["frames"]], run["t"][: s["frames"]])
            out[name] = metrics.kitti_drift(gt[: s["frames"]], est, lengths=tuple(s["lengths"]), step=10)["t_err_pct"]
    return out


def pair_gaps(a: dict, b: dict, da: dict, db: dict) -> dict:
    """How far two runs stand apart over the frames both hold: the largest
    pose gap (m, rad), the largest map-size difference relative to the
    smaller of the two sizes, and the drift differences (``da``, ``db``:
    ``drifts``), percentage points."""
    from pfilter_tpu_torch.utils import parity

    g, r = parity.pose_gaps(a["q"], a["t"], b["q"], b["t"])
    k = len(g)
    sa, sb = np.asarray(a["map_sizes"][:k], np.float64), np.asarray(b["map_sizes"][:k], np.float64)
    rel = np.abs(sa - sb) / np.maximum(np.minimum(sa, sb), 1.0)
    out = {"gap_m": float(g.max()), "gap_rad": float(r.max()), "map_size_rel": float(rel.max())}
    out.update({f"drift_{p}": abs(da[p] - db[p]) for p in da if p in db})
    return out


def spread(runs: dict, ref: dict, gt: np.ndarray, scores: dict) -> dict:
    """The spread of the port's runs (every variant but ``plain``), the
    reference left out: ``pairs`` (``pair_gaps`` of every two), ``largest``
    (each measure's largest over the pairs) and ``drift_range``; then
    ``to_reference`` (``pair_gaps`` of each run and the reference) and
    ``inside``: per measure, whether the reference's gap to the ``kernel``
    run is no larger than ``largest``, and whether its drift lies in
    ``drift_range``."""
    members = [v for v in runs if v != "plain"]
    d = {v: drifts(runs[v], gt, scores) for v in members}
    pairs = {f"{a} | {b}": pair_gaps(runs[a], runs[b], d[a], d[b]) for a, b in itertools.combinations(members, 2)}
    largest = {m: max(p[m] for p in pairs.values()) for m in next(iter(pairs.values()))}
    drift_range = {p: [min(d[v][p] for v in members), max(d[v][p] for v in members)] for p in d[members[0]]}
    ref_d = {p: scores[p]["drift_t_pct"] for p in drift_range}
    to_ref = {v: pair_gaps(runs[v], ref, d[v], ref_d) for v in members}
    inside = {m: to_ref["kernel"][m] <= largest[m] for m in largest} if "kernel" in to_ref else {}
    inside.update({f"drift_{p}_in_range": bool(lo <= ref_d[p] <= hi) for p, (lo, hi) in drift_range.items()})
    return {"members": members, "drift": d, "pairs": pairs, "largest": largest, "drift_range": drift_range,
            "reference_drift": ref_d, "to_reference": to_ref, "inside": inside}


def _fmt(g: dict) -> str:
    return ", ".join(f"{k} {v * 100:.3f} cm" if k == "gap_m" else f"{k} {v * 1e3:.3f} mrad" if k == "gap_rad"
                     else f"{k} {v:.2%}" if k == "map_size_rel" else f"{k} {v:.4f} points" for k, v in g.items())


def scan_classes(args) -> None:
    """``--classes``: print, per scan and shift, the DCVC azimuth bins and
    the BPF front-end classes that a one-ulp shift of the scan moves."""
    from pfilter_tpu_torch import bench, resolve_device
    from pfilter_tpu_torch.config import kitti_config
    from pfilter_tpu_torch.models import bpf_frontend
    from pfilter_tpu_torch.ops import dcvc

    dev = resolve_device(args.device)
    cfg = kitti_config().replace(mode="bpf")
    frames, _ = bench.render(cfg, args.classes, args.azimuth, bench.PROTOCOL["speed_m_per_frame"], dev)
    inv = dcvc._f32(np.float32(1.0) / np.float32(cfg.dcvc.delta_a))

    def az_bin(x):  # dcvc.cluster's azimuth bin, before rounding
        az = torch.rad2deg(dcvc.atan2_f32(x[:, 1], x[:, 0]))
        return torch.where(az < 0, az + 360.0, az) * inv

    for f, (x, v) in enumerate(frames):
        fa = az_bin(x)
        tie = (fa - torch.floor(fa) - 0.5).abs() < 1e-4
        base = bpf_frontend.run_frontend(x, v, cfg)
        sign = torch.randint(0, 2, x.shape, generator=torch.Generator().manual_seed(f)).to(x.device).bool()
        shifts = {"ulp_up": torch.full_like(x, float("inf")), "ulp_down": torch.full_like(x, float("-inf")),
                  "ulp_random_off_ties": torch.where(sign, float("inf"), float("-inf"))}
        for name, to in shifts.items():
            move = v[:, None] & ~tie[:, None] if name == "ulp_random_off_ties" else v[:, None]
            xs = torch.where(move, torch.nextafter(x, to), x)
            out = bpf_frontend.run_frontend(xs, v, cfg)
            moved = {k: int((getattr(base, k) != getattr(out, k)).sum()) for k in ("ground_mask", "nonground_mask", "beam_mask", "pillar_mask", "facade_mask")}
            counts = {k: f"{int(getattr(base, k).sum())}->{int(getattr(out, k).sum())}" for k in moved}
            print(f"frame {f}, {name}: {int(v.sum())} points, {int((tie & v).sum())} on an azimuth bin's half, "
                  f"{int(((torch.round(az_bin(xs)) != torch.round(fa)) & v).sum())} change azimuth bin; points changing class {moved}; "
                  f"class sizes {counts}", flush=True)


def _summary(res: dict) -> dict:
    """The JSON record of one ``compare_long`` result."""
    return {
        "gap_at_cm_mrad": {f: [g[0] * 100, g[1] * 1e3] for f, g in res["gap_at"].items()},
        "max_gap_cm": res["max_gap_t_m"] * 100, "max_gap_frame": res["max_gap_t_frame"],
        "max_gap_mrad": res["max_gap_rad"] * 1e3, "max_gap_rad_frame": res["max_gap_rad_frame"],
        "drift": res["drift"], "drift_other": res["drift_ref"],
        "overflow_frames_differing": res["overflow_frames_differing"], "map_size_rel": res["map_size_rel"],
        "map_size_rel_at": res["map_size_rel_at"], "failures": res["failures"],
        "gap_cm_per_frame": (res["gap_t_m"] * 100).tolist(),
        "gap_mrad_per_frame": (res["gap_rad"] * 1e3).tolist(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="es", choices=("es", "bpf"))
    ap.add_argument("--frames", type=int, default=None, help="default: the stored run's length (850 ES, 300 BPF)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--azimuth", type=int, default=1800)
    ap.add_argument("--set", action="append", default=[], help="dotted config override k=v (kitti_config())")
    ap.add_argument("--variants", nargs="+", default=["plain", "packed"], choices=VARIANTS)
    ap.add_argument("--jobs", type=int, default=2, help="variants run at once, each in its own process")
    ap.add_argument("--reference", default=str(REFERENCE))
    ap.add_argument("--out", default=None, help="also write the whole record, per-frame gaps included, as JSON")
    ap.add_argument("--classes", type=int, default=0, help="only count what a one-ulp shift does to the first N scans' BPF classes")
    ap.add_argument("--variant", choices=VARIANTS, help=argparse.SUPPRESS)
    ap.add_argument("--records-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from pfilter_tpu_torch import bench
    from pfilter_tpu_torch.utils import metrics, parity, synthetic

    if args.frames is None:
        args.frames = bench.PROTOCOL["frames"] if args.mode == "es" else bench.PROTOCOL["bpf_frames"]
    if args.variant is not None:
        run_variant(args)
        return 0
    if args.classes:
        scan_classes(args)
        return 0

    record = {"device": bench.device_line(torch.device(args.device)), "mode": args.mode, "frames": args.frames, "variants": {}}
    print(f"device: {record['device']}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    ref, side = parity.load_reference(args.reference)
    scores = side["paths"][args.mode]["scores"]
    gt = bench.ground_truth(synthetic.make_loop_trajectory(args.frames, speed=bench.PROTOCOL["speed_m_per_frame"]))
    with tempfile.TemporaryDirectory() as tmp:
        outs = {v: Path(tmp) / f"{v}.npz" for v in args.variants}
        common = ["--mode", args.mode, "--frames", str(args.frames), "--device", args.device, "--azimuth", str(args.azimuth)]
        common += [f"--set={s}" for s in args.set]
        pending, running, rc = list(args.variants), {}, 0
        while pending or running:
            while pending and len(running) < args.jobs:
                v = pending.pop(0)
                running[v] = subprocess.Popen([sys.executable, __file__, "--variant", v, "--records-out", str(outs[v])] + common)
            for v, proc in list(running.items()):
                if proc.poll() is not None:
                    rc = rc or proc.returncode
                    del running[v]
            time.sleep(1.0)
        if rc:
            print(f"torch_knn_packed_keys_ab: a variant's run failed (exit {rc})", file=sys.stderr)
            return rc
        runs = {v: dict(np.load(outs[v])) for v in args.variants}
    base = runs.get("kernel")
    if base is not None:  # the kernel run scored like a stored run: each score's frames and lengths
        base_scores = {
            name: dict(s, drift_t_pct=metrics.kitti_drift(
                gt[: s["frames"]], metrics.poses_to_matrices(base["q"][: s["frames"]], base["t"][: s["frames"]]),
                lengths=tuple(s["lengths"]), step=10)["t_err_pct"])
            for name, s in scores.items() if s["frames"] <= len(base["t"]) and s["lengths"]
        }
    if len([v for v in runs if v != "plain"]) >= 2:
        sp = spread(runs, ref[args.mode], gt, scores)
        record["spread"] = sp
        print(f"{args.mode}: the port's own spread over {sp['members']}, the reference left out:", flush=True)
        for pair, g in sp["pairs"].items():
            print(f"  {pair}: {_fmt(g)}", flush=True)
        print(f"  largest: {_fmt(sp['largest'])}; drift {' '.join(f'{p} {lo:.4f}-{hi:.4f} %' for p, (lo, hi) in sp['drift_range'].items())}", flush=True)
        print(f"{args.mode}: the reference (drift {' '.join(f'{p} {x:.4f} %' for p, x in sp['reference_drift'].items())}) against each run:", flush=True)
        for v, g in sp["to_reference"].items():
            print(f"  {v} | reference: {_fmt(g)}", flush=True)
        print(f"{args.mode}: the reference inside the port's spread: {sp['inside']}", flush=True)
    for v, run in runs.items():
        res = bench.hold_to_reference(run, ref[args.mode], scores, gt)
        print(parity.summary_long(f"{args.mode}, {v}, against the reference", res), flush=True)
        record["variants"][v] = {"seconds": float(run["seconds"]), "kernel_launches": int(run["kernel_launches"]), "vs_reference": _summary(res),
                                 "per_frame": {f: run[f].tolist() for f in ("q", "t", "map_sizes")}}
        if base is not None and v != "kernel":
            res = bench.hold_to_reference(run, base, base_scores, gt)
            print(parity.summary_long(f"{args.mode}, {v}, against the kernel run", res), flush=True)
            record["variants"][v]["vs_kernel"] = _summary(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))

    def brief(x):
        return {k: brief(y) for k, y in x.items() if not str(k).endswith("per_frame")} if isinstance(x, dict) else x

    print(json.dumps(brief(record)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
