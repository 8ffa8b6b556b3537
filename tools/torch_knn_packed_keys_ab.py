#!/usr/bin/env python3
"""Does the reference kNN's packed lane key make default ES part from the
reference?  An A/B of the port's default ES with two plain kNNs, and the
port's own sensitivity to a last-bit change.

    python3 tools/torch_knn_packed_keys_ab.py [--frames 850] [--device cuda] [--out FILE.json]
    python3 tools/torch_knn_packed_keys_ab.py --variants kernel ulp_up ulp_down [--mode bpf]
    python3 tools/torch_knn_packed_keys_ab.py --variants kernel nudge_x+ nudge_x- nudge_y+ nudge_y- nudge_z+ nudge_z-
    python3 tools/torch_knn_packed_keys_ab.py --ensemble --jobs 3 --spread-out tests/data/torch_port_spread_v1.json [--mode bpf]
    python3 tools/torch_knn_packed_keys_ab.py --windows tests/data/torch_reference_states_v1 --jobs 3
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
(e) ``nudge_<axis><sign>`` (``parity.NUDGES``: ``nudge_x+`` .. ``nudge_z-``
    the translation, ``nudge_qx+`` .. ``nudge_qz-`` the rotation
    quaternion's vector part): as (c), the scans untouched, and the pose in
    the pipeline's state moved one float32 ulp along one coordinate once,
    after frame NUDGE_FRAME (an eager frame; ``<nudge>@8``: after frame 8,
    also eager, before the capture at frame 10): a last-bit change
    downstream of the front end, as the reference's arithmetic differs from
    the port's.

``--ensemble`` runs ``ENSEMBLE``: the kernel run and every nudge after
frame 5 and after frame 8 (25 runs).  A run equal bit for bit to an earlier
one (a one-ulp nudge of a quaternion component near 0 can round away) counts
once (``distinct``): it is dropped, and the nudges after frame 7
(``RESERVE``) are run in their order until the ensemble holds
ENSEMBLE_RUNS distinct runs.  ``--spread-out FILE`` writes, for the path
run, each distinct run's drift (v1, full) and each map's mean size over
frames 100 to the end, the runs dropped, the card and the commit into FILE
(merged with the other path's entry where FILE exists): the values
``utils/parity.py``'s bands are derived from (``parity.spread_bands``: 3
sqrt(2) times their sample standard deviation), and the reference's
standing among them (``parity.standing``: ``z``, rank).

``--windows DIR`` runs nothing of the above: from each stored reference
state of DIR (``tools/torch_reference_trajectories.py --states``) it runs
the port's window as ``parity.run_window`` does, once as it is and once
per nudge of ``parity.NUDGES`` applied to the restored pose, and prints
each window's length ``W`` (``parity.window_length``: the frames over which
every nudged resume stays within half of ``parity.compare``'s per-frame
gates of the un-nudged one) and the un-nudged resume held to the
reference's frames over ``W`` and over all 50 (``parity.hold_window``),
and which nudged resumes equal the un-nudged one bit for bit.

The variants are dealt to ``--jobs`` processes, each rendering the scans once
and running its share one after another.  Every run
is held to the reference package's stored run of the path
(``tests/data/torch_reference_v1.npz``, ``--reference``) with
``utils/parity.compare_long``, and, where ``kernel`` ran too, to the
``kernel`` run the same way.  Prints, for each, the gap after 10, 50, 100,
300 and 850 frames in cm and mrad, the largest gap, the drift (v1, full)
beside the other run's, and a JSON summary last; ``--out`` writes the
per-frame gaps, poses and map sizes too.

``--classes N`` runs nothing of the above: on the first N scans it counts
what a one-ulp shift of the scan does to BPF's front end: the points whose
DCVC azimuth bin moves, and the points whose class (ground, non-ground,
beam, pillar, facade) moves, for ``ulp_up``, ``ulp_down``, and a shift of
random sign (seeded) that leaves alone the points on a bin's half.  ``--set`` and ``--azimuth`` change the config and the
scans, for a quick check at a small size.
"""

from __future__ import annotations

import argparse
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
from pfilter_tpu_torch.utils import parity  # noqa: E402

REFERENCE = ROOT / "tests" / "data" / "torch_reference_v1.npz"
NUDGE_FRAME = 5  # the nudge follows this frame, before the first capture (frame 10)
LATE_NUDGE_FRAME = 8  # "<nudge>@8": after this frame instead, also eager
RESERVE_NUDGE_FRAME = 7  # the reserve's nudges: after this frame, also eager
ENSEMBLE = ("kernel",) + parity.NUDGES + tuple(f"{n}@{LATE_NUDGE_FRAME}" for n in parity.NUDGES)
RESERVE = tuple(f"{n}@{RESERVE_NUDGE_FRAME}" for n in parity.NUDGES)  # in this order, for runs ENSEMBLE repeats
ENSEMBLE_RUNS = len(ENSEMBLE)  # distinct runs a path: the kernel run and 24 nudged ones
VARIANTS = ("plain", "packed", "kernel", "ulp_up", "ulp_down") + parity.NUDGES + ENSEMBLE[1 + len(parity.NUDGES):] + RESERVE
EAGER = ("plain", "packed")  # a plain kNN reads sizes on the host: no CUDA graph
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


def nudge_of(variant: str) -> tuple:
    """``(nudge, frame)`` of a nudged variant (``nudge_x+``, ``nudge_qz-@8``),
    ``(None, None)`` of any other."""
    name, _, frame = variant.partition("@")
    return (name, int(frame) if frame else NUDGE_FRAME) if name in parity.NUDGES else (None, None)


def run_variants(args) -> None:
    """Each variant of ``--variant`` run over ``--frames`` scans, one after
    another on the scans rendered once; each run's
    ``parity.records_arrays``, seconds and kNN kernel launches to
    ``--records-out``/<variant>.npz."""
    from pfilter_tpu_torch import bench, resolve_device
    from pfilter_tpu_torch.config import apply_dotted_overrides, kitti_config
    from pfilter_tpu_torch.pipeline import make_pipeline

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = apply_dotted_overrides(kitti_config(), args.set) if args.set else kitti_config()
    rendered, _ = bench.render(cfg, args.frames, args.azimuth, bench.PROTOCOL["speed_m_per_frame"], dev)
    default_knn = knn_tiled.query_tiled_sorted
    for variant in args.variant:
        frames = rendered
        if variant.startswith("ulp_"):
            to = float("inf") if variant == "ulp_up" else float("-inf")
            frames = [(torch.where(v[:, None], torch.nextafter(x, torch.full_like(x, to)), x), v) for x, v in rendered]
        knn_tiled.query_tiled_sorted = {"packed": query_tiled_sorted_packed, "plain": knn_tiled.query_tiled_sorted_plain}.get(variant, default_knn)
        nudge, nudge_frame = nudge_of(variant)
        knn_tiled.KERNEL_LAUNCHES = 0
        pipe = make_pipeline(cfg.replace(mode=args.mode), device=dev, sync=False, fetch_lag=4, graphs=False if variant in EAGER else None)
        t0 = time.perf_counter()
        for i, scan in enumerate(frames):
            pipe.process_frame(*scan)
            if i == nudge_frame:
                pipe.state = parity.nudge_pose(pipe.state, nudge)
            if (i + 1) % 100 == 0:
                print(f"[{variant}] {i + 1} frames, {time.perf_counter() - t0:.0f} s", file=sys.stderr, flush=True)
        pipe.flush()
        rec = parity.records_arrays(pipe.records)
        np.savez(Path(args.records_out) / f"{variant}.npz", seconds=time.perf_counter() - t0, kernel_launches=knn_tiled.KERNEL_LAUNCHES, **rec)
        del pipe, frames


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


def distinct(runs: dict) -> tuple[dict, dict]:
    """``runs`` (name -> ``parity.records_arrays``, in order) split into the
    runs that differ from every earlier one on some frame of some field, and
    ``dropped``: each other run's name -> the earlier run it equals bit for
    bit."""
    kept, dropped = {}, {}
    for v, run in runs.items():
        fields = [k for k in run if np.ndim(run[k])]
        same = next((u for u, r in kept.items() if all(np.array_equal(run[k], r[k]) for k in fields)), None)
        if same is None:
            kept[v] = run
        else:
            dropped[v] = same
    return kept, dropped


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


def run_window_variants(args) -> None:
    """Each window of ``--window`` (a directory name under ``--windows``):
    the port resumed from the stored reference state once as it is and once
    per nudge of ``parity.NUDGES`` (``parity.run_window``), on the scans
    rendered once; each run's ``parity.records_arrays`` to
    ``--records-out``/<window>.<nudge or base>.npz."""
    from pfilter_tpu_torch import bench, resolve_device
    from pfilter_tpu_torch.config import kitti_config

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    windows = json.loads((Path(args.windows) / "states.json").read_text())["windows"]
    n = max(windows[w]["step"] for w in args.window) + parity.WINDOW_FRAMES
    frames, _ = bench.render(kitti_config(), n, args.azimuth, bench.PROTOCOL["speed_m_per_frame"], dev)
    for w in args.window:
        cfg = kitti_config().replace(mode=windows[w]["path"])
        for nudge in (None,) + parity.NUDGES:
            t0 = time.perf_counter()
            run, pipe, _ = parity.run_window(Path(args.windows) / w, cfg, frames, nudge=nudge)
            np.savez(Path(args.records_out) / f"{w}.{nudge or 'base'}.npz", seconds=time.perf_counter() - t0, captures=len(pipe.captures), **run)
            del pipe
        print(f"[{w}] {len(parity.NUDGES) + 1} resumes done", file=sys.stderr, flush=True)


def deal(items: list, jobs: int) -> list:
    """``items`` dealt round-robin to at most ``jobs`` non-empty shares."""
    return [share for share in (items[i::max(1, jobs)] for i in range(max(1, jobs))) if share]


def run_workers(flag: str, shares: list, out: Path, common: list) -> int:
    """One process per share (``flag`` then the share's items), all at once;
    the first non-zero exit code, else 0."""
    procs = [subprocess.Popen([sys.executable, __file__, flag, *share, "--records-out", str(out)] + common) for share in shares]
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


def run_set(variants: list, jobs: int, common: list) -> dict:
    """Every variant of ``variants`` run (``run_variants``, dealt to
    ``jobs`` processes): name -> its records, in the order given.  Raises
    if a process fails."""
    with tempfile.TemporaryDirectory() as tmp:
        rc = run_workers("--variant", deal(list(variants), jobs), Path(tmp), common)
        if rc:
            raise RuntimeError(f"a variant's run failed (exit {rc})")
        return {v: dict(np.load(Path(tmp) / f"{v}.npz")) for v in variants}


def window_lengths(args, common: list) -> int:
    """``--windows``: every window's ``W`` from the port's own nudged
    resumes, and the un-nudged resume held to the reference's frames."""
    from pfilter_tpu_torch import bench

    names = list(json.loads((Path(args.windows) / "states.json").read_text())["windows"])
    reference, _ = parity.load_reference(args.reference)
    record = {"device": bench.device_line(torch.device(args.device)), "windows": {}}
    print(f"device: {record['device']}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        rc = run_workers("--window", deal(names, args.jobs), Path(tmp), common + ["--windows", str(args.windows)])
        if rc:
            print(f"torch_knn_packed_keys_ab: a window's run failed (exit {rc})", file=sys.stderr)
            return rc
        runs = {w: {v: dict(np.load(Path(tmp) / f"{w}.{v}.npz")) for v in ("base",) + parity.NUDGES} for w in names}
    for w in names:
        base, nudged = runs[w]["base"], [runs[w][v] for v in parity.NUDGES]
        length, measured = parity.window_length(base, nudged)
        res = parity.hold_window(base, parity.load_window(Path(args.windows) / w, reference), length)
        gaps = {v: parity.pose_gaps(runs[w][v]["q"], runs[w][v]["t"], base["q"], base["t"]) for v in parity.NUDGES}
        _, same = distinct(runs[w])
        res["step"] = json.loads((Path(args.windows) / w / "meta.json").read_text())["step"]
        print(f"{w}: W = {length} (nudged resumes within {parity.WINDOW_SPREAD_SHARE} of the gates over {measured} frames); largest gap "
              f"of a nudged resume over all {len(base['t'])} frames {max(g[0].max() for g in gaps.values()) * 100:.3f} cm / "
              f"{max(g[1].max() for g in gaps.values()) * 1e3:.3f} mrad; resumes equal to an earlier one bit for bit {same}; "
              f"seconds per resume {float(base['seconds']):.1f}, captures {int(base['captures'])}", flush=True)
        print("  " + parity.summary_window(w, res), flush=True)
        record["windows"][w] = {
            "W": length, "measured": measured, "seconds": float(base["seconds"]), "equal_resumes": same,
            "nudged_gap_cm_per_frame": {v: (g[0] * 100).tolist() for v, g in gaps.items()},
            "vs_reference": {"max_gap_cm": res["max_gap_t_m"] * 100, "max_gap_frame": res["max_gap_t_frame"],
                             "max_gap_mrad": res["max_gap_rad"] * 1e3, "map_size_rel": res["map_size_rel"], "failures": res["failures"],
                             "all": {"max_gap_cm": res["all"]["max_gap_t_m"] * 100, "max_gap_frame": res["all"]["max_gap_t_frame"],
                                     "max_gap_mrad": res["all"]["max_gap_rad"] * 1e3, "map_size_rel": res["all"]["map_size_rel"]},
                             "gap_cm_per_frame": (res["all"]["gap_t_m"] * 100).tolist()},
        }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps({w: {k: v for k, v in r.items() if k != "nudged_gap_cm_per_frame"} | {"vs_reference": {k: v for k, v in r["vs_reference"].items() if k != "gap_cm_per_frame"}}
                      for w, r in record["windows"].items()}), flush=True)
    return 0


def ensemble(args, common: list) -> tuple[dict, dict]:
    """``--ensemble``: ENSEMBLE run, each run equal to an earlier one
    dropped, and RESERVE's runs taken in order until ENSEMBLE_RUNS distinct
    runs stand (or RESERVE is spent): ``(runs, dropped)`` as ``distinct``."""
    runs, dropped = distinct(run_set(ENSEMBLE, args.jobs, common))
    reserve = list(RESERVE)
    while len(runs) < ENSEMBLE_RUNS and reserve:
        take, reserve = reserve[: ENSEMBLE_RUNS - len(runs)], reserve[ENSEMBLE_RUNS - len(runs) :]
        print(f"{args.mode}: {len(runs)} distinct runs ({dropped} repeat earlier ones); running {take}", file=sys.stderr, flush=True)
        runs, more = distinct({**runs, **run_set(take, args.jobs, common)})
        dropped.update(more)
    if len(runs) < ENSEMBLE_RUNS:
        print(f"{args.mode}: only {len(runs)} distinct runs of {ENSEMBLE_RUNS}, the reserve spent", file=sys.stderr, flush=True)
    return runs, dropped


def spread_record(args, runs: dict, dropped: dict, ref: dict, gt: np.ndarray, scores: dict, device: str) -> dict:
    """``--spread-out``: each distinct run's drift (v1, full) and map means
    over frames 100 to the end, the runs dropped, the reference's values,
    the bands (``parity.spread_bands``) and the reference's standing
    (``parity.standing``) on each measure, laid out as the bands."""
    per_run = {v: {"drift": drifts(run, gt, scores), "map_mean": parity.map_means(run).tolist()} for v, run in runs.items()}
    n = len(next(iter(runs.values()))["t"])
    ref_vals = {"drift": {p: scores[p]["drift_t_pct"] for p in next(iter(per_run.values()))["drift"]},
                "map_mean": parity.map_means({"map_sizes": ref["map_sizes"][:n]}).tolist()}
    standing = {"drift": {p: parity.standing([r["drift"][p] for r in per_run.values()], x) for p, x in ref_vals["drift"].items()},
                "map_mean": [parity.standing([r["map_mean"][m] for r in per_run.values()], x) for m, x in enumerate(ref_vals["map_mean"])]}
    return {"device": device, "torch": torch.__version__, "cuda": torch.version.cuda, "commit": args.commit, "frames": n,
            "nudge_frames": [NUDGE_FRAME, LATE_NUDGE_FRAME], "reserve_nudge_frame": RESERVE_NUDGE_FRAME, "runs": per_run,
            "dropped": dropped, "reference": ref_vals, "bands": parity.spread_bands({"paths": {args.mode: {"runs": per_run}}})[args.mode],
            "standing": standing}


def write_spread(path: Path, mode: str, rec: dict) -> None:
    """Merge one path's spread record into ``path``."""
    doc = json.loads(path.read_text()) if path.exists() else {}
    doc.update(generator="tools/torch_knn_packed_keys_ab.py --ensemble --spread-out",
               measures="per run: drift, % (v1: bench.py's 100-300 m over the first 300 frames; full: 100-800 m over every frame), and each "
                        "map's mean size over frames 100 to the end (ES: edge, surf; BPF: beam, pillar, facade)",
               runs="the distinct runs of the ensemble: a run equal bit for bit to an earlier one is in 'dropped' (name -> the run it equals)",
               band="utils/parity.band: 3 * sqrt(2) * the sample standard deviation (n - 1) over the runs")
    doc.setdefault("paths", {})[mode] = rec
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="es", choices=("es", "bpf"))
    ap.add_argument("--frames", type=int, default=None, help="default: the stored run's length (850 ES, 300 BPF)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--azimuth", type=int, default=1800)
    ap.add_argument("--set", action="append", default=[], help="dotted config override k=v (kitti_config())")
    ap.add_argument("--variants", nargs="+", default=["plain", "packed"], choices=VARIANTS)
    ap.add_argument("--ensemble", action="store_true", help=f"run ENSEMBLE_RUNS ({ENSEMBLE_RUNS}) distinct runs in place of --variants")
    ap.add_argument("--spread-out", default=None, help="write each run's drift and map means, the bands and the reference's standing here")
    ap.add_argument("--commit", default=None, help="the commit recorded by --spread-out (default: git's HEAD, where there is a .git)")
    ap.add_argument("--windows", default=None, metavar="DIR", help="measure each stored state's window length W (and nothing else)")
    ap.add_argument("--jobs", type=int, default=2, help="processes at once; the variants (or windows) are dealt to them")
    ap.add_argument("--reference", default=str(REFERENCE))
    ap.add_argument("--out", default=None, help="also write the whole record, per-frame gaps included, as JSON")
    ap.add_argument("--classes", type=int, default=0, help="only count what a one-ulp shift does to the first N scans' BPF classes")
    ap.add_argument("--variant", nargs="+", choices=VARIANTS, help=argparse.SUPPRESS)
    ap.add_argument("--window", nargs="+", help=argparse.SUPPRESS)
    ap.add_argument("--records-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from pfilter_tpu_torch import bench
    from pfilter_tpu_torch.utils import metrics, synthetic

    if args.frames is None:
        args.frames = bench.PROTOCOL["frames"] if args.mode == "es" else bench.PROTOCOL["bpf_frames"]
    if args.variant is not None:
        run_variants(args)
        return 0
    if args.window is not None:
        run_window_variants(args)
        return 0
    if args.classes:
        scan_classes(args)
        return 0
    common = ["--mode", args.mode, "--frames", str(args.frames), "--device", args.device, "--azimuth", str(args.azimuth)]
    common += [f"--set={s}" for s in args.set]
    if args.windows is not None:
        return window_lengths(args, common)
    if args.commit is None:
        r = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True, text=True)
        args.commit = r.stdout.strip() if r.returncode == 0 else "unknown (no .git)"

    record = {"device": bench.device_line(torch.device(args.device)), "mode": args.mode, "frames": args.frames, "variants": {}}
    print(f"device: {record['device']}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    ref, side = parity.load_reference(args.reference)
    scores = side["paths"][args.mode]["scores"]
    gt = bench.ground_truth(synthetic.make_loop_trajectory(args.frames, speed=bench.PROTOCOL["speed_m_per_frame"]))
    dropped = {}
    try:
        runs, dropped = ensemble(args, common) if args.ensemble else (run_set(args.variants, args.jobs, common), {})
    except RuntimeError as e:
        print(f"torch_knn_packed_keys_ab: {e}", file=sys.stderr)
        return 1
    base = runs.get("kernel")
    if base is not None:  # the kernel run scored like a stored run: each score's frames and lengths
        base_scores = {
            name: dict(s, drift_t_pct=metrics.kitti_drift(
                gt[: s["frames"]], metrics.poses_to_matrices(base["q"][: s["frames"]], base["t"][: s["frames"]]),
                lengths=tuple(s["lengths"]), step=10)["t_err_pct"])
            for name, s in scores.items() if s["frames"] <= len(base["t"]) and s["lengths"]
        }
    if args.spread_out:
        rec = spread_record(args, {v: r for v, r in runs.items() if v != "plain"}, dropped, ref[args.mode], gt, scores, record["device"])
        write_spread(Path(args.spread_out), args.mode, rec)
        record["spread_record"] = {k: v for k, v in rec.items() if k != "runs"}
        for kind, bands in rec["bands"].items():
            for key, b in (bands.items() if isinstance(bands, dict) else enumerate(bands)):
                st = rec["standing"][kind][key]
                print(f"{args.mode} {kind} {key}: band {b:.6g}; the port's {st['n']} distinct runs mean {st['mean']:.6g}, s {st['s']:.6g}, "
                      f"range {st['min']:.6g}-{st['max']:.6g}; the reference z = {st['z']:.3f}, rank {st['rank']} of {st['of']}", flush=True)
        print(f"{args.mode}: runs dropped as equal to an earlier one: {dropped}", flush=True)
    for v, run in runs.items():
        res = bench.hold_to_reference(run, ref[args.mode], scores, gt, args.mode)
        print(parity.summary_long(f"{args.mode}, {v}, against the reference", res), flush=True)
        record["variants"][v] = {"seconds": float(run["seconds"]), "kernel_launches": int(run["kernel_launches"]), "vs_reference": _summary(res),
                                 "per_frame": {f: run[f].tolist() for f in ("q", "t", "map_sizes")}}
        if base is not None and v != "kernel":
            res = bench.hold_to_reference(run, base, base_scores, gt, args.mode)
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
