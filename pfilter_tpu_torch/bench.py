"""The bench protocol of the reference package's ``bench.py``, run by the port.

    python -m pfilter_tpu_torch.bench [--reference tests/data/torch_reference_v1.npz]
        [--states tests/data/torch_reference_states_v1]

Renders the v1 city loop (``make_city_world(seed=7)``,
``make_loop_trajectory(850, speed=1.5)``, HDL-64 at 1800 azimuth) on the
device before anything is timed, runs 850 ES frames through
``make_pipeline(cfg, sync=False, fetch_lag=4)`` at ``kitti_config()`` (10
warm-up frames, then the steady loop on the host clock, the device
synchronised at both ends), scores the drift with the KITTI protocol (v1:
100, 200, 300 m over the first 300 frames; full: 100-800 m over every
frame), then runs BPF over the first 300 frames the same way.  On a CUDA
device each pipeline captures its frame once as a CUDA graph and replays it
for every later frame.

The scans are ``synthetic.render_shared_sequence``'s: noise-free renders
plus ``synthetic.shared_range_noise``, the scans of the reference package's
stored runs, so ``--reference FILE`` (``tests/data/torch_reference_v1.npz``)
holds both free runs to the reference's own (``utils/parity.compare_long``:
frames 0-99 frame by frame; overflow lanes every frame; drift and each map's
mean size within the bands of the port's own spread), and ``--states DIR``
(``tests/data/torch_reference_states_v1``) then runs every window: the
reference's own state at depth restored into the port, the next 50 frames
run from it and held to the reference's frame by frame
(``utils/parity.compare_window``).  They are not ``bench.py``'s scans, whose
range noise comes from the reference renderer's own generator.

Prints exactly one JSON line: every key of ``bench.py``'s, with the same
meaning, and ``captures``, ``replays``, ``knn_launches``, ``kernel_launches``,
``replayed_ms_per_frame``, ``stopped_by_budget``, ``render_note``, the
``reference`` block (with ``windows``) and ``failures``, every gate missed.  Exits non-zero
when ``failures`` is not empty.  Progress goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# bench.py's pinned protocol, field for field.
PROTOCOL = {
    "frames": 850,
    "warmup": 10,
    "speed_m_per_frame": 1.5,
    "azimuth": 1800,
    "lengths_m": (100, 200, 300),  # pinned v1, scored on the first v1_frames
    "v1_frames": 300,
    "full_lengths_m": (100, 200, 300, 400, 500, 600, 700, 800),
    "bpf_frames": 300,  # embedded BPF segment runs the v1 protocol
    "render_outside_timed_loop": True,
}
DEFAULT_BUDGET_S = 420.0
ES_BUDGET_SHARE = 0.85  # the ES steady loop stops past this share of the budget
BPF_BUDGET_SHARE = 0.92
BPF_MIN_LEFT_S = 150.0  # the BPF segment is skipped with less budget left
DRIFT_BAR = 0.783  # the C++ reference's KITTI drift (BASELINE.md)
KNN_PER_FRAME = {"es": 2, "bpf": 3}  # kNN launches per frame after the first, one association per map
RENDER_NOTE = (
    "scans: synthetic.render_shared_sequence (noise-free render, t_time = frame; then N(0, 0.008) m range noise "
    "from np.random.default_rng(1000 + frame), synthetic.shared_range_noise), the scans of the reference package's "
    "stored runs; not bench.py's scans, whose noise comes from the reference renderer's generator"
)


def _log(t_wall0: float, msg: str) -> None:
    print(f"[bench +{time.perf_counter() - t_wall0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def device_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def pad_scans(cfg, xyz, valid) -> list:
    """Each rendered scan padded (or truncated) to ``scan_points`` on its
    device: ``[(xyz [scan_points, 3], valid [scan_points])]``."""
    cap = cfg.capacity.scan_points
    n = min(xyz.shape[1], cap)
    frames = []
    for x_i, v_i in zip(xyz, valid):
        x = torch.zeros((cap, 3), dtype=torch.float32, device=xyz.device)
        v = torch.zeros(cap, dtype=torch.bool, device=xyz.device)
        x[:n], v[:n] = x_i[:n], v_i[:n]
        frames.append((x, v))
    return frames


def ground_truth(poses) -> np.ndarray:
    """[N, 4, 4] ground-truth poses relative to frame 0."""
    from pfilter_tpu_torch.utils import metrics

    gt = metrics.poses_to_matrices(np.asarray(poses.q), np.asarray(poses.t))
    return np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)


def render(cfg, n_frames: int, azimuth: int, speed: float, device) -> tuple[list, np.ndarray]:
    """The protocol's scans on ``device``, padded (``pad_scans``), and the
    ground truth (``ground_truth``)."""
    from pfilter_tpu_torch.utils import synthetic

    poses = synthetic.make_loop_trajectory(n_frames, speed=speed)
    xyz, valid = synthetic.render_shared_sequence(synthetic.make_city_world(seed=7), poses, cfg.lidar, azimuth, device=device)
    frames = pad_scans(cfg, xyz, valid)
    del xyz, valid
    if frames[0][0].device.type == "cuda":
        torch.cuda.synchronize(frames[0][0].device)
    return frames, ground_truth(poses)


def scored(gt: np.ndarray, est: np.ndarray, lengths) -> tuple[dict, tuple]:
    """bench.py's scoring: the protocol lengths up to 0.8 of the path (else
    50 and 100 m), every 10 frames; -1 where no segment fits."""
    from pfilter_tpu_torch.utils import metrics

    path = metrics.trajectory_distances(gt)[-1]
    ls = tuple(float(length) for length in lengths if length <= path * 0.8) or (50.0, 100.0)
    d = metrics.kitti_drift(gt, est, lengths=ls, step=10)
    if d["n_segments"] == 0:
        d = dict(d, t_err_pct=-1.0, r_err_deg_per_m=-1.0)
    return d, ls


def score_protocol(gt: np.ndarray, q: np.ndarray, t: np.ndarray) -> dict:
    """A run's poses scored as ``bench.py`` scores them (``gt`` its first
    ``len(t)`` frames): v1 over the first ``v1_frames``, full over all, ATE
    and the path's length."""
    from pfilter_tpu_torch.utils import metrics

    gt = gt[: len(t)]
    est = metrics.poses_to_matrices(q, t)
    n_v1 = min(int(PROTOCOL["v1_frames"]), len(t))
    v1, v1_lengths = scored(gt[:n_v1], est[:n_v1], PROTOCOL["lengths_m"])
    full, full_lengths = scored(gt, est, PROTOCOL["full_lengths_m"])
    return dict(v1=v1, v1_lengths=v1_lengths, full=full, full_lengths=full_lengths,
                ate=metrics.ate_rmse(gt, est), path=float(metrics.trajectory_distances(gt)[-1]))


def hold_to_reference(records: dict, ref: dict, scores: dict, gt: np.ndarray, path: str) -> dict:
    """``parity.compare_long`` of a run (``records``: ``parity.records_arrays``)
    against its stored path ``ref`` (``scores``: the sidecar's scores of that
    path), the port's drift taken over the same frames and lengths as each
    stored score ("100", "v1", "full") the run covers."""
    from pfilter_tpu_torch.utils import metrics, parity

    drift, ref_drift = {}, {}
    for name, s in scores.items():
        n = s["frames"]
        if s.get("drift_t_pct") is None or len(records["t"]) < n or not s["lengths"]:
            continue
        est = metrics.poses_to_matrices(records["q"][:n], records["t"][:n])
        drift[name] = metrics.kitti_drift(gt[:n], est, lengths=tuple(s["lengths"]), step=10)["t_err_pct"]
        ref_drift[name] = s["drift_t_pct"]
    return parity.compare_long(records, ref, drift, ref_drift, path)


def run_segment(pipe, frames: list, n_frames: int, warmup: int, deadline: float, log) -> dict:
    """``bench.py``'s host loop over frames 0 .. n_frames-1: the warm-up
    (frames 0, 1 and 2 drained one by one), then the steady loop, timed on
    the host clock with the device synchronised at both ends, stopped after
    any frame past ``deadline`` (``time.perf_counter``).  A capture is
    drained and synchronised at once, so the frames replayed after it are
    timed on their own as well."""
    dev = frames[0][0].device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    for i in range(warmup):
        pipe.process_frame(*frames[i])
        if i < 3:
            pipe.flush()
            log(f"frame {i} done")
    pipe.flush()
    sync()
    log("warm-up done; steady loop")
    t0 = time.perf_counter()
    t_replay, replay_from, n_done, stopped = None, None, warmup, False
    for i in range(warmup, n_frames):
        captured = len(pipe.captures)
        pipe.process_frame(*frames[i])
        n_done = i + 1
        if len(pipe.captures) > captured and replay_from is None:
            pipe.flush()
            sync()
            t_replay, replay_from = time.perf_counter(), n_done
        if n_done < n_frames and time.perf_counter() > deadline:
            stopped = True
            break
    pipe.flush()
    sync()
    t1 = time.perf_counter()
    n_replayed = n_done - replay_from if replay_from is not None else 0
    return dict(
        n_done=n_done,
        steady_s=t1 - t0,
        replayed_ms=(t1 - t_replay) / n_replayed * 1e3 if n_replayed else None,
        n_replayed=n_replayed,
        stopped=stopped,
    )


def zero_launches() -> None:
    """Set every kernel's launch count to 0 (``graphs.LAUNCH_COUNTERS``)."""
    from pfilter_tpu_torch.graphs import LAUNCH_COUNTERS

    for holder, name in LAUNCH_COUNTERS:
        setattr(holder, name, 0)


def read_launches() -> dict:
    """The kernels' launch counts: the kNN, the PCA, and the work list that
    each of their wrappers launches once per call."""
    from pfilter_tpu_torch.ops import knn_tiled, pca_radius

    return {"knn_tiled": knn_tiled.KERNEL_LAUNCHES, "pca_radius": pca_radius.KERNEL_LAUNCHES, "work_list": knn_tiled.WORK_LIST_LAUNCHES}


def run_path(mode: str, cfg, frames: list, gt: np.ndarray, n_frames: int, warmup: int, deadline: float, log, failures: list):
    """One segment of the protocol: ``make_pipeline(sync=False,
    fetch_lag=4)`` over frames 0 .. n_frames-1 (``run_segment``), scored
    (``score_protocol``) and gated: zero overflow, finite poses, drift below
    DRIFT_BAR wherever a segment scored, and on a CUDA device one capture with
    every later frame replayed, one work-list launch for each kNN or PCA
    launch and, with the default association (``assoc_once``, tiled
    index), KNN_PER_FRAME kNN launches per frame after the first.  The
    launch counts are set to 0 just before the segment and read just after
    it.  Returns ``(pipe, segment, launches, scores)``, ``launches`` as
    ``read_launches`` gives them."""
    from pfilter_tpu_torch.pipeline import make_pipeline

    pipe = make_pipeline(cfg.replace(mode=mode), device=frames[0][0].device, sync=False, fetch_lag=4)
    zero_launches()
    seg = run_segment(pipe, frames, n_frames, warmup, deadline, lambda m: log(f"{mode}: {m}"))
    launches = read_launches()
    log(f"{mode}: steady loop done ({seg['n_done']} frames); scoring")
    q, t = pipe.trajectory
    s = score_protocol(gt, q, t)
    if pipe.graphs:
        if len(pipe.captures) != 1 or pipe.replays != seg["n_replayed"] or seg["n_replayed"] == 0:
            failures.append(f"{mode}: {len(pipe.captures)} CUDA graphs captured, {pipe.replays} frames replayed (want 1 and {seg['n_replayed']})")
        want = KNN_PER_FRAME[mode] * (seg["n_done"] - 1)
        if cfg.odometry.assoc_once and cfg.capacity.knn_impl == "tiled" and launches["knn_tiled"] != want:
            failures.append(f"{mode}: {launches['knn_tiled']} kNN launches, not {want}")
    if launches["work_list"] != launches["knn_tiled"] + launches["pca_radius"]:
        failures.append(f"{mode}: launches {launches}: the work list not once per kNN and PCA launch")
    if pipe.overflow_total:
        failures.append(f"{mode}: overflow_total {pipe.overflow_total} != 0")
    if not (np.isfinite(q).all() and np.isfinite(t).all()):
        failures.append(f"{mode}: non-finite poses")
    for p in ("v1", "full"):
        if s[p]["n_segments"] and not s[p]["t_err_pct"] < DRIFT_BAR:
            failures.append(f"{mode}: {p} drift {s[p]['t_err_pct']:.4f} % not below {DRIFT_BAR}")
    return pipe, seg, launches, s


def run_windows(states, ref: dict, cfg, frames: list, log, failures: list, detail: dict) -> dict:
    """Every window of the stored reference states in ``states``
    (``states.json``'s ``windows``, one directory each): the reference's
    state restored into the port and the next WINDOW_FRAMES frames run from
    it (``parity.compare_window``), held to the reference's frames (those of
    ``ref``, ``parity.load_reference``'s runs) over the
    window's ``parity.WINDOW_LENGTHS``; on a CUDA device one capture (the
    first frame) and KNN_PER_FRAME kNN launches per frame, the counts set to
    0 just before each window and read just after it.  Failures go to
    ``failures``, each window's record to the returned dict and
    ``detail["windows"]``."""
    from pfilter_tpu_torch.utils import parity

    states = Path(states)
    windows = json.loads((states / "states.json").read_text())["windows"]
    if set(windows) != set(parity.WINDOW_LENGTHS):
        failures.append(f"windows: {states} holds {sorted(windows)}, parity.WINDOW_LENGTHS {sorted(parity.WINDOW_LENGTHS)}")
    out, detail["windows"] = {}, {}
    for name in sorted(set(windows) & set(parity.WINDOW_LENGTHS), key=lambda n: (windows[n]["path"] != "es", windows[n]["step"])):
        mode = windows[name]["path"]
        zero_launches()
        res = parity.compare_window(states / name, cfg.replace(mode=mode), frames, ref)
        launches = read_launches()
        detail["windows"][name] = res
        log(parity.summary_window(name, res))
        fails = list(res["failures"])
        n = res["all"]["frames"]
        if frames[0][0].device.type == "cuda":
            if res["captures"] != 1 or res["replays"] != n - 1:
                fails.append(f"{res['captures']} CUDA graphs captured, {res['replays']} frames replayed (want 1 and {n - 1})")
            if launches["knn_tiled"] != KNN_PER_FRAME[mode] * n:
                fails.append(f"{launches['knn_tiled']} kNN launches, not {KNN_PER_FRAME[mode] * n}")
        if launches["work_list"] != launches["knn_tiled"] + launches["pca_radius"]:
            fails.append(f"launches {launches}: the work list not once per kNN and PCA launch")
        failures.extend(f"window {name}: {f}" for f in fails)
        out[name] = {
            "path": mode, "start_frame": res["step"], "frames": n, "W": res["length"],
            "max_gap_m": res["max_gap_t_m"], "max_gap_frame": res["max_gap_t_frame"],
            "max_gap_rad": res["max_gap_rad"], "max_gap_rad_frame": res["max_gap_rad_frame"],
            "map_size_rel": res["map_size_rel"], "map_size_rel_at": res["map_size_rel_at"],
            "all_frames": {"max_gap_m": res["all"]["max_gap_t_m"], "max_gap_rad": res["all"]["max_gap_rad"], "map_size_rel": res["all"]["map_size_rel"]},
            "captures": res["captures"], "replays": res["replays"], "kernel_launches": launches, "failures": fails,
        }
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=PROTOCOL["frames"])
    ap.add_argument("--warmup", type=int, default=PROTOCOL["warmup"])
    ap.add_argument("--speed", type=float, default=PROTOCOL["speed_m_per_frame"], help="meters per frame")
    ap.add_argument("--azimuth", type=int, default=PROTOCOL["azimuth"])
    ap.add_argument("--mode", default="es", choices=("es", "bpf"), help="the first segment's pipeline")
    ap.add_argument("--no-bpf", action="store_true", help="skip the BPF segment after the ES run")
    ap.add_argument("--set", action="append", default=[], help="dotted config override k=v (kitti_config())")
    ap.add_argument("--budget-s", type=float, default=DEFAULT_BUDGET_S,
                    help="wall budget: the steady loop stops early past 85 %% of it (the BPF one past 92 %%)")
    ap.add_argument("--device", default="cuda", help="cuda (the default; never falls back) or cpu")
    ap.add_argument("--reference", default=None, help="hold both runs to these stored reference runs (.npz beside its .json)")
    ap.add_argument("--states", default=None, metavar="DIR",
                    help="after the free runs, run every window of these stored reference states (needs --reference)")
    args = ap.parse_args(argv)
    if not 1 <= args.warmup < args.frames:
        ap.error("need 1 <= --warmup < --frames")
    if args.states is not None and args.reference is None:
        ap.error("--states needs --reference")
    return args


def run_bench(args, cfg, frames: list, gt: np.ndarray, t_wall0: float, render_s: float) -> tuple[dict, dict]:
    """Run the protocol on rendered ``frames`` (``render``) and score it:
    ``(the JSON record, detail)``, detail holding each segment's
    ``parity.records_arrays`` and ``compare_long`` result."""
    from pfilter_tpu_torch.models.es_odometry import OVERFLOW_LANES
    from pfilter_tpu_torch.utils import parity

    log = lambda msg: _log(t_wall0, msg)  # noqa: E731
    ref, side = parity.load_reference(args.reference) if args.reference is not None else (None, None)
    failures: list = []
    detail: dict = {"records": {}, "parity": {}}
    reference: dict = {}

    def hold(name, pipe):
        detail["records"][name] = rec = parity.records_arrays(pipe.records)
        if ref is None:
            return
        res = hold_to_reference(rec, ref[name], side["paths"][name]["scores"], gt, name)
        detail["parity"][name] = res
        log(parity.summary_long(name, res))
        failures.extend(f"{name} against the reference: {f}" for f in res["failures"])
        reference[name] = {
            "max_gap_m": res["max_gap_t_m"], "max_gap_frame": res["max_gap_t_frame"],
            "max_gap_rad": res["max_gap_rad"], "max_gap_rad_frame": res["max_gap_rad_frame"],
            "gap_at": {str(f): g for f, g in res["gap_at"].items()},
            "drift": res["drift"], "drift_ref": res["drift_ref"],
            "overflow_frames_differing": res["overflow_frames_differing"],
            "drift_band": res["drift_band"], "map_size_rel": res["map_size_rel"], "map_size_rel_at": res["map_size_rel_at"],
            "map_mean": res.get("map_mean"), "map_mean_ref": res.get("map_mean_ref"), "map_mean_band": res.get("map_mean_band"),
            "missed": sorted(res["missed"]), "failures": res["failures"],
        }

    mode = args.mode
    pipe, seg, launches, s = run_path(mode, cfg, frames, gt, args.frames, args.warmup, t_wall0 + args.budget_s * ES_BUDGET_SHARE, log, failures)
    n_done = seg["n_done"]
    fps = (n_done - args.warmup) / seg["steady_s"]
    deviation = (
        args.frames != PROTOCOL["frames"]
        or args.warmup != PROTOCOL["warmup"]
        or args.speed != PROTOCOL["speed_m_per_frame"]
        or args.azimuth != PROTOCOL["azimuth"]
        or n_done != args.frames
        or list(s["v1_lengths"]) != [float(length) for length in PROTOCOL["lengths_m"]]
        or bool(args.set)
        or mode != "es"
        or args.no_bpf
    )
    result = {
        "metric": f"frames_per_sec_{mode}64",
        "value": fps,
        "unit": "fps",
        "vs_baseline": fps / 10.0,
        "mean_ms_per_frame": 1e3 / fps,
        "drift_t_pct": s["v1"]["t_err_pct"],
        "drift_r_deg_per_m": s["v1"]["r_err_deg_per_m"],
        "drift_t_pct_full_protocol": s["full"]["t_err_pct"],
        "drift_r_full_protocol": s["full"]["r_err_deg_per_m"],
        "full_protocol_lengths_m": [int(length) for length in s["full_lengths"]],
        "full_protocol_n_segments": s["full"]["n_segments"],
        "ate_rmse_m": s["ate"],
        "frames": n_done,
        "frames_requested": args.frames,
        "render_wall_s": render_s,
        "path_len_m": s["path"],
        "protocol_lengths_m": [int(length) for length in s["v1_lengths"]],
        "bench_protocol": {k: list(v) if isinstance(v, tuple) else v for k, v in PROTOCOL.items()},
        "protocol_deviation": deviation,
        "n_segments": s["v1"]["n_segments"],
        "n_frames_dropped": pipe.n_dropped,
        "overflow_total": pipe.overflow_total,
        "device": device_line(frames[0][0].device),
        "render_note": RENDER_NOTE,
        "captures": {mode: len(pipe.captures)},
        "replays": {mode: pipe.replays},
        "knn_launches": {mode: launches["knn_tiled"]},
        "kernel_launches": {mode: launches},
        "replayed_ms_per_frame": {mode: seg["replayed_ms"]},
        "stopped_by_budget": {mode: seg["stopped"]},
    }
    per_lane = np.stack([np.asarray(r.overflow).reshape(-1) for r in pipe.records]).sum(axis=0)
    if mode == "es":
        result["overflow_lanes"] = {name: int(v) for name, v in zip(OVERFLOW_LANES, per_lane) if v}
        result["surf_map_size"] = pipe.records[-1].surf_map_size
        result["edge_map_size"] = pipe.records[-1].edge_map_size
        result["edge_map_peak"] = max(r.edge_map_size for r in pipe.records)
        result["surf_map_peak"] = max(r.surf_map_size for r in pipe.records)
        # Frame 0 seeds the maps with the raw scan, filling the surf map to its cap.
        result["map_peaks_after_seed"] = [max((r.edge_map_size for r in pipe.records[1:]), default=0),
                                          max((r.surf_map_size for r in pipe.records[1:]), default=0)]
    else:
        result["overflow_lanes"] = per_lane.tolist()
        result["map_sizes"] = [int(x) for x in pipe.records[-1].map_sizes]
    hold(mode, pipe)
    del pipe

    if mode == "es" and not args.no_bpf:
        left = args.budget_s - (time.perf_counter() - t_wall0)
        if left < BPF_MIN_LEFT_S:
            result["bpf_skipped"] = f"budget ({left:.0f}s left)"
            log(f"skipping the BPF segment ({left:.0f}s of budget left)")
        else:
            log("ES done; BPF segment")
            n_bpf = min(int(PROTOCOL["bpf_frames"]), n_done)
            warmup = min(args.warmup, n_bpf - 1)
            bpipe, bseg, blaunches, bs = run_path("bpf", cfg, frames, gt, n_bpf, warmup, t_wall0 + args.budget_s * BPF_BUDGET_SHARE, log, failures)
            result.update(
                bpf_fps=(bseg["n_done"] - warmup) / bseg["steady_s"],
                bpf_drift_t_pct=bs["v1"]["t_err_pct"],
                bpf_drift_r_deg_per_m=bs["v1"]["r_err_deg_per_m"],
                bpf_ate_rmse_m=bs["ate"],
                bpf_frames=bseg["n_done"],
                bpf_protocol_lengths_m=[int(length) for length in bs["v1_lengths"]],
                bpf_overflow_total=bpipe.overflow_total,
                bpf_n_dropped=bpipe.n_dropped,
                bpf_map_sizes=[int(x) for x in bpipe.records[-1].map_sizes],
                bpf_map_peaks=np.stack([r.map_sizes for r in bpipe.records]).max(axis=0).tolist(),
            )
            for key, value in (("captures", len(bpipe.captures)), ("replays", bpipe.replays), ("knn_launches", blaunches["knn_tiled"]),
                               ("kernel_launches", blaunches),
                               ("replayed_ms_per_frame", bseg["replayed_ms"]), ("stopped_by_budget", bseg["stopped"])):
                result[key]["bpf"] = value
            result["protocol_deviation"] = deviation or bseg["n_done"] != n_bpf
            log(f"bpf segment done: {result['bpf_fps']:.3f} fps, drift {result['bpf_drift_t_pct']:.4f} %")
            hold("bpf", bpipe)
    if args.states is not None:
        reference["windows"] = run_windows(args.states, ref, cfg, frames, log, failures, detail)
    if ref is not None:
        result["reference"] = {"file": str(args.reference), "generator": side["generator"], "platform": side["platform"], **reference}
    result["failures"] = failures
    result["total_wall_s"] = time.perf_counter() - t_wall0
    return result, detail


def main(argv=None) -> int:
    from pfilter_tpu_torch import resolve_device
    from pfilter_tpu_torch.config import apply_dotted_overrides, kitti_config

    args = parse_args(argv)
    t_wall0 = time.perf_counter()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = kitti_config()
    if args.set:
        cfg = apply_dotted_overrides(cfg, args.set)
    _log(t_wall0, f"rendering {args.frames} scans on {dev}")
    frames, gt = render(cfg, args.frames, args.azimuth, args.speed, dev)
    render_s = time.perf_counter() - t_wall0
    _log(t_wall0, f"rendered {args.frames} scans in {render_s:.1f} s")
    result, _ = run_bench(args, cfg, frames, gt, t_wall0, render_s)
    print(json.dumps(result), flush=True)
    for f in result["failures"]:
        _log(t_wall0, f"FAILED: {f}")
    return 1 if result["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
