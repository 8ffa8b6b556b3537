"""The port held to the reference package's own trajectories at full width.

``tests/data/torch_reference_v1.npz`` (written by
``tools/torch_reference_trajectories.py``, which runs ``pfilter_tpu`` on the
CPU) holds, for every path, the reference's poses, overflow lanes, map sizes
and correspondence counts per frame on the v1 city's shared scans
(``synthetic.render_shared_sequence``), and its sidecar the reference's drift
and ATE.  ``compare`` holds a port run of the same path on the same scans to
them with the gates below, stated before any full-width run was read:

- frames 0 .. COLD_FRAMES-1 within COLD_TOL_M / COLD_TOL_RAD, the ES slice's
  cold-start tolerance (``tests/test_torch_es.py``);
- every frame within TOL_M / TOL_RAD;
- the overflow lanes equal on every frame;
- every map's size within MAP_SIZE_TOL of the reference's on every frame;
- the drift at ``SCORE_AT`` frames within DRIFT_TOL_POINTS percentage points
  of the reference's (where the path holds a 100 m segment).

Frames are numbered from 0 throughout; ``gap_at[f]`` is the gap after ``f``
frames, i.e. at frame ``f - 1``.

``compare_long`` holds a free run of the bench protocol (up to 850 ES or
300 BPF frames, ``pfilter_tpu_torch.bench``) to the stored run of its path,
with the gates a chaotic run can hold.  Past the loop's corners (ES frames
304-345, 487-529, 815-849) two of the port's own runs one float32 ulp of
pose apart part by metres, so no per-frame pose or map-size bound holds
between two implementations that are not bit for bit alike; the free run
keeps:

- frames 0 .. SCORE_AT-1 with every gate of ``compare`` (``head``);
- every frame: finite poses, and the overflow lanes equal;
- the drift under each protocol scored (v1: 100-300 m over the first 300
  frames; full: 100-800 m over every frame) within ``LONG_DRIFT_BAND`` of
  the reference's;
- each map's mean size over frames SCORE_AT .. the end within
  ``LONG_MAP_MEAN_BAND`` of the reference's.

Each band is ``band(x) = BAND_SIGMAS * sqrt(2) * s``, ``s`` the sample
standard deviation (n - 1) of that measure over the port's own ensemble on
the card: the kernel run and runs with the pose nudged one ulp along each
of 12 directions (``nudge_pose``) after frame 5 and, again, after frame 8,
every run distinct (a run equal bit for bit to an earlier one is dropped and
a nudge after frame 7 taken instead; ``tools/torch_knn_packed_keys_ab.py
--ensemble``; the values per run are in
``tests/data/torch_port_spread_v1.json``).  If the port and the reference
are two draws from the same spread, their difference has standard deviation
``sqrt(2) * s``; three of those cover 99.7 %.

Poses and map sizes at depth are held by the windows instead:
``compare_window`` restores the reference's own state after frame ``step -
1`` (``tools/torch_reference_trajectories.py --states``) into the port and
runs the port's pipeline from there on the same scans, held to the
reference's next frames with ``compare``'s gates (no drift), the window's
first frame counted as frame 0, over the first ``WINDOW_LENGTHS[name]``
frames: the frames over which 12 nudged resumes of the port stay within
half of those gates of the un-nudged resume (measured on the card, see
there).

Each gate missed is named in ``missed`` (``"head"``, ``"finite"``,
``"overflow"``, ``"drift_v1"``, ``"drift_full"``, ``"map_mean"``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

COLD_FRAMES = 10
COLD_TOL_M = 1e-2
COLD_TOL_RAD = 2e-3
TOL_M = 5e-2
TOL_RAD = 5e-3
MAP_SIZE_TOL = 0.05
DRIFT_TOL_POINTS = 0.02
SCORE_AT = 100
REPORT_FRAMES = (10, 50, 100)  # the gaps logged after this many frames (when the run reaches them)
LONG_REPORT_FRAMES = (10, 50, 100, 300, 850)
BAND_SIGMAS = 3.0
# band() of each measure over the port's ensemble on the card (25 distinct
# runs a path on an NVIDIA H100 80GB HBM3 at 700.00 W; the values per run are in
# tests/data/torch_port_spread_v1.json, and tests/test_torch_parity_windows.py
# checks the derivation): drift, percentage points, per protocol; each map's
# mean size over frames SCORE_AT .. the end, points (ES: edge, surf; BPF:
# beam, pillar, facade).
LONG_DRIFT_BAND = {
    "es": {"v1": 0.0076677461186688495, "full": 0.10086357002124592},
    "bpf": {"v1": 0.012079886449022205, "full": 0.010901589164795588},
}
LONG_MAP_MEAN_BAND = {
    "es": (198.58394800439734, 208.56422027644075),
    "bpf": (38.335205157922424, 28.877905386298377, 81.6094691013243),
}
# The windows: the reference's state after frame step - 1 (directory
# "<path>_<step>"), WINDOW_FRAMES frames run from it, the first
# WINDOW_LENGTHS[name] of them gated.  Each length is the most frames over
# which 12 resumes nudged one ulp (NUDGES) stay within WINDOW_SPREAD_SHARE of
# compare's gates of the un-nudged resume, and at least COLD_FRAMES.
WINDOW_FRAMES = 50
WINDOW_SPREAD_SHARE = 0.5
# Measured with tools/torch_knn_packed_keys_ab.py --windows on an NVIDIA H100
# 80GB HBM3 at 700.00 W (nvidia-smi's name and power limit).
WINDOW_LENGTHS = {"es_150": 50, "es_295": 50, "es_481": 50, "es_800": 36, "bpf_150": 50, "bpf_250": 42}
# One float32 ulp of the pose: of the translation (x, y, z) and of the
# rotation quaternion's vector part (qx, qy, qz), up and down.
NUDGES = tuple(f"nudge_{part}{axis}{sign}" for part in ("", "q") for axis in "xyz" for sign in "+-")


def load_reference(path) -> tuple[dict, dict]:
    """``({path name: {field: array}}, sidecar)`` of the stored reference
    trajectories ``path`` (an ``.npz`` beside its ``.json`` sidecar)."""
    path = Path(path)
    runs: dict = {}
    with np.load(path) as z:
        for key in z.files:
            name, field = key.rsplit(".", 1)
            runs.setdefault(name, {})[field] = z[key]
    return runs, json.loads(path.with_suffix(".json").read_text())


def rotation_angle(q1, q2) -> np.ndarray:
    """Angle (rad) of the relative rotation between wxyz quaternions, per row."""
    a, b = np.asarray(q1, np.float64), np.asarray(q2, np.float64)
    w = np.sum(a * b, axis=-1)  # real part of conj(a) * b
    v = a[..., :1] * b[..., 1:] - b[..., :1] * a[..., 1:] - np.cross(a[..., 1:], b[..., 1:])
    return 2.0 * np.arctan2(np.linalg.norm(v, axis=-1), np.abs(w))


def pose_gaps(q, t, ref_q, ref_t) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame position (m) and rotation (rad) gaps over the frames both hold."""
    k = min(len(t), len(ref_t))
    return np.linalg.norm(np.asarray(t[:k], np.float64) - np.asarray(ref_t[:k], np.float64), axis=1), rotation_angle(q[:k], ref_q[:k])


def records_arrays(records) -> dict:
    """Per-frame ``q``, ``t``, ``overflow`` (flattened lanes), ``map_sizes``
    and ``n_corr`` of an ES or BPF pipeline's records (and ``trunc``, BPF's
    front-end truncation), in the stored reference's layout."""
    out = dict(
        q=np.stack([r.pose_q for r in records]),
        t=np.stack([r.pose_t for r in records]),
        overflow=np.stack([np.asarray(r.overflow).reshape(-1) for r in records]).astype(np.int64),
    )
    if hasattr(records[0], "n_corr"):
        out["n_corr"] = np.stack([np.asarray(r.n_corr) for r in records]).astype(np.int64)
        out["map_sizes"] = np.stack([np.asarray(r.map_sizes) for r in records]).astype(np.int64)
        out["trunc"] = np.array([r.n_scan_trunc for r in records], np.int64)
    else:
        out["n_corr"] = np.array([[r.n_edge_corr, r.n_surf_corr] for r in records], np.int64)
        out["map_sizes"] = np.array([[r.edge_map_size, r.surf_map_size] for r in records], np.int64)
    return out


def compare(run: dict, ref: dict, drift=None, ref_drift=None) -> dict:
    """Hold ``run`` (``records_arrays`` of a port run) to ``ref`` (one path
    of ``load_reference``) over the frames both hold; ``drift`` and
    ``ref_drift``: both runs' drift at SCORE_AT frames (None where not
    scored).  Returns the per-frame gaps, their summary and ``failures``, a
    list of the gates missed (empty: every gate held)."""
    gap_t, gap_r = pose_gaps(run["q"], run["t"], ref["q"], ref["t"])
    k = len(gap_t)
    out = dict(frames=k, gap_t_m=gap_t, gap_rad=gap_r)
    out["max_gap_t_m"], out["max_gap_t_frame"] = float(gap_t.max()), int(gap_t.argmax())
    out["max_gap_rad"], out["max_gap_rad_frame"] = float(gap_r.max()), int(gap_r.argmax())
    out["gap_at"] = {f: [float(gap_t[f - 1]), float(gap_r[f - 1])] for f in REPORT_FRAMES if f <= k}
    cold = slice(0, min(COLD_FRAMES, k))
    out["cold_gap_t_m"], out["cold_gap_rad"] = float(gap_t[cold].max()), float(gap_r[cold].max())
    failures = []
    if not (np.isfinite(gap_t).all() and np.isfinite(gap_r).all()):
        failures.append("non-finite poses")
    if out["cold_gap_t_m"] > COLD_TOL_M or out["cold_gap_rad"] > COLD_TOL_RAD:
        failures.append(f"frames 0-{cold.stop - 1}: gap {out['cold_gap_t_m']:.4g} m / {out['cold_gap_rad']:.4g} rad "
                        f"over {COLD_TOL_M} m / {COLD_TOL_RAD} rad")
    if out["max_gap_t_m"] > TOL_M or out["max_gap_rad"] > TOL_RAD:
        failures.append(f"gap {out['max_gap_t_m']:.4g} m (frame {out['max_gap_t_frame']}) / {out['max_gap_rad']:.4g} rad "
                        f"(frame {out['max_gap_rad_frame']}) over {TOL_M} m / {TOL_RAD} rad")
    ov, ov_ref = np.asarray(run["overflow"][:k]), np.asarray(ref["overflow"][:k])
    if "trunc" in ref and "trunc" in run:  # BPF's front-end truncation (the sharded reference reports none)
        ov = np.concatenate([ov, np.asarray(run["trunc"][:k])[:, None]], 1)
        ov_ref = np.concatenate([ov_ref, np.asarray(ref["trunc"][:k])[:, None]], 1)
    bad = np.flatnonzero((ov != ov_ref).any(axis=1))
    out["overflow_frames_differing"] = bad.tolist()
    out["overflow_total"], out["overflow_total_ref"] = int(ov.sum()), int(ov_ref.sum())
    if bad.size:
        failures.append(f"overflow lanes differ on frames {bad.tolist()[:10]}")
    sizes, sizes_ref = np.asarray(run["map_sizes"][:k], np.float64), np.asarray(ref["map_sizes"][:k], np.float64)
    rel = np.abs(sizes - sizes_ref) / np.maximum(sizes_ref, 1.0)
    out["map_size_rel"] = float(rel.max())
    out["map_size_rel_at"] = [int(x) for x in np.unravel_index(int(rel.argmax()), rel.shape)]  # (frame, map)
    if out["map_size_rel"] > MAP_SIZE_TOL:
        f, m = out["map_size_rel_at"]
        failures.append(f"map {m} size {int(sizes[f, m])} vs {int(sizes_ref[f, m])} on frame {f} ({out['map_size_rel']:.2%} > {MAP_SIZE_TOL:.0%})")
    corr, corr_ref = np.asarray(run["n_corr"][:k], np.float64), np.asarray(ref["n_corr"][:k], np.float64)
    out["n_corr_rel"] = float((np.abs(corr - corr_ref) / np.maximum(corr_ref, 1.0)).max())
    out["drift"], out["drift_ref"] = drift, ref_drift
    if drift is not None and ref_drift is not None and np.isfinite(ref_drift):
        out["drift_gap_points"] = abs(drift - ref_drift)
        if not out["drift_gap_points"] <= DRIFT_TOL_POINTS:
            failures.append(f"drift {drift:.4f} % vs the reference's {ref_drift:.4f} % (> {DRIFT_TOL_POINTS} points)")
    out["failures"] = failures
    return out


def _first(arrays: dict, n: int) -> dict:
    """The first ``n`` frames of every per-frame array."""
    return {k: np.asarray(v)[:n] for k, v in arrays.items() if np.ndim(v)}


def band(values) -> float:
    """``BAND_SIGMAS * sqrt(2) * s``, ``s`` the sample standard deviation
    (n - 1) of ``values``: the bound on ``|port - reference|`` for a measure
    that spreads as ``values`` across the port's own runs."""
    return BAND_SIGMAS * float(np.sqrt(2.0)) * float(np.std(np.asarray(values, np.float64), ddof=1))


def standing(values, ref_value) -> dict:
    """Where ``ref_value`` stands among ``values`` (the port's ensemble):
    ``z = (ref - mean) / s`` and its rank among the n + 1 values (1: the
    smallest)."""
    v = np.asarray(values, np.float64)
    s = float(np.std(v, ddof=1))
    return dict(n=int(v.size), mean=float(v.mean()), s=s, z=(float(ref_value) - float(v.mean())) / s if s > 0 else float("inf"),
                rank=int((v < ref_value).sum()) + 1, of=int(v.size) + 1, min=float(v.min()), max=float(v.max()))


def map_means(run: dict, start: int = SCORE_AT) -> np.ndarray:
    """Each map's mean size over frames ``start`` .. the end."""
    return np.asarray(run["map_sizes"], np.float64)[start:].mean(axis=0)


def spread_bands(spread: dict) -> dict:
    """``{path: {"drift": {protocol: band}, "map_mean": [band per map]}}``
    of a spread record (``tests/data/torch_port_spread_v1.json``: per path,
    ``runs`` maps each distinct run's name to its ``drift`` per protocol and
    its ``map_mean`` per map)."""
    out = {}
    for path, rec in spread["paths"].items():
        runs = list(rec["runs"].values())
        out[path] = {"drift": {p: band([r["drift"][p] for r in runs]) for p in runs[0]["drift"]},
                     "map_mean": [band([r["map_mean"][m] for r in runs]) for m in range(len(runs[0]["map_mean"]))]}
    return out


def compare_long(run: dict, ref: dict, drift: dict, ref_drift: dict, path: str) -> dict:
    """Hold a bench-protocol free run ``run`` (``records_arrays``) of path
    ``path`` ("es" or "bpf") to the stored run ``ref`` of that path over the
    frames both hold, with the gates of the module's docstring and the
    path's bands.  ``drift`` and ``ref_drift`` map a protocol name (``"100"``:
    the first SCORE_AT frames, the gate of ``compare``; ``"v1"``; ``"full"``)
    to that run's drift, % (absent or None: not scored).  Returns
    ``compare``'s record of the whole run without its failures (the
    per-frame gaps and map sizes are logged, not gated), ``head``
    (``compare`` over frames 0 .. SCORE_AT-1), ``gap_at`` after
    LONG_REPORT_FRAMES frames, the map means, ``missed`` (gate name -> what
    missed it) and ``failures``, its messages (empty: every gate held)."""
    head = compare(_first(run, SCORE_AT), _first(ref, SCORE_AT), drift.get(str(SCORE_AT)), ref_drift.get(str(SCORE_AT)))
    out = {k: v for k, v in compare(run, ref).items() if k not in ("failures", "gap_at", "drift", "drift_ref")}
    k = out["frames"]
    out["gap_at"] = {f: [float(out["gap_t_m"][f - 1]), float(out["gap_rad"][f - 1])] for f in LONG_REPORT_FRAMES if f <= k}
    out["head"] = head
    missed = {}
    if head["failures"]:
        missed["head"] = f"first {min(SCORE_AT, k)} frames: " + " | ".join(head["failures"])
    if not (np.isfinite(out["gap_t_m"]).all() and np.isfinite(out["gap_rad"]).all()):
        missed["finite"] = "non-finite poses"
    if out["overflow_frames_differing"]:
        missed["overflow"] = f"overflow lanes differ on frames {out['overflow_frames_differing'][:10]}"
    out["drift"], out["drift_ref"], out["drift_gap_points"], out["drift_band"] = {}, {}, {}, {}
    for name, tol in LONG_DRIFT_BAND[path].items():
        d, r = drift.get(name), ref_drift.get(name)
        if d is None or r is None or not np.isfinite(r):
            continue
        out["drift"][name], out["drift_ref"][name], out["drift_band"][name] = d, r, tol
        out["drift_gap_points"][name] = abs(d - r)
        if not abs(d - r) <= tol:
            missed[f"drift_{name}"] = f"{name} drift {d:.4f} % vs the reference's {r:.4f} % (> {tol:.4f} points)"
    if k > SCORE_AT:
        mean, mean_ref = map_means(_first(run, k)), map_means(_first(ref, k))
        out["map_mean"], out["map_mean_ref"], out["map_mean_band"] = mean.tolist(), mean_ref.tolist(), list(LONG_MAP_MEAN_BAND[path])
        out["map_mean_gap"] = np.abs(mean - mean_ref).tolist()
        over = [m for m, (g, tol) in enumerate(zip(out["map_mean_gap"], LONG_MAP_MEAN_BAND[path])) if not g <= tol]
        if over:
            missed["map_mean"] = "; ".join(f"map {m} mean size over frames {SCORE_AT}-{k - 1} {mean[m]:.1f} vs the reference's "
                                           f"{mean_ref[m]:.1f} (> {LONG_MAP_MEAN_BAND[path][m]:.1f})" for m in over)
    out["missed"] = missed
    out["failures"] = list(missed.values())
    return out


def summary_long(name: str, res: dict) -> str:
    """One log line of a ``compare_long`` result."""
    at = "".join(f"after {f} frames: {g[0] * 100:.3f} cm / {g[1] * 1e3:.3f} mrad; " for f, g in res["gap_at"].items())
    drift = "".join(f"; {p} drift {res['drift'][p]:.4f} % vs {res['drift_ref'][p]:.4f} % ({res['drift_gap_points'][p]:.4f} points"
                    f"{'' if 'drift_band' not in res else ', band %.4f' % res['drift_band'][p]})" for p in res["drift"])
    means = ""
    if "map_mean" in res:
        means = "; map means " + ", ".join(f"{a:.1f} vs {b:.1f}" for a, b in zip(res["map_mean"], res["map_mean_ref"]))
        if "map_mean_band" in res:
            means += " (bands " + ", ".join(f"{b:.1f}" for b in res["map_mean_band"]) + ")"
    return (f"{name}: {res['frames']} frames; largest gap {res['max_gap_t_m'] * 100:.3f} cm (frame {res['max_gap_t_frame']}), "
            f"{res['max_gap_rad'] * 1e3:.3f} mrad (frame {res['max_gap_rad_frame']}); {at}overflow {res['overflow_total']} vs "
            f"{res['overflow_total_ref']} (frames differing {len(res['overflow_frames_differing'])}); map sizes within "
            f"{res['map_size_rel']:.2%} (frame, map {res['map_size_rel_at']}){means}{drift}; "
            f"{'every gate held' if not res['failures'] else 'FAILED: ' + ' | '.join(res['failures'])}")


def nudge_pose(state, variant: str):
    """``state`` (``ESState`` or ``BPFState``) with one coordinate of its
    pose moved one float32 ulp: ``nudge_x+`` .. ``nudge_z-`` the
    translation, ``nudge_qx+`` .. ``nudge_qz-`` the rotation quaternion's
    vector part (wxyz: components 1-3), toward the sign."""
    if variant not in NUDGES:
        raise ValueError(f"unknown nudge {variant!r}: one of {NUDGES}")
    axis, up = "xyz".index(variant[-2]), variant[-1] == "+"
    rot = variant[-3] == "q"
    x = (state.pose.q if rot else state.pose.t).clone()
    i = axis + 1 if rot else axis
    x[i] = torch.nextafter(x[i], torch.tensor(float("inf") if up else float("-inf"), device=x.device))
    return state._replace(pose=state.pose._replace(q=x) if rot else state.pose._replace(t=x))


def run_window(state_dir, cfg, scans: list, n_frames: int = WINDOW_FRAMES, nudge=None, device=None) -> tuple[dict, object, dict]:
    """Restore the reference's state stored in ``state_dir``
    (``tools/torch_reference_trajectories.py --states``: ``state.npz`` +
    ``meta.json``, the reference's checkpoint layout) into a fresh port state
    of ``cfg`` (``cfg.mode`` the state's path) and run the port's own
    pipeline from it (``make_pipeline(cfg, state=..., sync=False,
    fetch_lag=4)``; on a CUDA device its first frame captures the CUDA graph
    every later frame replays) over ``scans[step : step + n_frames]``
    (``step`` from the checkpoint), the pose moved by ``nudge_pose(...,
    nudge)`` first where ``nudge`` is given.  Returns the run's
    ``records_arrays``, the pipeline and the checkpoint's meta."""
    from pfilter_tpu_torch.models import bpf_odometry, es_odometry
    from pfilter_tpu_torch.pipeline import make_pipeline
    from pfilter_tpu_torch.utils import checkpoint

    dev = scans[0][0].device if device is None else torch.device(device)
    template = (es_odometry if cfg.mode == "es" else bpf_odometry).init_state(cfg, device=dev)
    state, meta = checkpoint.restore_state(state_dir, template)
    if meta["restored_from_template"]:
        raise ValueError(f"{state_dir}: leaves {meta['restored_from_template']} fell back to the template")
    if nudge is not None:
        state = nudge_pose(state, nudge)
    step = int(meta["step"])
    if step + n_frames > len(scans):
        raise ValueError(f"{state_dir}: the window needs scans {step}-{step + n_frames - 1}, {len(scans)} given")
    pipe = make_pipeline(cfg, device=dev, state=state, sync=False, fetch_lag=4)
    for scan in scans[step : step + n_frames]:
        pipe.process_frame(*scan)
    pipe.flush()
    return records_arrays(pipe.records), pipe, meta


def load_window(state_dir, reference: dict) -> dict:
    """The reference's own WINDOW_FRAMES frames after the state stored in
    ``state_dir``: frames ``step`` on of its path in ``reference``
    (``load_reference``'s runs), which the run that saved the state equals
    bit for bit, or ``window.npz`` beside the state, where the tool stored
    the frames of a run that differs from them."""
    state_dir = Path(state_dir)
    if (state_dir / "window.npz").exists():
        with np.load(state_dir / "window.npz") as z:
            return {k: z[k] for k in z.files}
    meta = json.loads((state_dir / "meta.json").read_text())
    step = int(meta["step"])
    return {k: np.asarray(v)[step : step + WINDOW_FRAMES] for k, v in reference[meta["extra"]["path"]].items()}


def hold_window(run: dict, ref: dict, w: int) -> dict:
    """``compare`` (no drift) of a window's first ``w`` frames against the
    reference's frames after the same state, the window's first frame counted
    as frame 0; ``all``: the same over every frame both hold, logged, not
    gated."""
    out = compare(_first(run, w), _first(ref, w))
    out["length"] = w
    out["all"] = {k: v for k, v in compare(run, ref).items() if k not in ("failures",)}
    return out


def compare_window(state_dir, cfg, scans: list, reference: dict, w=None, device=None) -> dict:
    """Run the window of ``state_dir`` (``run_window``, WINDOW_FRAMES frames)
    and hold it to the reference's frames there (``load_window`` of
    ``reference``, ``hold_window``) over its first ``w`` frames (default
    ``WINDOW_LENGTHS`` of the directory's name).  Returns ``hold_window``'s
    record with ``step``, ``records``, the pipeline's ``captures`` and
    ``replays``."""
    state_dir = Path(state_dir)
    ref = load_window(state_dir, reference)
    w = WINDOW_LENGTHS[state_dir.name] if w is None else int(w)
    run, pipe, meta = run_window(state_dir, cfg, scans, n_frames=min(WINDOW_FRAMES, len(ref["t"])), device=device)
    out = hold_window(run, ref, w)
    out.update(step=int(meta["step"]), records=run, captures=len(pipe.captures), replays=pipe.replays)
    return out


def window_length(base: dict, nudged: list, share: float = WINDOW_SPREAD_SHARE, floor: int = COLD_FRAMES) -> tuple[int, int]:
    """``(W, measured)``: ``measured`` is the most frames ``w`` over which
    every run of ``nudged`` stays within ``share`` of ``compare``'s per-frame
    gates (TOL_M, TOL_RAD, MAP_SIZE_TOL) of ``base``; ``W`` is that, at least
    ``floor``."""
    k = min([len(base["t"])] + [len(r["t"]) for r in nudged])
    ok = np.ones(k, bool)
    for r in nudged:
        gt, gr = pose_gaps(r["q"], r["t"], base["q"], base["t"])
        a, b = np.asarray(r["map_sizes"][:k], np.float64), np.asarray(base["map_sizes"][:k], np.float64)
        rel = (np.abs(a - b) / np.maximum(b, 1.0)).max(axis=1)
        ok &= (gt[:k] <= share * TOL_M) & (gr[:k] <= share * TOL_RAD) & (rel <= share * MAP_SIZE_TOL)
    measured = int(np.argmin(ok)) if not ok.all() else k
    return max(measured, floor), measured


def summary_window(name: str, res: dict) -> str:
    """One log line of a ``compare_window`` result."""
    a = res["all"]
    head = f"window {name} (frames {res['step']}-{res['step'] + a['frames'] - 1}, gated over the first {res['length']})"
    return (summary(head, res) + f"; over all {a['frames']} frames: largest gap {a['max_gap_t_m'] * 100:.3f} cm (frame "
            f"{a['max_gap_t_frame']}), {a['max_gap_rad']:.2e} rad, map sizes within {a['map_size_rel']:.2%}")


def summary(name: str, res: dict) -> str:
    """One log line of a ``compare`` result."""
    at = "".join(f"after {f} frames: {g[0] * 100:.3f} cm / {g[1]:.2e} rad; " for f, g in res["gap_at"].items())
    drift = ""
    if res.get("drift_gap_points") is not None:
        drift = f"; drift {res['drift']:.4f} % vs {res['drift_ref']:.4f} % ({res['drift_gap_points']:.4f} points)"
    return (f"{name}: {res['frames']} frames; largest gap {res['max_gap_t_m'] * 100:.3f} cm (frame {res['max_gap_t_frame']}), "
            f"{res['max_gap_rad']:.2e} rad (frame {res['max_gap_rad_frame']}); frames 0-{COLD_FRAMES - 1} {res['cold_gap_t_m'] * 100:.3f} cm / "
            f"{res['cold_gap_rad']:.2e} rad; {at}overflow {res['overflow_total']} vs {res['overflow_total_ref']} "
            f"(frames differing {len(res['overflow_frames_differing'])}); map sizes within {res['map_size_rel']:.2%} "
            f"(frame, map {res['map_size_rel_at']}); correspondences within {res['n_corr_rel']:.2%}{drift}; "
            f"{'every gate held' if not res['failures'] else 'FAILED: ' + ' | '.join(res['failures'])}")
