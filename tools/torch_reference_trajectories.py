#!/usr/bin/env python3
"""The reference package's trajectories on scans both packages share: the
yardstick the PyTorch port (``pfilter_tpu_torch/``) is held to at full width.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tools/torch_reference_trajectories.py --workers 4

Runs ``pfilter_tpu`` (JAX, on the CPU; the sharded paths on virtual CPU
devices) at ``kitti_config()`` on the v1 city of ``bench.py``
(``make_city_world(seed=7)``, ``make_loop_trajectory(speed=1.5)``, HDL-64 at
1800 azimuth).  Each scan is rendered noise-free by the reference's renderer,
run eagerly (op by op it gives the port's renderer on the CPU bit for bit;
jitted, XLA's fusion rounds grazing rays otherwise), and gets
``shared_range_noise`` of its frame (the port's one definition, in numpy:
the port's runs add the same noise to its own renderer's scans).
Every path of ``PATHS`` runs through the reference's own entry points
(``make_pipeline``; the sharded ones through ``make_sharded_step`` at
``n_seq = 1``).

Writes ``tests/data/torch_reference_v1.npz``: for each path ``P`` and frame,
``P.q`` (wxyz) and ``P.t``, ``P.overflow`` (ES: the eight lanes of
``es_odometry.OVERFLOW_LANES``; BPF: the [3, 4] channel rows, flattened),
``P.trunc`` (BPF: the front-end's halo truncation), ``P.map_sizes`` and
``P.n_corr`` (edge, surf / beam, pillar, facade); and ``seed.*``, the first
frame's feature counts and, per shard at ``n_map = 4``, the surf and edge
features each shard owns.  The JSON sidecar beside it
(``torch_reference_v1.json``) holds the JAX version, the commit, the noise
recipe, each path's config overrides, frames, wall seconds, and its drift and
ATE scored as ``chip_smoke.run_protocol`` scores them (``scores``: at 100
frames; for ES's 850 and BPF's 300 frames also bench.py's v1 protocol and
the full 100-800 m one).

``--states`` (``JAX_PLATFORMS=cpu python
tools/torch_reference_trajectories.py --states``, ~40 min, ES and BPF at
once) re-runs the ES (850 frames) and BPF (300) paths and saves the
reference pipeline's state after the frames of ``STATE_FRAMES``
(``pfilter_tpu.utils.checkpoint.save_state``, ``step`` = frame + 1) into
``tests/data/torch_reference_states_v1/<path>_<step>/``, and
``states.json``: the generator, JAX version, commit, windows, and, per
path, whether the re-run equals the stored run of ``--out`` bit for bit
(frame by frame: ``vs_stored``).  ``utils/parity.compare_window`` resumes
the port from each state and holds it to the stored run's next WINDOW
frames; where the re-run differs from the stored run, its own next WINDOW
frames are written beside each state (``window.npz``) and used instead.

``--small-state`` (``JAX_PLATFORMS=cpu python
tools/torch_reference_trajectories.py --small-state``, ~1 min) runs the
reference's ES at ``tests/test_es_odometry.py::small_config`` widths over
SMALL_FRAMES scans of a short corridor (rendered by the port's renderer on
the CPU, ``render_shared_sequence``) and saves its state after frame
SMALL_STEP - 1 into ``tests/data/torch_reference_small_state_v1/es_<step>/``
with the run's later frames (``window.npz``), and ``small.json``, the
recipe the CPU tests render the same scans from.

``--report`` prints the stored paths' scores and the reference's own gaps
between its map-sharded runs at ``n_map`` 1, 2, 4 and its single-device
runs, held to ``utils/parity.py``'s gates.  JAX is imported inside
``main()`` only (and not for ``--report``), so that a machine without JAX
(the card's) can import this module.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pfilter_tpu_torch.utils import metrics  # noqa: E402
from pfilter_tpu_torch.utils.synthetic import make_loop_trajectory  # noqa: E402
from pfilter_tpu_torch.utils.synthetic import SHARED_NOISE_SEED, SHARED_NOISE_SIGMA, shared_range_noise  # noqa: E402

OUT = ROOT / "tests" / "data" / "torch_reference_v1.npz"
WORLD_SEED = 7
SPEED = 1.5
AZIMUTH = 1800
V1_LENGTHS = (100.0, 200.0, 300.0)
V1_FRAMES = 300  # bench.py's pinned protocol scores its first 300 frames
FULL_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
RADIUS = ("pca.impl=radius", "capacity.frontend_tile_cap=5120")

# name: (mode, dotted overrides, frames, n_map (None: the single-device pipeline))
PATHS = {
    "es": ("es", (), 850, None),
    # _pca_kernel runs in Pallas interpret mode on the CPU (~10 s a frame
    # beside three other paths): as many frames as fit in about ten minutes.
    "bpf_radius": ("bpf", RADIUS, 60, None),
    "bpf": ("bpf", (), 300, None),
    "es_per_iteration": ("es", ("odometry.assoc_once=False",), 100, None),
    "es_grid": ("es", ("capacity.knn_impl=grid",), 100, None),
    "bpf_per_iteration_fast": ("bpf", ("odometry.assoc_once=False", "ground.method=fast"), 100, None),
    "es_sharded_m1": ("es", (), 100, 1),
    "es_sharded_m2": ("es", (), 100, 2),
    "es_sharded_m4": ("es", (), 100, 4),
    "bpf_sharded_m1": ("bpf", (), 50, 1),
    "bpf_sharded_m4": ("bpf", (), 50, 4),
}
SCORE_AT = 100  # frames: the port's card runs score their first 100 (chip_smoke.py)


def noise_recipe() -> str:
    return (
        f"noise-free render (t_time = frame index), then for frame i: n ~ N(0, {SHARED_NOISE_SIGMA}) m from "
        f"np.random.default_rng({SHARED_NOISE_SEED} + i), one draw per ray, valid rays only: xyz * (1 + n / |xyz|), "
        "float32 (pfilter_tpu_torch.utils.synthetic.shared_range_noise)"
    )


def ground_truth(q, t) -> np.ndarray:
    """4x4 ground-truth poses relative to frame 0."""
    gt = metrics.poses_to_matrices(np.asarray(q), np.asarray(t))
    return np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)


def score(gt, q, t, lengths=V1_LENGTHS) -> dict:
    """Drift and ATE as ``chip_smoke.run_protocol`` scores them: every
    length of ``lengths`` the path holds, every 10 frames."""
    gt = gt[: len(t)]
    est = metrics.poses_to_matrices(q, t)
    path = float(metrics.trajectory_distances(gt)[-1])
    d = metrics.kitti_drift(gt, est, lengths=lengths, step=10)
    return dict(
        frames=len(t), drift_t_pct=d["t_err_pct"] if d["n_segments"] else None, r_err_deg_per_m=d["r_err_deg_per_m"] if d["n_segments"] else None,
        segments=d["n_segments"], lengths=[length for length in lengths if length <= path], ate_rmse_m=float(metrics.ate_rmse(gt, est)), path_m=path,
    )


def scores(q, t) -> dict:
    """A path's drift and ATE: ``"100"``, its first SCORE_AT frames (the
    card runs' length); for the longer runs also ``"v1"``, bench.py's pinned
    protocol (100-300 m over the first 300 frames), and ``"full"`` (100-800
    m over every frame)."""
    poses = make_loop_trajectory(len(t), speed=SPEED)
    gt = ground_truth(poses.q, poses.t)
    out = {str(SCORE_AT): score(gt, q[:SCORE_AT], t[:SCORE_AT])}
    if len(t) > SCORE_AT:
        out["v1"] = score(gt, q[:V1_FRAMES], t[:V1_FRAMES])
        out["full"] = score(gt, q, t, FULL_LENGTHS)
    return out


def run_path(name: str, on_frame=None) -> tuple[dict, dict]:
    """One path of ``PATHS`` on the reference package: (arrays, record).
    ``on_frame(i, pipe)``, if given, is called after each frame ``i`` of a
    single-device path."""
    import jax
    import jax.numpy as jnp

    from pfilter_tpu.config import apply_dotted_overrides, kitti_config
    from pfilter_tpu.ops import features, voxel
    from pfilter_tpu.parallel import bpf_sharded, es_sharded
    from pfilter_tpu.parallel import mesh as jmesh
    from pfilter_tpu.pipeline import make_pipeline
    from pfilter_tpu.utils import synthetic

    mode, overrides, n_frames, n_map = PATHS[name]
    cfg = apply_dotted_overrides(kitti_config().replace(mode=mode), list(overrides))
    world = synthetic.make_city_world(seed=WORLD_SEED)
    poses = synthetic.make_loop_trajectory(n_frames, speed=SPEED)
    cap = cfg.capacity.scan_points

    def scan(i):
        x, v = synthetic.render_scan(synthetic.se3.Pose(q=poses.q[i], t=poses.t[i]), world, cfg.lidar, AZIMUTH, noise=0.0, t_time=float(i))
        v = np.asarray(v)
        xyz = np.zeros((cap, 3), np.float32)
        valid = np.zeros(cap, bool)
        xyz[: len(v)], valid[: len(v)] = shared_range_noise(np.asarray(x), v, i), v
        return xyz, valid

    out, t0 = {}, time.perf_counter()
    if n_map is None:
        pipe = make_pipeline(cfg, sync=True)
        for i in range(n_frames):
            pipe.process_frame(*scan(i))
            if on_frame is not None:
                on_frame(i, pipe)
        recs = pipe.records
        out["overflow"] = np.stack([np.asarray(r.overflow).reshape(-1) for r in recs]).astype(np.int32)
        if mode == "es":
            out["n_corr"] = np.array([[r.n_edge_corr, r.n_surf_corr] for r in recs], np.int32)
            out["map_sizes"] = np.array([[r.edge_map_size, r.surf_map_size] for r in recs], np.int32)
        else:
            out["n_corr"] = np.stack([r.n_corr for r in recs]).astype(np.int32)
            out["map_sizes"] = np.stack([r.map_sizes for r in recs]).astype(np.int32)
            out["trunc"] = np.array([r.n_scan_trunc for r in recs], np.int32)
        q, t = pipe.trajectory
    else:
        module = es_sharded if mode == "es" else bpf_sharded
        mesh = jmesh.make_mesh(1, n_map)
        state = module.init_sharded_state(cfg, 1, n_map)
        first = module.make_sharded_step(cfg, mesh, first=True)
        step = module.make_sharded_step(cfg, mesh, first=False)
        qs, ts, diags = [], [], []
        for i in range(n_frames):
            xyz, valid = scan(i)
            state, diag = (first if i == 0 else step)(state, jnp.asarray(xyz[None]), jnp.asarray(valid[None]))
            qs.append(np.asarray(state.pose.q)[0])
            ts.append(np.asarray(state.pose.t)[0])
            diags.append(jax.device_get(diag))
        q, t = np.stack(qs), np.stack(ts)
        out["overflow"] = np.stack([np.asarray(d.overflow)[0].reshape(-1) for d in diags]).astype(np.int32)
        if mode == "es":
            out["n_corr"] = np.array([[d.n_edge_corr[0], d.n_surf_corr[0]] for d in diags], np.int32)
            out["map_sizes"] = np.array([[d.edge_map_size[0], d.surf_map_size[0]] for d in diags], np.int32)
        else:
            out["n_corr"] = np.stack([np.asarray(d.n_corr)[0] for d in diags]).astype(np.int32)
            out["map_sizes"] = np.stack([np.asarray(d.map_sizes)[0] for d in diags]).astype(np.int32)
    seconds = time.perf_counter() - t0
    out["q"], out["t"] = np.asarray(q, np.float32), np.asarray(t, np.float32)
    rec = dict(mode=mode, overrides=list(overrides), frames=n_frames, n_seq=1 if n_map else None, n_map=n_map, seconds=seconds,
               overflow_total=int(out["overflow"].sum() + out.get("trunc", np.zeros(1)).sum()))

    if name == "es":
        # The seed: the first frame's features as the compiled pipeline
        # extracts them, and which of them each of four shards owns.
        xyz, valid = scan(0)
        feat = jax.jit(lambda x, v: features.extract_features(x, v, cfg.lidar, cfg.features, cfg.capacity))(jnp.asarray(xyz), jnp.asarray(valid))
        o = cfg.odometry
        for kind, mask, leaf in (("edge", feat.edge_mask, o.map_resolution), ("surf", feat.surf_mask, 2.0 * o.map_resolution)):
            shard = np.asarray(voxel.spatial_hash(feat.xyz, leaf) % 4)
            m = np.asarray(mask)
            out[f"seed.{kind}_features"] = np.array(int(m.sum()), np.int32)
            out[f"seed.{kind}_owned_m4"] = np.array([int((m & (shard == k)).sum()) for k in range(4)], np.int32)
    return out, rec


def run_one(name: str, part: Path) -> None:
    arrays, rec = run_path(name)
    np.savez(part, **arrays)
    part.with_suffix(".json").write_text(json.dumps(rec))
    s = scores(arrays["q"], arrays["t"])[str(SCORE_AT)]
    print(f"{name}: {rec['frames']} frames in {rec['seconds']:.1f} s; drift {s['drift_t_pct']} % at {SCORE_AT} frames, "
          f"ATE {s['ate_rmse_m']:.4f} m, overflow {rec['overflow_total']}", flush=True)


# ``--states``: the reference's state saved after these frames of its ES and
# BPF runs (each just before a stretch where the port's own runs one ulp
# apart part: ES 304-345, 487-529, 815-849; BPF's pillar map at 286), and the
# WINDOW frames that follow each, which ``utils/parity.compare_window`` holds
# the port to when it resumes from that state.
STATE_FRAMES = {"es": (149, 294, 480, 799), "bpf": (149, 249)}
WINDOW = 50
STATES_OUT = ROOT / "tests" / "data" / "torch_reference_states_v1"
WINDOW_FIELDS = ("q", "t", "overflow", "map_sizes", "n_corr", "trunc")


def run_states(name: str, out: Path, stored: Path) -> None:
    """Re-run path ``name`` (``es`` or ``bpf``) and save the reference's
    state after each frame of ``STATE_FRAMES[name]`` into
    ``out/<name>_<step>/`` (``pfilter_tpu.utils.checkpoint.save_state``,
    ``step`` = frame + 1).  ``out/<name>.json`` records how the re-run
    compares with the stored run of ``stored``, frame by frame; where they
    differ, ``window.npz`` beside each state holds the re-run's own WINDOW
    frames from ``step`` on."""
    from pfilter_tpu.utils import checkpoint as jckpt

    def on_frame(i, pipe):
        if i in STATE_FRAMES[name]:
            jckpt.save_state(out / f"{name}_{i + 1}", pipe.state, step=i + 1, extra=dict(path=name, frame=i))

    arrays, rec = run_path(name, on_frame)
    with np.load(stored) as z:
        ref = {k.split(".", 1)[1]: z[k] for k in z.files if k.startswith(name + ".")}
    diff = {}
    for k in WINDOW_FIELDS:
        if k in arrays:
            n = min(len(arrays[k]), len(ref[k]))
            a, b = np.asarray(arrays[k])[:n], np.asarray(ref[k])[:n]
            bad = np.flatnonzero((a.reshape(len(a), -1) != b.reshape(len(b), -1)).any(axis=1))
            diff[k] = dict(frames_differing=int(bad.size), first=int(bad[0]) if bad.size else None,
                           max_abs=float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()))
    equal = all(d["frames_differing"] == 0 for d in diff.values())
    for frame in STATE_FRAMES[name]:
        step = frame + 1
        if not equal:
            np.savez_compressed(out / f"{name}_{step}" / "window.npz",
                                **{k: np.asarray(arrays[k])[step: step + WINDOW] for k in WINDOW_FIELDS if k in arrays})
    rec.update(state_frames=list(STATE_FRAMES[name]), window=WINDOW, equal_to_stored=equal, vs_stored=diff, scores=scores(arrays["q"], arrays["t"]))
    (out / f"{name}.json").write_text(json.dumps(rec))
    print(f"{name}: {rec['frames']} frames in {rec['seconds']:.1f} s; states after frames {list(STATE_FRAMES[name])}; "
          f"bit for bit the stored run: {rec['equal_to_stored']}", flush=True)


def states_main(out: Path, stored: Path, one) -> int:
    """``--states``: both paths at once, each in a process of its own, then
    the sidecar ``out/states.json``."""
    import jax

    out.mkdir(parents=True, exist_ok=True)
    if one is not None:
        run_states(one, out, stored)
        return 0

    def worker(name):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--states", str(out), "--out", str(stored), "--one", name]
        return name, subprocess.run(cmd, cwd=ROOT, env=dict(os.environ)).returncode

    with ThreadPoolExecutor(len(STATE_FRAMES)) as pool:
        codes = dict(pool.map(worker, STATE_FRAMES))
    if any(codes.values()):
        print(f"failed: {codes}", file=sys.stderr)
        return 1
    paths = {}
    for name in STATE_FRAMES:
        side = out / f"{name}.json"
        paths[name] = json.loads(side.read_text())
        side.unlink()
    sidecar = dict(
        generator="tools/torch_reference_trajectories.py --states",
        jax=jax.__version__,
        numpy=np.__version__,
        platform="cpu (JAX_PLATFORMS=cpu)",
        commit=commit(),
        config="pfilter_tpu.config.kitti_config() (mode es / bpf), the single-device pipeline (make_pipeline, sync=True)",
        world=f"make_city_world(seed={WORLD_SEED}), make_loop_trajectory(frames, speed={SPEED}), HDL-64 at {AZIMUTH} azimuth",
        noise=noise_recipe(),
        stored=str(stored.relative_to(ROOT)) if stored.is_relative_to(ROOT) else str(stored),
        layout=f"<path>_<step>/: state.npz + meta.json (pfilter_tpu.utils.checkpoint.save_state after frame step - 1, "
               f"meta step = frame + 1); the window is the stored run's frames step .. step + {WINDOW - 1}, or, where the re-run "
               f"differs from the stored run, window.npz beside the state (the re-run's frames: {', '.join(WINDOW_FIELDS)})",
        windows={f"{n}_{f + 1}": dict(path=n, step=f + 1, frames=[f + 1, f + WINDOW]) for n, fs in STATE_FRAMES.items() for f in fs},
        paths=paths,
    )
    (out / "states.json").write_text(json.dumps(sidecar, indent=1) + "\n")
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(f"wrote {out} ({size} bytes): {sorted(sidecar['windows'])}", flush=True)
    return 0


# ``--small-state``: the reference's ES at tests/test_es_odometry.py's
# small_config widths on a short corridor, its state after frame
# SMALL_STEP - 1 and its later frames: the CPU tests' window
# (tests/test_torch_parity_windows.py), so that no test runs the reference.
SMALL_OUT = ROOT / "tests" / "data" / "torch_reference_small_state_v1"
SMALL = dict(world_seed=3, corridor_len=60.0, frames=8, speed=0.8, azimuth=720, step=4)


def small_scans(lidar, recipe: dict = SMALL) -> tuple[np.ndarray, np.ndarray]:
    """The scans of ``recipe`` (``make_world(seed, corridor_len)``,
    ``make_trajectory(frames, speed)`` at ``azimuth``), rendered by the
    port's renderer on the CPU with ``shared_range_noise``: ``(xyz [F, N,
    3], valid [F, N])`` as numpy.  ``lidar``: the port's ``LidarConfig``."""
    from pfilter_tpu_torch.utils import synthetic

    world = synthetic.make_world(seed=recipe["world_seed"], corridor_len=recipe["corridor_len"])
    poses = synthetic.make_trajectory(recipe["frames"], speed=recipe["speed"])
    xyz, valid = synthetic.render_shared_sequence(world, poses, lidar, recipe["azimuth"], device="cpu")
    return xyz.numpy(), valid.numpy()


def small_state_main(out: Path) -> int:
    """``--small-state``: run the reference's ES over ``small_scans`` and
    save its state after frame SMALL["step"] - 1 into ``out/es_<step>/``
    with ``window.npz`` (the run's frames from ``step`` on), and
    ``out/small.json``."""
    import jax
    from pfilter_tpu.pipeline import ESPipeline
    from pfilter_tpu.utils import checkpoint as jckpt
    from tests.test_es_odometry import small_config
    from tests.torch_parity import torch_config

    from pfilter_tpu_torch.utils import parity

    cfg = small_config()
    xyz, valid = small_scans(torch_config(cfg).lidar)
    step, name = SMALL["step"], f"es_{SMALL['step']}"
    pipe = ESPipeline(cfg=cfg)
    for i in range(SMALL["frames"]):
        pipe.process_frame(xyz[i], valid[i])
        if i == step - 1:
            jckpt.save_state(out / name, pipe.state, step=step, extra=dict(path="es", frame=i))
    run = parity.records_arrays(pipe.records)
    np.savez_compressed(out / name / "window.npz", **{k: v[step:] for k, v in run.items()})
    (out / "small.json").write_text(json.dumps(dict(
        generator="tools/torch_reference_trajectories.py --small-state", jax=jax.__version__, numpy=np.__version__,
        platform="cpu (JAX_PLATFORMS=cpu)", commit=commit(),
        config="tests/test_es_odometry.py::small_config(), pfilter_tpu.pipeline.ESPipeline",
        scans="pfilter_tpu_torch.utils.synthetic: make_world(seed=world_seed, corridor_len), make_trajectory(frames, speed), "
              "render_shared_sequence at azimuth on the CPU (tools/torch_reference_trajectories.py small_scans)",
        recipe=SMALL, state=name, window=f"{name}/window.npz: the run's frames {step} .. {SMALL['frames'] - 1}",
    ), indent=1) + "\n")
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(f"wrote {out} ({size} bytes)", flush=True)
    return 0


# The reference against itself (``--report``): each map-sharded run against
# the run at n_map = 1, and that against the single-device pipeline.
SELF_PAIRS = (
    ("es_sharded_m1", "es"),
    ("es_sharded_m2", "es_sharded_m1"),
    ("es_sharded_m4", "es_sharded_m1"),
    ("bpf_sharded_m1", "bpf"),
    ("bpf_sharded_m4", "bpf_sharded_m1"),
)


def report(path) -> None:
    """Print each stored path's scores, and the reference's own gaps between
    the runs of ``SELF_PAIRS`` held to ``utils/parity.py``'s gates (no JAX)."""
    from pfilter_tpu_torch.utils import parity

    runs, side = parity.load_reference(path)
    for name, rec in side["paths"].items():
        scores = "; ".join(f"{k} ({v['frames']} frames): drift {v['drift_t_pct']} %, ATE {v['ate_rmse_m']:.4f} m" for k, v in rec["scores"].items())
        print(f"{name}: {rec['frames']} frames, {rec['seconds']:.1f} s; {scores}")
    for a, b in SELF_PAIRS:
        k = min(len(runs[a]["t"]), len(runs[b]["t"]))
        scored = k >= parity.SCORE_AT
        drift = [side["paths"][n]["scores"][str(parity.SCORE_AT)]["drift_t_pct"] if scored else None for n in (a, b)]
        res = parity.compare(runs[a], runs[b], *drift)
        print("reference " + parity.summary(f"{a} vs {b}", res))
        print(f"  {a} vs {b} gap per frame, cm: " + " ".join(f"{g * 100:.2f}" for g in res["gap_t_m"]))


def commit() -> dict:
    def git(*args):
        r = subprocess.run(["git", *args], cwd=ROOT, capture_output=True, text=True)
        return r.stdout if r.returncode == 0 else ""

    status = git("status", "--porcelain", "--", "pfilter_tpu", "pfilter_tpu_torch", "tools/torch_reference_trajectories.py")
    return dict(head=git("rev-parse", "HEAD").strip() or None, uncommitted=sorted(line[3:] for line in status.splitlines()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", nargs="*", default=list(PATHS), help="paths to run (default: all)")
    ap.add_argument("--workers", type=int, default=1, help="paths run at once, each in a process of its own")
    ap.add_argument("--parts", default=None, help="directory for each path's results (default: a temporary one)")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--report", action="store_true", help="print the stored paths' scores and the reference's own sharded gaps")
    ap.add_argument("--states", nargs="?", const=str(STATES_OUT), default=None, metavar="DIR",
                    help=f"re-run ES and BPF, saving the reference's state after the frames of STATE_FRAMES into DIR "
                         f"(default {STATES_OUT.relative_to(ROOT)}), checked against the stored runs of --out")
    ap.add_argument("--small-state", nargs="?", const=str(SMALL_OUT), default=None, metavar="DIR",
                    help=f"save the reference's ES state of a short small-config run into DIR (default {SMALL_OUT.relative_to(ROOT)})")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)  # a worker: run this path into --parts
    args = ap.parse_args(argv)
    if args.report:
        report(args.out)
        return 0
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = Path(args.out)
    if args.states is not None:
        return states_main(Path(args.states).resolve(), out.resolve(), args.one)
    if args.small_state is not None:
        return small_state_main(Path(args.small_state).resolve())
    scratch = tempfile.TemporaryDirectory() if args.parts is None else None
    parts = Path(args.parts) if args.parts else Path(scratch.name)
    parts.mkdir(parents=True, exist_ok=True)
    if args.one is not None:
        run_one(args.one, parts / f"{args.one}.npz")
        return 0

    def worker(name):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one", name, "--parts", str(parts), "--out", str(out)]
        return name, subprocess.run(cmd, cwd=ROOT, env=dict(os.environ)).returncode

    with ThreadPoolExecutor(max(1, args.workers)) as pool:
        codes = dict(pool.map(worker, args.paths))
    failed = [n for n, c in codes.items() if c != 0]
    if failed:
        print(f"failed: {failed}", file=sys.stderr)
        return 1
    arrays, paths = {}, {}
    for name in PATHS:
        part = parts / f"{name}.npz"
        if not part.exists():
            continue
        with np.load(part) as z:
            arrays.update({f"{name}.{k}" if not k.startswith("seed.") else k: z[k] for k in z.files})
            paths[name] = json.loads(part.with_suffix(".json").read_text())
            paths[name]["scores"] = scores(z["q"], z["t"])
    np.savez_compressed(out, **arrays)
    sidecar = dict(
        generator="tools/torch_reference_trajectories.py",
        jax=jax.__version__,
        numpy=np.__version__,
        platform="cpu (JAX_PLATFORMS=cpu; sharded paths on --xla_force_host_platform_device_count=8 virtual devices)",
        commit=commit(),
        config="pfilter_tpu.config.kitti_config() with each path's dotted overrides",
        world=f"make_city_world(seed={WORLD_SEED}), make_loop_trajectory(frames, speed={SPEED}), HDL-64 at {AZIMUTH} azimuth",
        noise=noise_recipe(),
        score=f"chip_smoke.run_protocol's: drift over the lengths of {V1_LENGTHS} m the path holds, every 10 frames, and ATE "
              f"RMSE, ground truth relative to frame 0; '{SCORE_AT}': the first {SCORE_AT} frames; the longer runs also 'v1' "
              f"(bench.py's: the first {V1_FRAMES} frames) and 'full' (every frame, lengths {FULL_LENGTHS} m)",
        paths=paths,
    )
    out.with_suffix(".json").write_text(json.dumps(sidecar, indent=1) + "\n")
    print(f"wrote {out} ({out.stat().st_size} bytes) and {out.with_suffix('.json').name}: {sorted(paths)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
