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


def run_path(name: str) -> tuple[dict, dict]:
    """One path of ``PATHS`` on the reference package: (arrays, record)."""
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
