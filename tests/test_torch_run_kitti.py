"""The port's KITTI runner (``python -m pfilter_tpu_torch.run_kitti``)
against ``tools/run_kitti.py``: ``run_sequence`` on the same 3 scans in
both (result keys, trajectory file, per-frame JSONL, global map artifacts),
and ``main`` on a mini KITTI layout and on the synthetic corridor, on the
CPU.

Pose tolerance: the ES parity tolerance of ``tests/test_torch_es.py``,
1 cm / 2e-3 rad (cold-start frames of a small config sit on gate
boundaries)."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from pfilter_tpu.utils import metrics as jmetrics
from pfilter_tpu.utils import synthetic
from pfilter_tpu_torch import run_kitti
from pfilter_tpu_torch.utils import metrics
from tests.test_es_odometry import small_config
from tests.test_torch_kitti_io import write_mini_kitti
from torch_parity import rotation_angle, torch_config

ROOT = Path(__file__).resolve().parent.parent
POS_TOL_M = 1e-2
ROT_TOL_RAD = 2e-3


def _reference_runner():
    spec = importlib.util.spec_from_file_location("reference_run_kitti", ROOT / "tools" / "run_kitti.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scans():
    cfg = small_config()
    world = synthetic.make_world(seed=3, corridor_len=40.0)
    poses = synthetic.make_trajectory(3, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, cfg.lidar, n_azimuth=600, noise=0.004)
    gt = jmetrics.poses_to_matrices(np.asarray(poses.q), np.asarray(poses.t))
    return cfg, [np.asarray(xyz[i])[np.asarray(valid[i])] for i in range(3)], gt


@pytest.fixture(scope="module")
def both_runs(scans, tmp_path_factory):
    cfg, frames, gt = scans
    out = tmp_path_factory.mktemp("runs")
    ref = _reference_runner().run_sequence(cfg, frames, gt, out / "ref", "t", global_map_stride=1)
    port = run_kitti.run_sequence(torch_config(cfg), frames, gt, out / "port", "t", global_map_stride=1, device="cpu")
    return ref, port, out


def test_run_sequence_global_map_artifact(both_runs):
    """Twin of ``tests/test_global_map.py::test_run_sequence_global_map_artifact``."""
    _, res, out = both_runs
    assert res["frames"] == 3 and res["device"] == "cpu" and res["overflow_total"] == 0
    pts = np.load(out / "port" / "t_map.npz")["xyz"]
    assert len(pts) > 1000 and np.isfinite(pts).all()
    ply = (out / "port" / "t_map.ply").read_text().splitlines()
    assert ply[2] == f"element vertex {len(pts)}" and len(ply) == 7 + len(pts)


def test_result_keys_and_trajectory_match_reference(both_runs):
    ref, port, out = both_runs
    assert list(port) == list(ref)
    assert port["frames"] == ref["frames"] and port["overflow_total"] == ref["overflow_total"]
    want, got = jmetrics.load_kitti_format(out / "ref" / "t.txt"), metrics.load_kitti_format(out / "port" / "t.txt")
    assert got.shape == want.shape == (3, 4, 4)
    assert np.linalg.norm(got[:, :3, 3] - want[:, :3, 3], axis=1).max() < POS_TOL_M
    cos = np.clip((np.trace(np.linalg.inv(want[:, :3, :3]) @ got[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    assert np.arccos(cos).max() < ROT_TOL_RAD


def test_frames_jsonl_matches_reference(both_runs):
    _, _, out = both_runs
    ref = [json.loads(x) for x in (out / "ref" / "t_frames.jsonl").read_text().splitlines()]
    port = [json.loads(x) for x in (out / "port" / "t_frames.jsonl").read_text().splitlines()]
    assert len(port) == len(ref) == 3
    assert [list(r) for r in port] == [list(r) for r in ref]
    q = np.array([r["pose_q"] for r in port])
    assert rotation_angle(q, np.array([r["pose_q"] for r in ref])).max() < ROT_TOL_RAD


def test_main_on_a_kitti_layout_writes_all_files(scans, tmp_path, capsys):
    """``main --root <layout> --device cpu --global-map 1``: the KITTI reader,
    the velodyne-frame ground truth and all four output files."""
    cfg, frames, gt = scans
    tr = np.eye(4)
    tr[:3] = [[0.0, -1.0, 0.0, 0.1], [0.0, 0.0, -1.0, -0.05], [1.0, 0.0, 0.0, 0.2]]
    cam = np.einsum("ij,njk,kl->nil", tr, np.linalg.inv(gt[0]) @ gt, np.linalg.inv(tr))
    bins = [np.concatenate([f, np.zeros((len(f), 1), np.float32)], 1) for f in frames]
    write_mini_kitti(tmp_path / "kitti", "05", scans=bins, cam_poses=cam)
    cfg_yaml = tmp_path / "small.yaml"
    cfg_yaml.write_text(_yaml(cfg))
    results = run_kitti.main(["--root", str(tmp_path / "kitti"), "--sequence", "05", "--config", str(cfg_yaml),
                              "--preset", "default", "--global-map", "1", "--out", str(tmp_path / "out"), "--device", "cpu"])
    assert len(results) == 1 and results[0]["frames"] == 3 and results[0]["tag"] == "05_run"
    assert "ate_rmse_m" in results[0] and results[0]["ate_rmse_m"] < 0.1
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])  # drift is NaN: 2 m of path, no 100 m segment
    assert list(printed) == list(results[0]) and printed["ate_rmse_m"] == results[0]["ate_rmse_m"]
    for name in ("05_run.txt", "05_run_frames.jsonl", "05_run_map.npz", "05_run_map.ply"):
        assert (tmp_path / "out" / name).is_file(), name


def test_main_synthetic_with_frame_limit(scans, tmp_path):
    cfg, _, _ = scans
    cfg_yaml = tmp_path / "small.yaml"
    cfg_yaml.write_text(_yaml(cfg))
    results = run_kitti.main(["--synthetic", "--frames", "2", "--config", str(cfg_yaml), "--preset", "default",
                              "--sequence", "syn", "--out", str(tmp_path / "out"), "--device", "cpu"])
    assert results[0]["frames"] == 2 and np.isfinite(results[0]["ate_rmse_m"])
    assert len(metrics.load_kitti_format(tmp_path / "out" / "syn_run.txt")) == 2


def _yaml(cfg) -> str:
    """The fields in which ``cfg`` differs from the default config, as YAML."""
    import dataclasses

    from pfilter_tpu.config import PipelineConfig

    base, lines = PipelineConfig(), []
    for f in dataclasses.fields(cfg):
        sub, ref = getattr(cfg, f.name), getattr(base, f.name)
        if dataclasses.is_dataclass(sub) and sub != ref:
            lines.append(f"{f.name}:")
            lines += [f"  {g.name}: {getattr(sub, g.name)}" for g in dataclasses.fields(sub) if getattr(sub, g.name) != getattr(ref, g.name)]
    return "\n".join(lines) + "\n"
