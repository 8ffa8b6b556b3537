"""The port's KITTI I/O (``utils/kitti.py``) and trajectory file format
(``utils/metrics.py``) against the reference package's, on the synthesized
mini layout of ``tests/test_kitti_io.py`` (no real KITTI data ships here):
.bin round trip, calib and pose parsing, the velodyne-frame transform, the
native prefetcher the port builds itself against the numpy reader, and the
KITTI pose format.

Tolerances: parsing and the scan readers are exact; the velodyne-frame
poses are the same float64 einsum in both packages and compare equal; the
pose files are byte-identical."""

import shutil

import numpy as np
import pytest

from pfilter_tpu.utils import kitti as jkitti
from pfilter_tpu.utils import metrics as jmetrics
from pfilter_tpu_torch.utils import kitti, metrics


def write_mini_kitti(root, seq_name="07", scans=None, n=5, seed=0, cam_poses=None):
    """A KITTI odometry layout under ``root``: ``scans`` (or ``n`` random
    [N,4] float32 scans), a calib whose Tr swaps axes and offsets (velodyne
    -> cam0), and cam0 poses (forward motion along cam z unless given).
    Returns (scans, Tr [3,4], cam poses [n,4,4])."""
    seq = root / "sequences" / seq_name
    (seq / "velodyne").mkdir(parents=True)
    (root / "poses").mkdir(exist_ok=True)
    if scans is None:
        rng = np.random.default_rng(seed)
        scans = [rng.uniform(-50, 50, size=(int(rng.integers(1000, 3000)), 4)).astype(np.float32) for _ in range(n)]
    for i, scan in enumerate(scans):
        scan.tofile(seq / "velodyne" / f"{i:06d}.bin")
    tr = np.array([[0.0, -1.0, 0.0, 0.1], [0.0, 0.0, -1.0, -0.05], [1.0, 0.0, 0.0, 0.2]])
    with open(seq / "calib.txt", "w") as f:
        f.write("P0: " + " ".join(["0"] * 12) + "\n")
        f.write("Tr: " + " ".join(str(v) for v in tr.reshape(-1)) + "\n")
    if cam_poses is None:
        cam_poses = np.tile(np.eye(4), (len(scans), 1, 1))
        cam_poses[:, 2, 3] = np.arange(len(scans)) * 1.5
    with open(root / "poses" / f"{seq_name}.txt", "w") as f:
        for m in cam_poses:
            f.write(" ".join(repr(float(v)) for v in m[:3].reshape(-1)) + "\n")
    return scans, tr, cam_poses


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    scans, tr, mats = write_mini_kitti(root)
    return root, scans, tr, mats


def test_bin_roundtrip(mini_kitti):
    root, scans, _, _ = mini_kitti
    seq = kitti.KittiSequence(root, "07")
    assert len(seq) == 5
    np.testing.assert_array_equal(kitti.read_velodyne_bin(seq.scan_paths[2]), scans[2])


def test_calib_and_poses(mini_kitti):
    root, _, tr, mats = mini_kitti
    seq = kitti.KittiSequence(root, "07")
    np.testing.assert_allclose(seq.calib["Tr"], tr)
    np.testing.assert_allclose(seq.gt_cam, mats)
    vel = seq.gt_velodyne
    d = vel[1] @ np.linalg.inv(vel[0])
    np.testing.assert_allclose(np.linalg.norm(d[:3, 3]), 1.5, atol=1e-9)
    np.testing.assert_allclose(vel[:, :3, 3][:, 0], np.arange(5) * 1.5, atol=1e-9)


def test_parsing_equals_reference(mini_kitti):
    root, _, _, _ = mini_kitti
    mine, ref = kitti.KittiSequence(root, "07"), jkitti.KittiSequence(root, "07")
    assert [p.name for p in mine.scan_paths] == [p.name for p in ref.scan_paths]
    assert mine.calib.keys() == ref.calib.keys()
    for k in ref.calib:
        np.testing.assert_array_equal(mine.calib[k], ref.calib[k])
    np.testing.assert_array_equal(mine.gt_cam, ref.gt_cam)
    np.testing.assert_array_equal(mine.gt_velodyne, ref.gt_velodyne)


def test_scan_iterator_matches_files(mini_kitti, capfd):
    root, scans, _, _ = mini_kitti
    seq = kitti.KittiSequence(root, "07")
    out = list(seq.scans())
    assert len(out) == 5 and seq.reader in ("native", "numpy")
    assert "kitti: reading scans with" in capfd.readouterr().err
    for got, want in zip(out, scans):
        np.testing.assert_array_equal(got, want)


def test_native_loader_builds_and_matches(mini_kitti, capfd):
    """The prefetcher the port compiles into ``pfilter_tpu_torch/_build``
    yields the numpy reader's scans."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the port cannot build its native prefetcher here")
    root, scans, _, _ = mini_kitti
    lib, where = kitti.native_loader()
    assert lib is not None, where
    assert "pfilter_tpu_torch/_build/frame_loader-" in where and "runtime/io" not in where
    seq = kitti.KittiSequence(root, "07")
    out = list(seq.scans(prefetch_threads=3, prefetch_depth=2))
    assert seq.reader == "native" and "native prefetcher" in capfd.readouterr().err
    assert len(out) == len(scans)
    for got, path in zip(out, seq.scan_paths):
        np.testing.assert_array_equal(got, kitti.read_velodyne_bin(path))


def test_numpy_fallback_says_so(mini_kitti, monkeypatch, capfd):
    root, scans, _, _ = mini_kitti
    monkeypatch.setattr(kitti, "native_loader", lambda: (None, "RuntimeError: g++ not found"))
    seq = kitti.KittiSequence(root, "07")
    out = list(seq.scans())
    assert seq.reader == "numpy" and "with numpy" in capfd.readouterr().err
    for got, want in zip(out, scans):
        np.testing.assert_array_equal(got, want)


def test_pose_format_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    mats = np.tile(np.eye(4), (7, 1, 1))
    mats[:, :3, 3] = rng.normal(size=(7, 3))
    p = tmp_path / "poses.txt"
    metrics.save_kitti_format(p, mats)
    np.testing.assert_allclose(metrics.load_kitti_format(p), mats, atol=1e-12)


def test_pose_format_byte_identical_to_reference(tmp_path):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(9, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mats = metrics.poses_to_matrices(q, rng.normal(scale=100.0, size=(9, 3)))
    metrics.save_kitti_format(tmp_path / "port.txt", mats)
    jmetrics.save_kitti_format(tmp_path / "ref.txt", mats)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    np.testing.assert_array_equal(metrics.load_kitti_format(tmp_path / "ref.txt"), jmetrics.load_kitti_format(tmp_path / "port.txt"))
