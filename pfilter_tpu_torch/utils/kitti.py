"""KITTI odometry dataset I/O: velodyne ``.bin`` scans, calibration,
ground-truth poses and a prefetching sequence reader.

The port's own copy of ``pfilter_tpu/utils/kitti.py`` (the replacement for
the reference's rosbag playback, ref: launch/pfilter_kitti.launch:74-76,
src/odomEstimationNode.cpp:115-118).  Scans are read ahead by the native C++
prefetcher ``runtime/io/frame_loader.cpp``, which this module compiles itself
with ``g++`` into ``pfilter_tpu_torch/_build/`` at first use (nothing is
written under ``runtime/io/``).  Where it cannot be built, scans are read
with numpy; either way :meth:`KittiSequence.scans` says on stderr which
reader it uses and sets :attr:`KittiSequence.reader`.

Expected layout (standard KITTI odometry benchmark):
  <root>/sequences/<seq>/velodyne/000000.bin ...
  <root>/sequences/<seq>/calib.txt            (Tr: velodyne -> cam0)
  <root>/poses/<seq>.txt                      (cam0 poses, 3x4 rows)
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

LOADER_SOURCE = Path(__file__).resolve().parents[2] / "runtime" / "io" / "frame_loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
_MAX_POINTS = 200_000  # HDL-64 peaks ~130k points/scan


def build_native_loader() -> Path:
    """Compile the prefetcher if its build is missing; return the library's
    path.  The build directory is keyed by a hash of the source and flags,
    and the library is moved into place whole, so a concurrent build never
    loads a half-written file.  Raises if ``g++`` is absent or fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    h = hashlib.sha256(" ".join(CXXFLAGS).encode() + LOADER_SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_ROOT / f"frame_loader-{h}" / "libframe_loader.so"
    if lib_path.is_file():
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        tmp_lib = Path(tmp) / lib_path.name
        out = subprocess.run([cxx, *CXXFLAGS, str(LOADER_SOURCE), "-o", str(tmp_lib)], capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed on {LOADER_SOURCE.name}:\n{out.stderr}")
        os.replace(tmp_lib, lib_path)
    return lib_path


@functools.cache
def native_loader() -> tuple[Optional[ctypes.CDLL], str]:
    """``(library, where it was loaded from)``, or ``(None, why not)``."""
    try:
        path = build_native_loader()
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        return None, f"{type(e).__name__}: {e}"
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.fl_next.restype = ctypes.c_int64
    lib.fl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.fl_close.restype = None
    lib.fl_close.argtypes = [ctypes.c_void_p]
    return lib, str(path)


def read_velodyne_bin(path) -> np.ndarray:
    """[N, 4] float32 (x, y, z, reflectance)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_calib(path) -> dict[str, np.ndarray]:
    """KITTI calib.txt -> {name: [3,4]}; 'Tr' maps velodyne -> cam0."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            name, vals = line.split(":", 1)
            try:
                arr = np.array(vals.split(), dtype=np.float64)
            except ValueError:  # a non-numeric entry such as calib_time
                continue
            if arr.size == 12:
                out[name.strip()] = arr.reshape(3, 4)
    return out


def read_poses(path) -> np.ndarray:
    """KITTI pose file (3x4 rows) -> [N, 4, 4]."""
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    mats = np.tile(np.eye(4), (len(raw), 1, 1))
    mats[:, :3, :] = raw
    return mats


def poses_in_velodyne_frame(cam_poses: np.ndarray, calib: dict) -> np.ndarray:
    """Ground truth is cam0->world; odometry runs in the velodyne frame.
    T_vel(i<-0) = Tr^-1 . T_cam(i<-0) . Tr."""
    tr = np.eye(4)
    tr[:3, :] = calib["Tr"]
    tr_inv = np.linalg.inv(tr)
    return np.einsum("ij,njk,kl->nil", tr_inv, cam_poses, tr)


class KittiSequence:
    """One KITTI odometry sequence: scan iterator + ground truth."""

    def __init__(self, root, sequence: str):
        self.root = Path(root)
        self.sequence = sequence
        seq_dir = self.root / "sequences" / sequence
        self.scan_paths = sorted((seq_dir / "velodyne").glob("*.bin"))
        if not self.scan_paths:
            raise FileNotFoundError(f"no velodyne scans under {seq_dir}")
        calib_path = seq_dir / "calib.txt"
        self.calib = read_calib(calib_path) if calib_path.exists() else None
        pose_path = self.root / "poses" / f"{sequence}.txt"
        self.gt_cam = read_poses(pose_path) if pose_path.exists() else None
        self.reader: Optional[str] = None  # "native" or "numpy" once scans() has started

    def __len__(self) -> int:
        return len(self.scan_paths)

    @property
    def gt_velodyne(self) -> Optional[np.ndarray]:
        if self.gt_cam is None or self.calib is None:
            return None
        return poses_in_velodyne_frame(self.gt_cam, self.calib)

    def scans(self, prefetch_threads: int = 3, prefetch_depth: int = 6) -> Iterator[np.ndarray]:
        """Yield [N, 4] float32 scans in order, read ahead by the native
        prefetcher, or by numpy where it cannot be built."""
        lib, where = native_loader()
        if lib is None:
            self.reader = "numpy"
            print(f"kitti: reading scans with numpy; the native prefetcher is unavailable ({where})", file=sys.stderr)
            for p in self.scan_paths:
                yield read_velodyne_bin(p)
            return
        self.reader = "native"
        print(f"kitti: reading scans with the native prefetcher {where}", file=sys.stderr)
        paths = [str(p).encode() for p in self.scan_paths]
        arr = (ctypes.c_char_p * len(paths))(*paths)
        max_floats = _MAX_POINTS * 4
        handle = lib.fl_open(arr, len(paths), max_floats, prefetch_threads, prefetch_depth)
        buf = np.empty(max_floats, np.float32)
        try:
            for _ in range(len(paths)):
                n = lib.fl_next(handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_floats)
                if n < 0:
                    raise IOError("frame_loader read error")
                if n == 0:
                    return
                yield buf[:n].reshape(-1, 4).copy()
        finally:
            lib.fl_close(handle)
