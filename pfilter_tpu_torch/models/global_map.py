"""Tiled global visualization map — port of ``pfilter_tpu/models/global_map.py``
(ref ``LaserMappingClass``, include/laserMappingClass.h:23-60,
src/laserMappingClass.cpp:7-208).

The reference grows a grid of 50 m cells as the robot moves, inserts
pose-transformed scans into the cells and voxel-grid downsamples the cells
around the robot each update (src/laserMappingClass.cpp:152-191); getMap
concatenates every cell (:196-208).  Here, as in the JAX package, the grid is
a fixed pool of cell slots on the device (``[max_cells, cell_cap]``) plus a
host table from cell id to slot, reused first in, first out.  Each update
re-voxelizes only the cells the scan touches.

The cell and slot of each point are host data: the scan is numpy and the
pose is a ``FrameRecord``'s, so the scan is transformed on the host (the
same float32 arithmetic as ``se3.transform_points``), each touched cell's new
points are packed there, and they go up in one pinned, non-blocking copy.
:meth:`GlobalMap.update` never reads a device tensor back, so it does not
wait for the odometry frames in flight; :meth:`GlobalMap.get_map` does, once,
at the end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pfilter_tpu_torch import host_buffer, resolve_device, upload
from pfilter_tpu_torch.ops import se3, voxel

CELL_SIZE = 50.0  # ref LASER_CELL_WIDTH/HEIGHT/DEPTH (include/laserMappingClass.h:12-14)
_TOUCH_CAP = 32  # cells a single scan may touch (scan radius 120 m < 3 cells)


class CellStore(NamedTuple):
    """Fixed pool of map cells on the device."""

    xyz: torch.Tensor  # [C, K, 3]
    valid: torch.Tensor  # [C, K] bool
    count: torch.Tensor  # [C] int32 — valid points per cell (packed prefix)


def empty_store(max_cells: int, cell_cap: int, device=None) -> CellStore:
    return CellStore(
        xyz=torch.zeros((max_cells, cell_cap, 3), dtype=torch.float32, device=device),
        valid=torch.zeros((max_cells, cell_cap), dtype=torch.bool, device=device),
        count=torch.zeros(max_cells, dtype=torch.int32, device=device),
    )


def _insert(store: CellStore, new_xyz: np.ndarray, new_slot: np.ndarray, touched: np.ndarray, leaf: float) -> CellStore:
    """Merge each touched slot's points with its share of the new scan, then
    voxel-downsample back into the cell's capacity (the reference's per-cell
    VoxelGrid pass, src/laserMappingClass.cpp:180-189).

    ``new_xyz`` [N,3] world-frame points, ``new_slot`` [N] slot per point
    (-1 = drop) and ``touched`` [_TOUCH_CAP] slots (-1 = padding) are host
    arrays.  A slot's new points are its first ``cell_cap`` points in scan
    order; padding entries write nothing.  The store is updated in place."""
    k = store.xyz.shape[1]
    dev = store.xyz.device
    slots = [int(s) for s in touched if s >= 0]
    picks = [np.flatnonzero(new_slot == s)[:k] for s in slots]
    host = host_buffer((sum(len(p) for p in picks), 3), torch.float32, dev)
    host.numpy()[:] = new_xyz[np.concatenate(picks)] if picks else np.zeros((0, 3), np.float32)
    packed = upload(host, dev)
    rg0 = torch.zeros((k, 2), dtype=torch.float32, device=dev)
    ar = torch.arange(k, device=dev)
    off = 0
    for s, p in zip(slots, picks):
        n_new = len(p)
        buf = torch.zeros((k, 3), dtype=torch.float32, device=dev)
        buf[:n_new] = packed[off : off + n_new]
        off += n_new
        old = voxel.PointSet(xyz=store.xyz[s], rg=rg0, valid=store.valid[s])
        new = voxel.PointSet(xyz=buf, rg=rg0, valid=ar < n_new)
        ds = voxel.voxel_downsample_rgbds(voxel.concat_pointsets(old, new), leaf, k)
        store.xyz[s] = ds.xyz
        store.valid[s] = ds.valid
        store.count[s] = ds.valid.sum(dtype=torch.int32)
    return store


class GlobalMap:
    """Host wrapper: cell-id bookkeeping plus :func:`_insert`, on ``device``
    (CUDA unless ``"cpu"`` is passed).

    ``update(pose_q, pose_t, scan_xyz, scan_valid)`` mirrors
    ``updateCurrentPointsToMap`` (src/laserMappingClass.cpp:152-191);
    ``get_map()`` mirrors ``getMap`` (:196-208)."""

    def __init__(self, max_cells: int = 512, cell_cap: int = 16384, resolution: float = 0.4, device=None):
        self.max_cells = max_cells
        self.cell_cap = cell_cap
        self.resolution = float(resolution)
        self.device = resolve_device(device)
        self.store = empty_store(max_cells, cell_cap, self.device)
        self._slot_of: dict[tuple, int] = {}
        self._next = 0

    def _slot(self, cell: tuple) -> int:
        s = self._slot_of.get(cell)
        if s is None:
            if self._next >= self.max_cells:
                # Reuse the oldest cell's slot (first in, first out) without
                # clearing it, as the reference package does: the new cell
                # starts with the old cell's points.
                oldest = next(iter(self._slot_of))
                s = self._slot_of.pop(oldest)
            else:
                s = self._next
                self._next += 1
            self._slot_of[cell] = s
        return s

    def update(self, pose_q, pose_t, scan_xyz, scan_valid) -> None:
        """Insert a sensor-frame scan (host arrays) seen from pose (q, t)."""
        pose = se3.Pose(q=_host_f32(pose_q), t=_host_f32(pose_t))
        world = se3.transform_points(pose, _host_f32(scan_xyz)).numpy()
        v = np.asarray(scan_valid, bool)
        cells = np.floor(world / CELL_SIZE).astype(np.int64)
        # Exact touched set: unique cells of the valid points.
        uniq = {tuple(c) for c in np.unique(cells[v], axis=0)}
        if len(uniq) > _TOUCH_CAP:
            # A single scan spans > _TOUCH_CAP cells only with >300 m range.
            uniq = set(list(uniq)[:_TOUCH_CAP])
        slot_map = {cell: self._slot(cell) for cell in sorted(uniq)}
        slot_per_point = np.full(len(world), -1, np.int32)
        for cell, s in slot_map.items():
            m = v & (cells == np.asarray(cell)).all(1)
            slot_per_point[m] = s
        touched = np.full(_TOUCH_CAP, -1, np.int32)
        touched[: len(slot_map)] = sorted(slot_map.values())
        self.store = _insert(self.store, world, slot_per_point, touched, self.resolution)

    def get_map(self) -> np.ndarray:
        """[M, 3] world-frame points (all cells concatenated)."""
        xyz = self.store.xyz.reshape(-1, 3).cpu().numpy()
        valid = self.store.valid.reshape(-1).cpu().numpy()
        return xyz[valid]


def _host_f32(x) -> torch.Tensor:
    """Host data as a float32 CPU tensor (a CUDA tensor raises: reading it
    back would wait for the device)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))
