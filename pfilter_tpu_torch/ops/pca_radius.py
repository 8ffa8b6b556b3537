"""Radius-neighbourhood PCA moments for the BPF classifier.

Port of ``pfilter_tpu/ops/pca_radius.py`` (ref: include/preProcess.hpp:200-247,
283-324: per point, the neighbours within 1 m and their covariance).  For
every query the ten moment sums ``[1, x, y, z, xx, yy, zz, xy, xz, yz]`` over
the map points with squared distance below ``radius**2`` are accumulated;
count, mean and scatter covariance follow on the host side of the kernel.

The candidates are those of the tiled kNN (``ops/knn_tiled.py``): a query in
tile t reads t's 3x3 tile halo as three contiguous slot ranges, one per tile
row, each capped at ``w = 3 * tile_cap`` slots — slots past the cap are not
read, and :func:`pfilter_tpu_torch.models.bpf_frontend.run_frontend` counts
them (``knn_tiled.halo_overflow``).  Query and candidates are recentered to
t's center before the fp32 squared distance ``dx*dx + dy*dy + dz*dz`` (each
operation rounded on its own), so the CUDA kernel (``csrc/pca_radius.cu``) and the plain version
here agree exactly on which points fall in each ball; their sums differ only
by summation order.  The mean is returned in the input frame (the tile
center added back); the scatter covariance is translation-invariant.

Divergence from the reference kept from the reference package: every point
in the ball counts (PCL's radiusSearch keeps the 25 nearest, ref :218), and
invalid queries get zero moments.

:func:`radius_moments_sorted` dispatches on the device of its queries: a CPU
tensor runs :func:`radius_moments_sorted_plain`, a CUDA tensor launches the
kernel (or raises).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pfilter_tpu_torch.ops import knn_tiled as knn

NMOM = 10  # [cnt, x, y, z, xx, yy, zz, xy, xz, yz]
# The kernel keeps a candidate only if each recentered coordinate lies within
# radius + CULL_MARGIN of its work item's query bounding box (its plain
# version: cull_keep_plain); the margin dwarfs
# the fp32 rounding of the box, the recentering and the distance (a few 1e-6 m
# at the window's coordinates), so no candidate inside a ball is dropped.
CULL_MARGIN = 1e-3
CHUNK = 32  # queries per work item of the kernel: one per lane of a warp
_PLAIN_Q_BLOCK = 2048  # plain version: queries per pass
_PLAIN_C_BLOCK = 512  # plain version: candidate slots per pass

KERNEL_LAUNCHES = 0  # launches of the CUDA kernel (not of the plain version)


class PCAMoments(NamedTuple):
    count: torch.Tensor  # [Q] neighbour count within radius
    mean: torch.Tensor  # [Q, 3]
    cov: torch.Tensor  # [Q, 3, 3] scatter covariance (unnormalized)


def radius_moments_sorted_plain(tmap: knn.TiledMap, sq_world, bounds, nt: int, tile_cells: int, tile_cap: int, radius: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``[Q, 10]`` moment sums of
    tile-sorted queries (zeros for queries of the invalid tile), tile-local
    coordinates, over the same capped halo ranges.  The CPU path, and the
    kernel's reference on the card; it reads the processed-query count and
    the widest halo row on the host to size its passes."""
    knn._check_inputs(tmap, sq_world, bounds, nt)
    q = sq_world.shape[0]
    nt2 = nt * nt
    dev = sq_world.device
    c_start, c_cnt = knn._halo_ranges(tmap, nt, 3 * tile_cap)
    ctr = knn._tile_centers(tmap.origin, nt, tile_cells)
    p = torch.arange(q, dtype=torch.int32, device=dev)
    tid = torch.clamp(torch.searchsorted(bounds, p, right=True) - 1, 0, nt2 - 1)
    out = torch.zeros((q, NMOM), dtype=torch.float32, device=dev)
    n_proc = int(bounds[nt2])
    for q0 in range(0, n_proc, _PLAIN_Q_BLOCK):
        q1 = min(q0 + _PLAIN_Q_BLOCK, n_proc)
        t = tid[q0:q1].long()
        ctr_q = ctr[t]
        qx = sq_world[q0:q1, 0:1] - ctr_q[:, 0:1]
        qy = sq_world[q0:q1, 1:2] - ctr_q[:, 1:2]
        qz = sq_world[q0:q1, 2:3] - ctr_q[:, 2:3]
        start, cnt = c_start[t], c_cnt[t]
        acc = torch.zeros((q1 - q0, NMOM), dtype=torch.float32, device=dev)
        for r in range(3):
            for j0 in range(0, int(cnt[:, r].max()), _PLAIN_C_BLOCK):
                j = torch.arange(j0, j0 + _PLAIN_C_BLOCK, dtype=torch.int32, device=dev)
                ok = j[None, :] < cnt[:, r : r + 1]
                slots = torch.where(ok, start[:, r : r + 1] + j[None, :], torch.zeros_like(j[None, :])).long()
                x = tmap.xyz_t[0][slots] - ctr_q[:, 0:1]
                y = tmap.xyz_t[1][slots] - ctr_q[:, 1:2]
                z = tmap.xyz_t[2][slots] - ctr_q[:, 2:3]
                dx, dy, dz = qx - x, qy - y, qz - z
                d = dx * dx + dy * dy + dz * dz
                wf = (ok & (d < radius * radius)).to(torch.float32)
                feats = torch.stack([wf, x, y, z, x * x, y * y, z * z, x * y, x * z, y * z], 1)
                acc += (feats * wf[:, None, :]).sum(-1)
        out[q0:q1] = acc
    return out


def cull_keep_plain(q_world, c_world, center, radius: float):
    """Plain version of the kernel's staging cull for one work item, in its
    fp32 operation order: queries ``[n,3]`` and candidates ``[c,3]`` are
    recentered on the tile's ``center`` (one rounded subtraction each), the
    queries' bounding box is grown by ``reach = fp32(radius + CULL_MARGIN)``
    (one rounded subtraction or addition per face), and a candidate is kept
    when every coordinate lies in that box, faces included.  Takes float32
    tensors; returns the ``[c]`` keep mask, the recentered candidates and the
    box's ``lo`` and ``hi``."""
    reach = torch.tensor(radius + CULL_MARGIN, dtype=torch.float32, device=q_world.device)
    qc = q_world - center
    cc = c_world - center
    lo = qc.amin(0) - reach
    hi = qc.amax(0) + reach
    return ((cc >= lo) & (cc <= hi)).all(1), cc, lo, hi


def _radius_moments_sorted_cuda(tmap: knn.TiledMap, sq_world, bounds, nt: int, tile_cells: int, tile_cap: int, radius: float) -> torch.Tensor:
    """Launch ``csrc/pca_radius.cu`` on PyTorch's current stream."""
    global KERNEL_LAUNCHES
    from pfilter_tpu_torch.ops import _build

    knn._check_cuda_inputs(tmap, sq_world, bounds, nt)
    dev = sq_world.device
    q = sq_world.shape[0]
    out = torch.zeros((q, NMOM), dtype=torch.float32, device=dev)
    if q == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = knn.work_list(bounds, nt, CHUNK, q, stream)
    xyz_t = knn._aligned_coords(tmap.xyz_t)
    tile_start = tmap.tile_start.contiguous()
    origin = tmap.origin.contiguous()
    queries = sq_world.contiguous()
    err = _build.load().pf_pca_radius(
        xyz_t.data_ptr(), xyz_t.shape[1], tile_start.data_ptr(), work.data_ptr(), origin.data_ptr(),
        queries.data_ptr(), nt, tile_cells, 3 * tile_cap, radius * radius, radius + CULL_MARGIN, CHUNK,
        out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"pca_radius kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out


def radius_moments_sorted(tmap: knn.TiledMap, sq_world, bounds, nt: int, tile_cells: int, tile_cap: int, radius: float = 1.0) -> torch.Tensor:
    """``[Q, 10]`` tile-local moment sums of tile-sorted queries.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
    if sq_world.device.type == "cuda":
        return _radius_moments_sorted_cuda(tmap, sq_world, bounds, nt, tile_cells, tile_cap, radius)
    if sq_world.device.type != "cpu":
        raise ValueError(f"unsupported device {sq_world.device}")
    return radius_moments_sorted_plain(tmap, sq_world, bounds, nt, tile_cells, tile_cap, radius)


def _finish(m_sorted, qs: knn.QuerySort, q_xyz, q_valid, origin, nt: int, tile_cells: int) -> PCAMoments:
    """Unsort, zero invalid queries, and turn the tile-local sums into count,
    input-frame mean and scatter covariance."""
    nt2 = nt * nt
    m = m_sorted[qs.inv]
    m = torch.where(q_valid[:, None], m, torch.zeros_like(m))
    cnt = m[:, 0]
    safe_n = torch.clamp(cnt, min=1.0)
    mean_local = m[:, 1:4] / safe_n[:, None]
    xx, yy, zz, xy, xz, yz = m[:, 4], m[:, 5], m[:, 6], m[:, 7], m[:, 8], m[:, 9]
    second = torch.stack(
        [torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1), torch.stack([xz, yz, zz], -1)], -2
    )
    cov = second - safe_n[:, None, None] * mean_local[:, :, None] * mean_local[:, None, :]
    tid = knn._tile_ids(q_xyz, q_valid, origin, nt, tile_cells)
    ctr_q = knn._tile_centers(origin, nt, tile_cells)[torch.clamp(tid, 0, nt2 - 1).long()]
    mean = mean_local + torch.where(q_valid[:, None], ctr_q, torch.zeros_like(ctr_q))
    return PCAMoments(count=cnt, mean=mean, cov=cov)


def radius_pca_moments(tmap: knn.TiledMap, q_xyz, q_valid, nt: int, tile_cells: int, tile_cap: int, radius: float = 1.0, moments=None) -> PCAMoments:
    """Neighbour count, mean and scatter covariance within ``radius`` of every
    query, against a tiled point set (usually the scan itself).  ``moments``
    computes the sorted sums (default :func:`radius_moments_sorted`, looked up
    at call time)."""
    moments = moments or radius_moments_sorted
    qs = knn.sort_queries(q_xyz, q_valid, tmap.origin, nt, tile_cells)
    m = moments(tmap, q_xyz[qs.order].contiguous(), qs.bounds, nt, tile_cells, tile_cap, radius)
    return _finish(m, qs, q_xyz, q_valid, tmap.origin, nt, tile_cells)


def radius_pca_moments_plain(tmap: knn.TiledMap, q_xyz, q_valid, nt: int, tile_cells: int, tile_cap: int, radius: float = 1.0) -> PCAMoments:
    """:func:`radius_pca_moments` through the plain version on any device."""
    return radius_pca_moments(tmap, q_xyz, q_valid, nt, tile_cells, tile_cap, radius, moments=radius_moments_sorted_plain)
