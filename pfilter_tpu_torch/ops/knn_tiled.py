"""Tiled exact 5-NN against a tile-sorted point map.

Port of ``pfilter_tpu/ops/knn_tiled.py``.  The map is sorted by 2D spatial
tile (``tile_cells`` x 1 m cells, row-major over an ``NT x NT`` window
anchored near the pose, z unbounded); queries are sorted by the same tile id
once per frame.  A query's candidates are its tile's 3x3 halo, read as three
contiguous slot ranges (one per tile row), each capped at ``3 * tile_cap``
slots.  Queries and candidates are recentered to the query tile's center
before the fp32 squared distance, and the result is an exact top-5 ascending,
ties broken by the lower halo position (row, then place in the row): the
lower slot wherever the three rows are distinct, as they are for every query
tile :func:`sort_queries` yields.

:func:`query_tiled_sorted` dispatches on the device of its queries: a CPU
tensor runs :func:`query_tiled_sorted_plain`, a CUDA tensor launches the
hand-written kernel ``csrc/knn_tiled.cu`` (or raises).  Both compute the same
fp32 arithmetic in the same order and break ties by the same rule, so they
agree bit for bit, indices included.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

FAR = 1.0e4  # invalid-slot coordinate: far beyond any gate, square-safe in fp32
# Slots appended to ``xyz_t`` beyond the map capacity; the same layout as the
# reference package's map so its states carry across unchanged.  The kernels'
# aligned bulk copies read up to 3 floats past a slice; the padding keeps
# those reads inside the tensor.
_PAD_EXTRA = 128
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block can use
CHUNK = 8  # queries per work item of the kNN kernel: 16 or 32 lanes per query

KERNEL_LAUNCHES = 0  # launches of the CUDA kNN kernel (not of the plain version)
WORK_LIST_LAUNCHES = 0  # launches of the work-list kernel, by both kernels' wrappers


class TiledMap(NamedTuple):
    """A point map sorted by spatial tile, with a transposed coordinate copy
    and per-tile slot ranges."""

    xyz: torch.Tensor  # [CAP, 3] float32, tile-sorted
    rg: torch.Tensor  # [CAP, W] float32 persistence counters
    valid: torch.Tensor  # [CAP] bool
    xyz_t: torch.Tensor  # [4, CAP + pad] float32 transposed; invalid slots at FAR
    tile_start: torch.Tensor  # [NT*NT + 1] int32 slot ranges
    origin: torch.Tensor  # [3] float32 — window anchor (world coords)


class QuerySort(NamedTuple):
    """Frame-level tile sort of a query cloud."""

    order: torch.Tensor  # [Q] int64 — sorted position <- original position
    inv: torch.Tensor  # [Q] int64 — original position <- sorted position
    bounds: torch.Tensor  # [NT2+1] int32 per-tile ranges in sorted order


class TiledKnnResult(NamedTuple):
    idx: torch.Tensor  # [Q, K] int32 slot ids into the tiled map arrays
    sqdist: torch.Tensor  # [Q, K] float32 squared distances (inf-padded)


def tile_origin_for_pose(pose_t: torch.Tensor, nt: int, tile_cells: int) -> torch.Tensor:
    """Anchor the NT x NT tile window (1 m cells) so the pose is centered."""
    tile_size = float(tile_cells)
    half = nt * tile_size / 2.0
    return torch.floor(pose_t / tile_size) * tile_size - half


def _tile_ids(xyz, valid, origin, nt: int, tile_cells: int) -> torch.Tensor:
    ts = float(tile_cells)
    t = torch.floor((xyz[:, :2] - origin[:2]) / ts).to(torch.int32)
    t = torch.clamp(t, 1, nt - 2)  # border ring unused: halo never leaves the window
    tid = t[:, 0] * nt + t[:, 1]
    return torch.where(valid, tid, torch.full_like(tid, nt * nt))


def _tile_range(sorted_tid: torch.Tensor, nt: int) -> torch.Tensor:
    values = torch.arange(nt * nt + 1, dtype=sorted_tid.dtype, device=sorted_tid.device)
    return torch.searchsorted(sorted_tid, values).to(torch.int32)


def transposed_coords(xyz, valid, tile_cap: int) -> torch.Tensor:
    """The map's [4, CAP + 3*tile_cap + 128] coordinate copy: rows x, y, z, 0;
    invalid and padding slots sit at FAR so they never look near."""
    cap = xyz.shape[0]
    xyz_t = torch.full((4, cap + 3 * tile_cap + _PAD_EXTRA), FAR, dtype=torch.float32, device=xyz.device)
    xyz_t[:3, :cap] = torch.where(valid[None, :], xyz.T, torch.full_like(xyz.T, FAR))
    xyz_t[3] = 0.0
    return xyz_t


def build_tiled(xyz, rg, valid, origin, nt: int, tile_cells: int, tile_cap: int) -> TiledMap:
    """Sort points tile-major and compute per-tile ranges (one sort per map
    per frame — the tiled twin of the reference's KD-tree rebuild)."""
    tid = _tile_ids(xyz, valid, origin, nt, tile_cells)
    order = torch.argsort(tid, stable=True)
    sx, srg, sv = xyz[order], rg[order], valid[order]
    return TiledMap(
        xyz=sx,
        rg=srg,
        valid=sv,
        xyz_t=transposed_coords(sx, sv, tile_cap),
        tile_start=_tile_range(tid[order], nt),
        origin=origin,
    )


def sort_queries(q_xyz, q_valid, origin, nt: int, tile_cells: int) -> QuerySort:
    """Frame-level tile sort (invalid queries land in tile NT^2, never
    processed).  Callers reorder their per-point arrays by ``order`` and keep
    all downstream math in sorted order."""
    q = q_xyz.shape[0]
    tid = _tile_ids(q_xyz, q_valid, origin, nt, tile_cells)
    order = torch.argsort(tid, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(q, device=order.device)
    return QuerySort(order=order, inv=inv, bounds=_tile_range(tid[order], nt))


def _tile_centers(origin: torch.Tensor, nt: int, tile_cells: int) -> torch.Tensor:
    """[NT2, 3] f32 per-tile recentering points: tile center in xy, window
    center in z (z is unbounded within a tile)."""
    ts = float(tile_cells)
    tids = torch.arange(nt * nt, dtype=torch.int32, device=origin.device)
    tx, ty = tids // nt, tids % nt
    cx = origin[0] + (tx.to(torch.float32) + 0.5) * ts
    cy = origin[1] + (ty.to(torch.float32) + 0.5) * ts
    cz = torch.full_like(cx, 0.0) + (origin[2] + nt * ts / 2.0)
    return torch.stack([cx, cy, cz], -1)


def _halo_ranges(tmap: TiledMap, nt: int, w: int):
    """Per query tile: 3 contiguous candidate ranges (one per tile row),
    each capped at ``w`` slots.  Returns (c_start, c_cnt), both [NT2, 3]."""
    tids = torch.arange(nt * nt, dtype=torch.int32, device=tmap.tile_start.device)
    tx, ty = tids // nt, tids % nt
    c_starts, c_cnts = [], []
    for dr in (-1, 0, 1):
        row = torch.clamp(tx + dr, 0, nt - 1)
        lo = row * nt + torch.clamp(ty - 1, 0, nt - 1)
        hi = row * nt + torch.clamp(ty + 1, 0, nt - 1) + 1
        start = tmap.tile_start[lo.long()]
        c_starts.append(start)
        c_cnts.append(torch.clamp(tmap.tile_start[hi.long()] - start, max=w))
    return torch.stack(c_starts, -1), torch.stack(c_cnts, -1)


def halo_overflow(tmap: TiledMap, nt: int, w: int) -> torch.Tensor:
    """Slots beyond the cap ``w`` of each query tile's three halo rows, summed
    over every (query tile, row) pair: 0 means every halo read is complete."""
    _, cnt = _halo_ranges(tmap, nt, 2**31 - 1)
    return torch.clamp(cnt - w, min=0).sum().to(torch.int32)


def _max_items(n_queries: int, nt: int, chunk: int) -> int:
    """Rows a work list can need: each non-empty tile adds at most one ragged
    chunk to the ``n_queries // chunk`` full ones."""
    return n_queries // chunk + min(nt * nt, n_queries)


def work_list_plain(bounds: torch.Tensor, nt: int, chunk: int, n_queries: int) -> torch.Tensor:
    """Plain version of ``csrc/work_list.cu``: the kernels' work items.  Tile
    t's sorted queries ``[bounds[t], bounds[t+1])`` are cut into chunks of at
    most ``chunk``, tile by tile; queries of the invalid tile (``p >=
    bounds[NT*NT]``) belong to no item.  Returns int32 ``[1 + max_items, 4]``:
    row 0 holds the item count, row ``1 + i`` item i as (tile, first query,
    query count, 0); rows past the count are 0 here and unset on the card.
    Reads the item count on the host."""
    b = bounds.to(torch.int64)
    chunks = torch.div(b[1:] - b[:-1] + (chunk - 1), chunk, rounding_mode="floor")
    tile = torch.repeat_interleave(torch.arange(nt * nt, device=b.device), chunks)
    first = torch.cumsum(chunks, 0) - chunks  # each tile's first item
    q0 = b[tile] + (torch.arange(tile.shape[0], device=b.device) - first[tile]) * chunk
    n = torch.clamp(b[tile + 1] - q0, max=chunk)
    work = torch.zeros((1 + _max_items(n_queries, nt, chunk), 4), dtype=torch.int32, device=b.device)
    work[0, 0] = tile.shape[0]
    work[1 : 1 + tile.shape[0], :3] = torch.stack([tile, q0, n], 1).to(torch.int32)
    return work


def work_list(bounds: torch.Tensor, nt: int, chunk: int, n_queries: int, stream=None) -> torch.Tensor:
    """The work list of both kernels, for ``n_queries`` sorted queries.  A CPU
    tensor runs :func:`work_list_plain`; a CUDA tensor launches
    ``csrc/work_list.cu`` (one block, no host sync) on ``stream`` (default:
    PyTorch's current one) or raises."""
    global WORK_LIST_LAUNCHES
    if bounds.device.type == "cpu":
        return work_list_plain(bounds, nt, chunk, n_queries)
    if bounds.device.type != "cuda":
        raise ValueError(f"unsupported device {bounds.device}")
    from pfilter_tpu_torch.ops import _build

    if bounds.dtype != torch.int32 or bounds.shape != (nt * nt + 1,):
        raise ValueError("bounds must be int32 [NT*NT+1]")
    bounds = bounds.contiguous()
    stream = stream if stream is not None else torch.cuda.current_stream(bounds.device).cuda_stream
    work = torch.empty((1 + _max_items(n_queries, nt, chunk), 4), dtype=torch.int32, device=bounds.device)
    err = _build.load().pf_work_list(bounds.data_ptr(), nt * nt, chunk, work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"work_list kernel launch failed: CUDA error {err}")
    WORK_LIST_LAUNCHES += 1
    return work


def _check_inputs(tmap: TiledMap, sq_world: torch.Tensor, bounds: torch.Tensor, nt: int):
    if sq_world.dim() != 2 or sq_world.shape[1] != 3 or sq_world.dtype != torch.float32:
        raise ValueError(f"queries must be [Q,3] float32, got {tuple(sq_world.shape)} {sq_world.dtype}")
    if bounds.shape != (nt * nt + 1,) or tmap.tile_start.shape != (nt * nt + 1,):
        raise ValueError("bounds and tile_start must both be [NT*NT+1]")


def query_tiled_sorted_plain(
    tmap: TiledMap, sq_world, bounds, nt: int, tile_cells: int, tile_cap: int, k: int = 5
) -> TiledKnnResult:
    """Plain PyTorch version of the kNN kernel on the same halo ranges and
    caps (not a global brute force): the CPU path, and the kernel's reference
    on the card."""
    _check_inputs(tmap, sq_world, bounds, nt)
    q = sq_world.shape[0]
    nt2 = nt * nt
    dev = sq_world.device
    c_start, c_cnt = _halo_ranges(tmap, nt, 3 * tile_cap)
    ctr = _tile_centers(tmap.origin, nt, tile_cells)
    p = torch.arange(q, dtype=torch.int32, device=dev)
    tid = torch.clamp(torch.searchsorted(bounds, p, right=True) - 1, 0, nt2 - 1)
    processed = p < bounds[nt2]
    # Candidate width: the widest halo row actually present (no slot beyond
    # it can be a candidate); rows are laid out one after another, so a
    # stable sort breaks distance ties by the lower halo position.
    width = max(int(c_cnt.max()), 1)
    j = torch.arange(width, dtype=torch.int32, device=dev)
    cnt_q = c_cnt[tid]  # [Q,3]
    ok = (j[None, None, :] < cnt_q[:, :, None]).reshape(q, 3 * width)
    slots = (c_start[tid][:, :, None] + j[None, None, :]).reshape(q, 3 * width)
    slots = torch.where(ok, slots, torch.zeros_like(slots)).long()
    ctr_q = ctr[tid]
    qx = sq_world[:, 0:1] - ctr_q[:, 0:1]
    qy = sq_world[:, 1:2] - ctr_q[:, 1:2]
    qz = sq_world[:, 2:3] - ctr_q[:, 2:3]
    dx = qx - (tmap.xyz_t[0][slots] - ctr_q[:, 0:1])
    dy = qy - (tmap.xyz_t[1][slots] - ctr_q[:, 1:2])
    dz = qz - (tmap.xyz_t[2][slots] - ctr_q[:, 2:3])
    d = dx * dx + dy * dy + dz * dz
    d = torch.where(ok, d, torch.full_like(d, float("inf")))
    sd, order = torch.sort(d, dim=1, stable=True)
    sd = sd[:, :k]
    idx = torch.take_along_dim(slots, order[:, :k], dim=1).to(torch.int32)
    if sd.shape[1] < k:  # fewer candidate columns than k
        fill = k - sd.shape[1]
        sd = torch.cat([sd, torch.full((q, fill), float("inf"), device=dev)], 1)
        idx = torch.cat([idx, torch.zeros((q, fill), dtype=torch.int32, device=dev)], 1)
    sd = torch.where(processed[:, None], sd, torch.full_like(sd, float("inf")))
    idx = torch.where(torch.isfinite(sd), idx, torch.zeros_like(idx))
    return TiledKnnResult(idx=idx, sqdist=sd)


def _check_cuda_inputs(tmap: TiledMap, sq_world, bounds, nt: int):
    """What both CUDA kernels require of their inputs, beyond ``_check_inputs``."""
    _check_inputs(tmap, sq_world, bounds, nt)
    dev = sq_world.device
    if any(t.device != dev for t in (tmap.xyz_t, tmap.tile_start, bounds, tmap.origin)):
        raise ValueError("map, bounds and queries must be on one device")
    if tmap.tile_start.dtype != torch.int32 or bounds.dtype != torch.int32:
        raise ValueError("tile_start and bounds must be int32")
    if tmap.xyz_t.dtype != torch.float32 or tmap.origin.dtype != torch.float32:
        raise ValueError("xyz_t and origin must be float32")
    if tmap.xyz_t.dim() != 2 or tmap.xyz_t.shape[0] != 4:
        raise ValueError(f"xyz_t must be [4, stride], got {tuple(tmap.xyz_t.shape)}")


def _aligned_coords(xyz_t: torch.Tensor) -> torch.Tensor:
    """``xyz_t`` as the kernels' bulk copies take it: contiguous, 16-byte aligned."""
    xyz_t = xyz_t.contiguous()
    if xyz_t.data_ptr() % 16:
        raise ValueError("xyz_t must start on a 16-byte boundary for the kernels' bulk copies")
    return xyz_t


def _query_tiled_sorted_cuda(
    tmap: TiledMap, sq_world, bounds, nt: int, tile_cells: int, tile_cap: int, k: int
) -> TiledKnnResult:
    """Launch ``csrc/knn_tiled.cu`` on PyTorch's current stream."""
    global KERNEL_LAUNCHES
    from pfilter_tpu_torch.ops import _build

    _check_cuda_inputs(tmap, sq_world, bounds, nt)
    if k != 5:
        raise ValueError(f"the CUDA kNN kernel is built for k=5, got k={k}")
    w = 3 * tile_cap
    if 2 * 9 * ((w + 6) // 4 * 4) * 4 > _SMEM_LIMIT:  # two staged halos of 3 rows x 3 coordinates
        raise ValueError(f"tile_cap={tile_cap}: two staged halos ({3 * w} slots each) exceed shared memory")
    dev = sq_world.device
    xyz_t = _aligned_coords(tmap.xyz_t)
    tile_start = tmap.tile_start.contiguous()
    bounds = bounds.contiguous()
    origin = tmap.origin.contiguous()
    queries = sq_world.contiguous()
    q = queries.shape[0]
    idx = torch.empty((q, k), dtype=torch.int32, device=dev)
    sqdist = torch.empty((q, k), dtype=torch.float32, device=dev)
    if q == 0:
        return TiledKnnResult(idx=idx, sqdist=sqdist)
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = work_list(bounds, nt, CHUNK, q, stream)
    err = _build.load().pf_knn_tiled(
        xyz_t.data_ptr(), xyz_t.shape[1], tile_start.data_ptr(), bounds.data_ptr(), work.data_ptr(),
        origin.data_ptr(), queries.data_ptr(), q, nt, tile_cells, w, CHUNK, idx.data_ptr(), sqdist.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"knn_tiled kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return TiledKnnResult(idx=idx, sqdist=sqdist)


def query_tiled_sorted(
    tmap: TiledMap, sq_world, bounds, nt: int, tile_cells: int, tile_cap: int, k: int = 5
) -> TiledKnnResult:
    """5-NN for tile-sorted queries; results in the same sorted order.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel."""
    if sq_world.device.type == "cuda":
        return _query_tiled_sorted_cuda(tmap, sq_world, bounds, nt, tile_cells, tile_cap, k)
    if sq_world.device.type != "cpu":
        raise ValueError(f"unsupported device {sq_world.device}")
    return query_tiled_sorted_plain(tmap, sq_world, bounds, nt, tile_cells, tile_cap, k)


def query_tiled(
    tmap: TiledMap, q_xyz, q_valid, nt: int, tile_cells: int, tile_cap: int, k: int = 5
) -> TiledKnnResult:
    """Sort queries, run the tiled query, unsort results."""
    qs = sort_queries(q_xyz, q_valid, tmap.origin, nt, tile_cells)
    res = query_tiled_sorted(tmap, q_xyz[qs.order], qs.bounds, nt, tile_cells, tile_cap, k=k)
    d = res.sqdist[qs.inv]
    idx = res.idx[qs.inv]
    d = torch.where(q_valid[:, None], d, torch.full_like(d, float("inf")))
    return TiledKnnResult(idx=idx, sqdist=d)


def query_tiled_reference(tmap: TiledMap, q_xyz, q_valid, k: int = 5) -> TiledKnnResult:
    """Brute force over the whole map (same interface) for tests."""
    d = torch.sum((q_xyz[:, None] - tmap.xyz[None]) ** 2, -1)
    d = torch.where(tmap.valid[None, :], d, torch.full_like(d, float("inf")))
    d = torch.where(q_valid[:, None], d, torch.full_like(d, float("inf")))
    sd, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
    return TiledKnnResult(idx=idx.to(torch.int32), sqdist=sd)
