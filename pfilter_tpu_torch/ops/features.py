"""Ring-based edge/surf feature extraction.

Port of ``pfilter_tpu/ops/features.py`` (ref: src/laserProcessingClass.cpp:10-209):

1. points are stably sorted by ring id into a dense ``[rings, ring_cap]``
   grid (azimuth order preserved within each ring),
2. curvature is an 11-tap window sum,
3. the sequential pick-and-suppress loop is a fixed 20 iterations of masked
   argmax per (ring, sector) over each sector's curvature-sorted candidates,
4. suppression is a precomputed reach range, clipped to the pick's sector.

The masks equal the reference package's bit for bit on the same scan: the
same fp32 arithmetic in the same order, stable sorts on the same keys, and
first-index argmax tie-breaking.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pfilter_tpu_torch.config import CapacityConfig, FeatureConfig, LidarConfig


class RingGrid(NamedTuple):
    """Scan points laid out densely by (ring, azimuth rank)."""

    xyz: torch.Tensor  # [R, C, 3]
    valid: torch.Tensor  # [R, C] bool
    length: torch.Tensor  # [R] int32 — number of valid points in each ring


class FeatureResult(NamedTuple):
    """Edge/surf feature masks over the flattened ring grid."""

    xyz: torch.Tensor  # [R*C, 3]
    edge_mask: torch.Tensor  # [R*C] bool
    surf_mask: torch.Tensor  # [R*C] bool
    curvature: torch.Tensor  # [R*C] float32
    ring: torch.Tensor  # [R*C] int32


def ring_ids(xyz: torch.Tensor, mask: torch.Tensor, lidar: LidarConfig):
    """Vertical-angle ring assignment (ref: src/laserProcessingClass.cpp:22-64).
    Returns (ring [N] int32, valid [N] bool); invalid points get ring N."""
    n = lidar.num_lines
    dist = torch.sqrt(xyz[:, 0] ** 2 + xyz[:, 1] ** 2)
    in_range = (dist >= lidar.min_distance) & (dist <= lidar.max_distance)
    angle = torch.rad2deg(torch.atan2(xyz[:, 2], dist))

    if n == 16:
        ring = ((angle + 15.0) / 2.0 + 0.5).to(torch.int32)
        ok = (ring >= 0) & (ring <= n - 1)
    elif n == 32:
        ring = ((angle + 92.0 / 3.0) * 3.0 / 4.0).to(torch.int32)
        ok = (ring >= 0) & (ring <= n - 1)
    elif n == 64:
        upper = ((2.0 - angle) * 3.0 + 0.5).to(torch.int32)
        lower = n // 2 + ((-8.83 - angle) * 2.0 + 0.5).to(torch.int32)
        ring = torch.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (ring >= 0) & (ring <= 63)
    else:
        raise ValueError(f"unsupported num_lines={n} (reference supports 16/32/64)")

    valid = mask & in_range & ok
    return torch.where(valid, ring, torch.full_like(ring, n)).to(torch.int32), valid


def _ring_gather(ring: torch.Tensor, R: int, C: int):
    """Stable ring sort plus the dense-grid gather indices: ring r's points
    are the sorted run [ring_start[r], ring_start[r+1]), so slot (r, c) reads
    sorted row ring_start[r] + c.  Returns (order, src [R,C], in_run, run_len)."""
    order = torch.argsort(ring, stable=True)  # invalid (ring == R) sort last
    sorted_ring = ring[order]
    ring_start = torch.searchsorted(
        sorted_ring, torch.arange(R + 1, dtype=torch.int32, device=ring.device)
    ).to(torch.int32)
    run_len = ring_start[1:] - ring_start[:-1]
    slot_c = torch.arange(C, dtype=torch.int32, device=ring.device)[None, :]
    src = ring_start[:-1, None] + slot_c
    in_run = slot_c < run_len[:, None]
    src = torch.clamp(src, max=ring.shape[0] - 1)
    return order, src, in_run, run_len


def bin_rings(xyz: torch.Tensor, mask: torch.Tensor, lidar: LidarConfig, cap: CapacityConfig) -> RingGrid:
    """Gather points into a dense [rings, ring_cap] grid, preserving the
    original (azimuth) order within each ring via a stable sort."""
    R, C = lidar.num_lines, cap.ring_points
    ring, _ = ring_ids(xyz, mask, lidar)
    order, src, in_run, run_len = _ring_gather(ring, R, C)
    dense = xyz[order][src.reshape(-1).long()].reshape(R, C, 3)
    dense = torch.where(in_run[..., None], dense, torch.zeros_like(dense))
    length = torch.clamp(run_len, max=C).to(torch.int32)
    return RingGrid(xyz=dense, valid=in_run, length=length)


def bin_extra(xyz, mask, extra, lidar: LidarConfig, cap: CapacityConfig) -> torch.Tensor:
    """Route a per-point channel through the same dense ring-grid gather as
    :func:`bin_rings`, flattened to [R*C] and aligned with
    ``FeatureResult.xyz`` (carries the renderer's mover-origin mask)."""
    R, C = lidar.num_lines, cap.ring_points
    ring, _ = ring_ids(xyz, mask, lidar)
    order, src, in_run, _ = _ring_gather(ring, R, C)
    dense = extra[order][src.reshape(-1).long()].reshape(R, C)
    dense = torch.where(in_run, dense, torch.zeros_like(dense))
    return dense.reshape(-1)


def _window_sum(x: torch.Tensor, half: int) -> torch.Tensor:
    """Sum over a (2*half+1)-tap window along axis 1 (zero padded), added
    tap by tap in the reference's order."""
    c = x.shape[1]
    pad = F.pad(x, (0, 0, half, half))
    out = torch.zeros_like(x)
    for k in range(2 * half + 1):
        out = out + pad[:, k : k + c]
    return out


def ring_curvature(grid: RingGrid, feat: FeatureConfig):
    """11-point curvature (ref: src/laserProcessingClass.cpp:73-80):
    ``|sum_{k=-5..5} p[j+k] - 11 p[j]|^2`` over positions with a full window.
    Returns (curvature [R, C], curv_valid [R, C])."""
    h = feat.curvature_half_window
    diff = _window_sum(grid.xyz, h) - (2 * h + 1) * grid.xyz
    curv = torch.sum(diff * diff, dim=-1)
    c = grid.xyz.shape[1]
    pos = torch.arange(c, dtype=torch.int32, device=curv.device)[None, :]
    ln = grid.length[:, None]
    curv_valid = grid.valid & (pos >= h) & (pos < ln - h) & (ln >= feat.min_ring_points)
    return curv, curv_valid


def _suppression_reach(grid: RingGrid, feat: FeatureConfig):
    """For every ring position, how far the +-5 suppression chain extends
    (ref: src/laserProcessingClass.cpp:128-145 — the walk stops at the first
    inter-point gap > 0.05 m^2).

    gap_ok[j] == True when ||p[j] - p[j-1]||^2 <= threshold (j >= 1).
    reach_right[j] = number of leading True in gap_ok[j+1 .. j+5]
    reach_left[j]  = number of leading True in gap_ok[j, j-1, .. j-4]
    """
    t = feat.suppression_gap_sq
    rr = feat.suppression_radius
    d = grid.xyz[:, 1:] - grid.xyz[:, :-1]
    gap_ok_core = (torch.sum(d * d, -1) <= t) & grid.valid[:, 1:] & grid.valid[:, :-1]
    gap_ok = F.pad(gap_ok_core, (1, 0))  # gap_ok[j] about (j-1, j)

    C = grid.xyz.shape[1]
    right = torch.zeros(grid.valid.shape, dtype=torch.int32, device=d.device)
    chain = torch.ones(grid.valid.shape, dtype=torch.bool, device=d.device)
    padded = F.pad(gap_ok, (0, rr))
    for k in range(1, rr + 1):
        chain = chain & padded[:, k : k + C]
        right = right + chain.to(torch.int32)

    left = torch.zeros(grid.valid.shape, dtype=torch.int32, device=d.device)
    chain = torch.ones(grid.valid.shape, dtype=torch.bool, device=d.device)
    padded_l = F.pad(gap_ok, (rr, 0))
    for k in range(rr):
        chain = chain & padded_l[:, rr - k : rr - k + C]
        left = left + chain.to(torch.int32)
    return left, right


def extract_features(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    lidar: LidarConfig,
    feat: FeatureConfig,
    cap: CapacityConfig,
) -> FeatureResult:
    """Full feature extraction (ref: featureExtraction +
    featureExtractionFromSector, src/laserProcessingClass.cpp:10-209).
    Returns edge/surf masks over the flattened dense ring grid."""
    dev = xyz.device
    grid = bin_rings(xyz, mask, lidar, cap)
    curv, curv_valid = ring_curvature(grid, feat)
    reach_l, reach_r = _suppression_reach(grid, feat)

    R, C = curv.shape
    S = feat.num_sectors
    i32 = torch.int32
    pos = torch.arange(C, dtype=i32, device=dev)[None, :]
    h = feat.curvature_half_window
    total = torch.clamp(grid.length - 2 * h, min=1)[:, None]  # curvature points per ring
    sector_len = torch.clamp(total // S, min=1)
    sector_id = torch.clamp((pos - h) // sector_len, 0, S - 1)
    sector_id = torch.where(curv_valid, sector_id, torch.full_like(sector_id, -1))

    threshold = feat.edge_curvature_threshold
    K = feat.pick_candidates
    T = feat.max_edge_per_sector

    # Candidate compaction: sort each ring by (sector, candidate-first,
    # curvature desc) — two stable sorts, minor key first — so each sector's
    # pickable points form a contiguous descending-curvature run with an
    # ascending-position tie-break.
    cand = curv_valid & (curv > threshold)
    pk = torch.where(
        sector_id >= 0,
        sector_id * 2 + torch.where(cand, 0, 1).to(i32),
        torch.full_like(sector_id, 2 * S),
    ).to(i32)
    neg_curv = torch.where(cand, -curv, torch.full_like(curv, 3.0e38))
    o1 = torch.argsort(neg_curv, dim=1, stable=True)
    o2 = torch.argsort(torch.take_along_dim(pk, o1, dim=1), dim=1, stable=True)
    spos = torch.take_along_dim(o1, o2, dim=1).to(i32)

    # Per-(ring, key) counts -> start offset of each sector's candidate run.
    keys = torch.arange(2 * S + 1, dtype=i32, device=dev)
    cnts = torch.sum(pk[:, :, None] == keys[None, None, :], dim=1, dtype=i32)
    starts = torch.cumsum(cnts, dim=1, dtype=i32) - cnts  # exclusive prefix
    cand_start = starts[:, 0 : 2 * S : 2]  # [R, S]
    n_cand = cnts[:, 0 : 2 * S : 2]  # [R, S]

    klane = torch.arange(K, dtype=i32, device=dev)[None, None, :]
    idx = torch.clamp(cand_start[:, :, None] + klane, max=C - 1)  # [R,S,K]
    cmask = klane < n_cand[:, :, None]
    cpos = torch.take_along_dim(spos, idx.reshape(R, S * K).long(), dim=1).reshape(R, S, K)
    flat_cpos = cpos.reshape(R, S * K).long()
    creach_l = torch.take_along_dim(reach_l, flat_cpos, dim=1).reshape(R, S, K)
    creach_r = torch.take_along_dim(reach_r, flat_cpos, dim=1).reshape(R, S, K)

    # Pick-and-suppress: candidates are descending-curvature, so "highest
    # unsuppressed curvature" == "first available slot"; suppression is a
    # position-range mask within the (ring, sector) block (the reference's
    # picked_points set is sector-local, src/laserProcessingClass.cpp:110-148).
    avail = cmask
    edge_c = torch.zeros((R, S, K), dtype=torch.bool, device=dev)
    lo_t, hi_t, found_t = [], [], []
    for _ in range(T):
        j = torch.argmax(avail.to(torch.uint8), dim=2, keepdim=True)  # first available
        found = avail.any(dim=2)
        p = torch.take_along_dim(cpos, j, dim=2)[..., 0]
        rl = torch.take_along_dim(creach_l, j, dim=2)[..., 0]
        rr = torch.take_along_dim(creach_r, j, dim=2)[..., 0]
        lo = p - rl
        hi = p + rr
        supp = (cpos >= lo[..., None]) & (cpos <= hi[..., None]) & found[..., None]
        avail = avail & ~supp
        edge_c = edge_c | ((klane == j) & found[..., None])
        lo_t.append(lo)
        hi_t.append(hi)
        found_t.append(found)
    lo_t = torch.stack(lo_t)  # [T,R,S]
    hi_t = torch.stack(hi_t)
    found_t = torch.stack(found_t)

    # Full-grid suppression mask via a difference array: each pick marks
    # [lo, hi] clipped to its own sector's position span; everything marked
    # is excluded from the surf cloud (src/laserProcessingClass.cpp:198-205).
    srange = torch.arange(S, dtype=i32, device=dev)[None, :]
    sec_lo = h + srange * sector_len  # [R, S]
    sec_hi = torch.where(srange == S - 1, torch.full_like(sec_lo, C - 1), h + (srange + 1) * sector_len - 1)
    lo_c = torch.clamp(torch.maximum(lo_t, sec_lo[None]), 0, C - 1)
    hi_c = torch.clamp(torch.minimum(hi_t, sec_hi[None]), 0, C - 1)
    r_trs = torch.arange(R, device=dev)[None, :, None].expand(T, R, S)
    fint = found_t.to(i32)
    diff = torch.zeros((R, C + 1), dtype=i32, device=dev)
    diff.index_put_((r_trs.reshape(-1), lo_c.reshape(-1).long()), fint.reshape(-1), accumulate=True)
    diff.index_put_((r_trs.reshape(-1), (hi_c + 1).reshape(-1).long()), -fint.reshape(-1), accumulate=True)
    picked = torch.cumsum(diff[:, :C], dim=1) > 0

    # Edge mask: scatter the picked candidates' positions (column C = dropped).
    # scatter_ takes the value as a kernel argument: no host-to-device copy.
    edge_sel = torch.zeros((R, C + 1), dtype=torch.bool, device=dev)
    col = torch.where(edge_c, cpos, torch.full_like(cpos, C)).long()
    edge_sel.scatter_(1, col.reshape(R, S * K), True)
    edge_sel = edge_sel[:, :C]

    surf_sel = curv_valid & ~picked
    if feat.surf_decimate > 1:
        surf_sel = surf_sel & (pos % feat.surf_decimate == 0)
    return FeatureResult(
        xyz=grid.xyz.reshape(-1, 3),
        edge_mask=edge_sel.reshape(-1),
        surf_mask=surf_sel.reshape(-1),
        curvature=torch.where(curv_valid, curv, torch.zeros_like(curv)).reshape(-1),
        ring=torch.arange(R, dtype=i32, device=dev)[:, None].expand(R, C).reshape(-1),
    )
