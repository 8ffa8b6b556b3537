"""Dynamic Curved-Voxel Clustering (DCVC; ref ``curvedVoxel``,
src/additionClass.cpp:60-500, config/config.yaml:49-54).

Port of ``pfilter_tpu/ops/dcvc.py``.  Points go to polar voxels (pitch,
azimuth, range) whose radial bins follow the reference's recurrence
(``range += startR - step*deltaR``, ref :126-133); the reference's sequential
flood fill over the 3x3x3 polar neighbourhood (ref :221-317) becomes
iterated min-label propagation on a dense ``[pitch, azimuth, range]`` grid:
every occupied voxel starts with its own linear id, and each of
``max_iters`` rounds takes the minimum over its occupied 3x3x3 neighbourhood
(azimuth wraps, pitch and range clamp at the edges).  Labels are then
connected-component minima, the reference's partition; clusters of at most
``min_seg`` points are dropped (ref :324-360).

The voxel scatter writes into one spare pitch slab (invalid points), sliced
off afterwards; cluster sizes are counted onto each label's root voxel with
an int32 ``index_put_`` (exact, order-free).

The bins are computed as the reference computes them compiled, which is how
it runs: XLA rewrites a division by a constant into a product with its
reciprocal, so the azimuth bin is ``round(az * (1 / delta_a))``, not
``round(az / delta_a)``.  The two differ by an ulp, and on a scan whose
azimuths lie on a regular grid (the v1 city's 0.2 degrees against
1.2-degree bins) one ray in six sits exactly on a bin's half: there the ulp
decides the bin.  For the same reason the azimuth comes from ``atan2_f32``:
the float32 ``atan2`` of the reference's XLA CPU backend, which is glibc's
``atan2f`` (fdlibm's algorithm), written in float32 elementwise ops, so that
it gives the same bits on the card as on the CPU.  The card's own
``atan2f``, and PyTorch's CPU ``atan2`` (SLEEF's, more often correctly
rounded), differ from it by an ulp on many inputs: with the card's, a third
of a v1 city scan's rays, every BPF path on the card misses the
reference's map sizes by 21-39 % (``tools/torch_dcvc_atan2_ab.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from pfilter_tpu_torch.config import DCVCConfig, LidarConfig

_BIG = 2**30


class DCVCResult(NamedTuple):
    label: torch.Tensor  # [N] int32 cluster label (voxel-id minima); -1 = invalid
    cluster_size: torch.Tensor  # [N] int32 — size of the point's cluster
    keep: torch.Tensor  # [N] bool — valid & cluster_size > minSeg
    n_iters: int = 0  # kept for the reference's API; always its default
    n_vox_dropped: int = 0


def polar_bounds(cfg: DCVCConfig, lidar: LidarConfig, max_bins: int = 256) -> np.ndarray:
    """Static radial bin bounds via the reference's recurrence
    (ref: src/additionClass.cpp:126-133) anchored at the sensor min range."""
    bounds = []
    rng = lidar.min_distance
    step = 1
    while rng <= lidar.max_distance and len(bounds) < max_bins:
        rng += cfg.start_r - step * cfg.delta_r
        bounds.append(rng)
        step += 1
    while len(bounds) < max_bins:  # pad to the static table length
        bounds.append(bounds[-1] if bounds else lidar.max_distance)
    return np.asarray(bounds, np.float32)


def _grid_dims(cfg: DCVCConfig, lidar: LidarConfig, max_polar: int = 256):
    n_az = int(round(360.0 / cfg.delta_a)) + 1
    # Static pitch window: generous band covering 16/32/64-beam sensors.
    pitch_min, pitch_max = -30.0, 15.0
    n_pitch = int(np.ceil((pitch_max - pitch_min) / cfg.delta_p)) + 1
    return n_pitch, n_az, max_polar, pitch_min


@functools.lru_cache(maxsize=8)
def _bounds_on(cfg: DCVCConfig, lidar: LidarConfig, max_bins: int, device: torch.device) -> torch.Tensor:
    """The bounds table on ``device``, copied there once (a copy from host
    memory inside the step would make the host wait)."""
    return torch.from_numpy(polar_bounds(cfg, lidar, max_bins)).to(device)


def _f32(v: float) -> float:
    return float(np.float32(v))


# fdlibm's single-precision constants (s_atanf.c, e_atan2f.c), as float32.
_ATANHI = tuple(map(_f32, (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01, 1.5707962513e00)))
_ATANLO = tuple(map(_f32, (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08, 7.5497894159e-08)))
_AT = tuple(map(_f32, (
    3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01, -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
    6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02, -3.6531571299e-02, 1.6285819933e-02,
)))
_PI, _PI_LO, _PI_O_2 = _f32(3.1415927410e00), _f32(-8.7422776573e-08), _f32(1.5707963705e00)
_HUGE_RATIO = float(np.float32(_PI_O_2) + np.float32(0.5) * np.float32(_PI_LO))  # |y/x| > 2^60


def _poly(w: torch.Tensor, coeffs) -> torch.Tensor:
    """Horner's rule, c0 + w (c1 + w (c2 + ...)), one rounding per operation."""
    acc = w * coeffs[-1]
    for c in coeffs[-2:0:-1]:
        acc = (acc + c) * w
    return acc + coeffs[0]


def _atanf_abs(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's ``atanf`` of ``x >= 0`` (s_atanf.c), float32 operations."""
    ix = x.view(torch.int32)
    one = torch.ones_like(x)
    # Argument reduction: id -1 (|x| < 7/16), 0, 1, 2, 3 (|x| >= 39/16).
    r0 = (2.0 * x - 1.0) / (x + 2.0)
    r1 = (x - 1.0) / (x + 1.0)
    r2 = (x - 1.5) / (1.5 * x + 1.0)
    r3 = -one / x
    ident = ix < 0x3EE00000
    red = torch.where(ix < 0x3F300000, r0, torch.where(ix < 0x3F980000, r1, torch.where(ix < 0x401C0000, r2, r3)))
    red = torch.where(ident, x, red)
    z = red * red
    w = z * z
    s1 = z * _poly(w, _AT[0::2])
    s2 = w * _poly(w, _AT[1::2])
    p = red * (s1 + s2)
    small = red - p
    hi = torch.where(ix < 0x3F300000, _ATANHI[0], torch.where(ix < 0x3F980000, _ATANHI[1], torch.where(ix < 0x401C0000, _ATANHI[2], _ATANHI[3])))
    lo = torch.where(ix < 0x3F300000, _ATANLO[0], torch.where(ix < 0x3F980000, _ATANLO[1], torch.where(ix < 0x401C0000, _ATANLO[2], _ATANLO[3])))
    big = hi - ((p - lo) - red)
    out = torch.where(ident, small, big)
    out = torch.where(ix < 0x31000000, x, out)  # |x| < 2^-29: x
    return torch.where(ix >= 0x4C000000, one * (_ATANHI[3] + _ATANLO[3]), out)  # |x| >= 2^25


def atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``atan2(y, x)`` of float32 tensors as fdlibm computes it in single
    precision (e_atan2f.c, glibc's ``atan2f``, which the reference's XLA CPU
    backend calls): the same bits on every device, since each operation is
    a kernel of its own (no fused multiply-add) rounded to float32.  Finite
    inputs."""
    iy = y.view(torch.int32) & 0x7FFFFFFF
    ix = x.view(torch.int32) & 0x7FFFFFFF
    neg_y, neg_x = torch.signbit(y), torch.signbit(x)
    k = (iy - ix) >> 23
    z = _atanf_abs(torch.abs(y / x))
    z = torch.where(k > 60, torch.full_like(z, _HUGE_RATIO), z)
    z = torch.where(neg_x & (k < -60), torch.zeros_like(z), z)
    zl = z - _PI_LO
    out = torch.where(neg_x, torch.where(neg_y, zl - _PI, _PI - zl), torch.where(neg_y, -z, z))
    pi = torch.full_like(z, _PI)
    out = torch.where(ix == 0, torch.where(neg_y, -_PI_O_2, torch.full_like(z, _PI_O_2)), out)
    return torch.where(iy == 0, torch.where(neg_x, torch.where(neg_y, -pi, pi), y), out)


def _shift_min(x: torch.Tensor, dim: int, wrap: bool) -> torch.Tensor:
    """Min of each cell and its two neighbours along ``dim``."""
    if wrap:
        lo, hi = torch.roll(x, 1, dim), torch.roll(x, -1, dim)
    else:
        n = x.shape[dim]
        lo = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
        hi = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    return torch.minimum(x, torch.minimum(lo, hi))


def _pool(a: torch.Tensor) -> torch.Tensor:
    """3x3x3 min; azimuth wraps, pitch and range clamp."""
    return _shift_min(_shift_min(_shift_min(a, 0, False), 1, True), 2, False)


def cluster(
    xyz: torch.Tensor,
    valid: torch.Tensor,
    cfg: DCVCConfig,
    lidar: LidarConfig,
    max_polar_bins: int = 256,
) -> DCVCResult:
    n_pitch, n_az, n_polar, pitch_min = _grid_dims(cfg, lidar, max_polar_bins)
    dev = xyz.device
    bounds = _bounds_on(cfg, lidar, max_polar_bins, dev)

    # Polar conversion (ref convertToPolar, :81-118).
    r = torch.linalg.vector_norm(xyz, dim=-1)
    ok = valid & (r > lidar.min_distance) & (r < lidar.max_distance)
    safe_r = torch.clamp(r, min=1e-6)
    pitch = torch.rad2deg(torch.asin(torch.clamp(xyz[:, 2] / safe_r, -1.0, 1.0)))
    az = torch.rad2deg(atan2_f32(xyz[:, 1], xyz[:, 0]))
    az = torch.where(az < 0, az + 360.0, az)

    # Products with the float32 reciprocals, as the compiled reference bins.
    ip = torch.clamp(torch.round((pitch - pitch_min) * _f32(np.float32(1.0) / np.float32(cfg.delta_p))).to(torch.int32), 0, n_pitch - 1)
    ia = torch.clamp(torch.round(az * _f32(np.float32(1.0) / np.float32(cfg.delta_a))).to(torch.int32), 0, n_az - 1)
    ir = torch.clamp(torch.searchsorted(bounds, r, right=True).to(torch.int32), 0, n_polar - 1)

    # Dense occupancy (spare pitch slab n_pitch for invalid points).
    lin = (ip * n_az + ia) * n_polar + ir
    sp = torch.where(ok, ip, torch.full_like(ip, n_pitch))
    flat = ((sp * n_az + ia) * n_polar + ir).long()
    vox = torch.full(((n_pitch + 1) * n_az * n_polar,), _BIG, dtype=torch.int32, device=dev)
    vox.scatter_reduce_(0, flat, torch.where(ok, lin, torch.full_like(lin, _BIG)), "amin", include_self=True)
    vox = vox[: n_pitch * n_az * n_polar].reshape(n_pitch, n_az, n_polar)

    # Iterated min-pool over occupied voxels (a fixed count, no host test).
    occupied = vox < _BIG
    big = torch.full_like(vox, _BIG)
    labels = vox
    for _ in range(cfg.max_iters):
        labels = torch.where(occupied, _pool(labels), big)

    # Per-point label and cluster size, counted onto each label's root voxel.
    n_vox = n_pitch * n_az * n_polar
    gather = torch.where(ok, flat, torch.zeros_like(flat))
    plabel = torch.where(ok, labels.reshape(-1)[gather], torch.full_like(lin, _BIG))
    root = torch.where(ok, plabel, torch.full_like(plabel, n_vox)).long()
    counts = torch.zeros(n_vox + 1, dtype=torch.int32, device=dev)
    counts.index_put_((root,), ok.to(torch.int32), accumulate=True)
    csize = torch.where(ok, counts[torch.where(ok, root, torch.zeros_like(root))], torch.zeros_like(lin))

    keep = ok & (csize > cfg.min_seg)
    return DCVCResult(label=torch.where(ok, plabel, torch.full_like(plabel, -1)), cluster_size=csize, keep=keep)
