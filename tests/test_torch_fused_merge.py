"""The port's map merges: the fused tiled merge against the port's own
unfused chain (crop -> anchored rgbds -> evict -> age), as
``tests/test_fused_merge.py`` holds the reference's; and the port's unfused
grid-index merge (``knn_impl="grid"``), ``merge_scan_into_map``,
``map_from_points`` and ``empty_map`` against the reference's.

Tolerance: the same voxel set, counters and validity exactly; centroids are
segment sums whose order differs between the chains and the libraries, so
they agree within 1e-4 m (fused vs unfused, as the reference's test) and
1e-5 m (port vs reference)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfilter_tpu.config import CapacityConfig, OdometryConfig, PipelineConfig
from pfilter_tpu.models import map_state as jms
from pfilter_tpu_torch.models import map_state as tms
from pfilter_tpu_torch.ops import knn_tiled, voxel
from torch_parity import n, t, torch_config


def _cfg(**cap):
    return PipelineConfig(
        odometry=OdometryConfig(k_new=0.0, theta_p=0.4, theta_max=75.0, map_resolution=0.4),
        capacity=CapacityConfig(edge_map_points=4096, surf_map_points=8192, edge_tile_cap=128, surf_tile_cap=128, **cap),
    )


def _snap(pts, leaf, rng):
    """Points near voxel centres, so fp rounding at voxel boundaries cannot
    flip a voxel between two id computations."""
    centers = (np.floor(pts / leaf) + 0.5) * leaf
    return (centers + rng.uniform(-0.2, 0.2, pts.shape) * leaf).astype(np.float32)


def _random_map(cap, n_pts, seed, leaf):
    rng = np.random.default_rng(seed)
    xyz = np.zeros((cap, 3), np.float32)
    rg = np.zeros((cap, 2), np.float32)
    valid = np.zeros(cap, bool)
    pts = rng.uniform(-40, 40, (n_pts, 3))
    pts[:, 2] = rng.uniform(-3, 8, n_pts)
    xyz[:n_pts] = _snap(pts, leaf, rng)
    rg[:n_pts] = rng.integers(0, 30, (n_pts, 2))
    valid[:n_pts] = True
    return xyz, rg, valid


def _scan(leaf, seed=2, ns=800):
    rng = np.random.default_rng(seed)
    sx = _snap(rng.uniform(-35, 35, (ns, 3)), leaf, rng)
    srg = rng.integers(0, 20, (ns, 2)).astype(np.float32)
    return sx, srg, rng.uniform(size=ns) < 0.9


def _unfused(index, scan_xyz, scan_rg, scan_valid, pose_t, leaf, cfg, kind):
    o = cfg.odometry
    combined = voxel.concat_pointsets(
        voxel.PointSet(index.xyz, index.rg, index.valid), voxel.PointSet(scan_xyz, scan_rg, scan_valid)
    )
    combined = voxel.crop_box(combined, pose_t, o.crop_half_extent)
    ds = voxel.voxel_downsample_rgbds(combined, leaf, tms.map_capacity(cfg, kind), anchor_t=pose_t)
    ds = voxel.evict_unstable(ds, o.k_new, o.theta_p, o.theta_max)
    return voxel.age_points(ds, o.aging_increment, o.counter_cap)


def _as_set(xyz, rg, valid, leaf):
    xyz, rg, valid = n(xyz), n(rg), n(valid)
    return {tuple(np.floor(xyz[i] / leaf).astype(int)): (xyz[i], rg[i]) for i in np.nonzero(valid)[0]}


def _assert_same_set(got, want, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k][0], want[k][0], atol=atol)
        np.testing.assert_array_equal(got[k][1], want[k][1])


@pytest.mark.parametrize("kind,leaf_mult", [("edge", 1.0), ("surf", 2.0)])
def test_fused_merge_matches_unfused(kind, leaf_mult):
    cfg = torch_config(_cfg())
    leaf = cfg.odometry.map_resolution * leaf_mult
    pose_t = torch.tensor([3.3, -1.2, 0.7])
    mx, mrg, mv = _random_map(tms.map_capacity(cfg, kind), 1500, 1, leaf)
    index = tms.build_index(t(mx), t(mrg), t(mv), pose_t, cfg, kind)
    sx, srg, sv = _scan(leaf)
    fused, n_drop = tms.merge_scan_into_index(index, t(sx), t(srg), t(sv), pose_t, leaf, cfg, kind)
    assert int(n_drop) == 0
    ref = _unfused(index, t(sx), t(srg), t(sv), pose_t, leaf, cfg, kind)
    _assert_same_set(_as_set(fused.xyz, fused.rg, fused.valid, leaf), _as_set(ref.xyz, ref.rg, ref.valid, leaf), 1e-4)
    # Tile ranges describe the fused output's layout exactly.
    nt, tc, _ = tms._tile_params(cfg, kind)
    tid = n(knn_tiled._tile_ids(fused.xyz, fused.valid, fused.origin, nt, tc))
    ts = n(fused.tile_start)
    for i in np.nonzero(n(fused.valid))[0]:
        assert ts[tid[i]] <= i < ts[tid[i] + 1]


def test_fused_merge_eviction_and_aging():
    cfg = torch_config(_cfg())
    leaf = cfg.odometry.map_resolution
    cap = tms.map_capacity(cfg, "edge")
    xyz = np.zeros((cap, 3), np.float32)
    rg = np.zeros((cap, 2), np.float32)
    xyz[0], rg[0] = (1.0, 1.0, 1.0), (10.0, 50.0)  # persistent
    xyz[1], rg[1] = (5.0, 5.0, 1.0), (10.0, 1.0)  # evictable: g = 1 < 10 * 0.4
    valid = np.arange(cap) < 2
    index = tms.build_index(t(xyz), t(rg), t(valid), torch.zeros(3), cfg, "edge")
    merged, _ = tms.merge_scan_into_index(index, torch.zeros((4, 3)), torch.zeros((4, 2)), torch.zeros(4, dtype=torch.bool), torch.zeros(3), leaf, cfg, "edge")
    got = _as_set(merged.xyz, merged.rg, merged.valid, leaf)
    assert len(got) == 1
    (k,) = got
    np.testing.assert_allclose(got[k][0], [1.0, 1.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(got[k][1], [12.0, 50.0])  # aging: r 10 -> 12


def _assert_grids_equal(tg, jg, atol):
    for f in ("valid", "rg", "cell_ids", "origin", "cell_size"):
        np.testing.assert_array_equal(n(getattr(tg, f)), np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_allclose(n(tg.xyz), np.asarray(jg.xyz), atol=atol, rtol=0)


@pytest.mark.parametrize("kind,leaf_mult,capacity", [("edge", 1.0, None), ("surf", 2.0, None), ("edge", 1.0, 512)])
def test_unfused_grid_merge_matches_reference(kind, leaf_mult, capacity):
    """``merge_scan_into_index`` on the grid index (the unfused branch),
    with a capacity override that drops voxels."""
    jcfg = _cfg(knn_impl="grid")
    tcfg = torch_config(jcfg)
    leaf = jcfg.odometry.map_resolution * leaf_mult
    pose_t = np.array([3.3, -1.2, 0.7], np.float32)
    cap = capacity or jms.map_capacity(jcfg, kind)
    mx, mrg, mv = _random_map(cap, min(1500, cap - 12), 1, leaf)
    sx, srg, sv = _scan(leaf)
    jidx = jms.build_index(jnp.array(mx), jnp.array(mrg), jnp.array(mv), jnp.array(pose_t), jcfg, kind)
    tidx = tms.build_index(t(mx), t(mrg), t(mv), t(pose_t), tcfg, kind)
    _assert_grids_equal(tidx, jidx, 0.0)
    pose2 = pose_t + np.float32(1.5)
    jm, jd = jms.merge_scan_into_index(jidx, jnp.array(sx), jnp.array(srg), jnp.array(sv), jnp.array(pose2), leaf, jcfg, kind, capacity=capacity)
    tm, td = tms.merge_scan_into_index(tidx, t(sx), t(srg), t(sv), t(pose2), leaf, tcfg, kind, capacity=capacity)
    assert int(n(td)) == int(jd) and ((int(jd) > 0) == (capacity is not None))
    _assert_grids_equal(tm, jm, 1e-5)
    assert n(tm.valid).sum() > 100
    assert int(n(tms.tile_overflow_count(tm, tcfg, kind))) == int(jms.tile_overflow_count(jm, jcfg, kind)) == 0


def test_grid_map_helpers_match_reference():
    """``empty_map``, ``map_from_points``, ``merge_scan_into_map`` and
    ``empty_index`` of a grid config, against the reference; an unknown
    ``knn_impl`` raises."""
    jcfg = _cfg(knn_impl="grid")
    tcfg = torch_config(jcfg)
    _assert_grids_equal(tms.empty_map(300, 1.0), jms.empty_map(300, 1.0), 0.0)
    for kind in ("edge", "surf"):
        _assert_grids_equal(tms.empty_index(tcfg, kind, 3), jms.empty_index(jcfg, kind, 3), 0.0)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-20, 20, (700, 3)).astype(np.float32)
    rg = rng.integers(0, 9, (700, 2)).astype(np.float32)
    v = rng.uniform(size=700) > 0.05
    pose = np.array([0.5, 0.25, 0.1], np.float32)
    jm = jms.map_from_points(jnp.array(pts), jnp.array(rg), jnp.array(v), jnp.array(pose), 1024, 1.0)
    tm = tms.map_from_points(t(pts), t(rg), t(v), t(pose), 1024, 1.0)
    _assert_grids_equal(tm, jm, 0.0)
    with pytest.raises(ValueError, match="exceeds"):
        tms.map_from_points(t(pts), t(rg), t(v), t(pose), 600, 1.0)
    sx, srg, sv = _scan(0.4, seed=6, ns=500)
    o = jcfg.odometry
    jm2 = jms.merge_scan_into_map(jm, jnp.array(sx), jnp.array(srg), jnp.array(sv), jnp.array(pose), 0.4, o, 1024, 1.0)
    tm2 = tms.merge_scan_into_map(tm, t(sx), t(srg), t(sv), t(pose), 0.4, tcfg.odometry, 1024, 1.0)
    _assert_grids_equal(tm2, jm2, 1e-5)
    with pytest.raises(ValueError, match="knn_impl"):
        tms.empty_index(torch_config(dataclasses.replace(_cfg(), capacity=dataclasses.replace(_cfg().capacity, knn_impl="kdtree"))), "edge")
