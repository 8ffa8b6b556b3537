"""Parity of the port's tiled map state (models/map_state.py) with the
reference package: index build, the fused merge (one sort serving the rgbds
re-voxelization and the kNN tile layout), overflow counters.

Tolerance: voxel centroids are segment sums whose order may differ between
the libraries (atol 1e-5 m); everything else — validity, counters, tile
ranges, drop counts — must be equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfilter_tpu.config import CapacityConfig, OdometryConfig, PipelineConfig
from pfilter_tpu.models import map_state as jms
from pfilter_tpu_torch.models import map_state as tms
from torch_parity import n, t, torch_config


def _cfg(**cap):
    return PipelineConfig(
        odometry=OdometryConfig(k_new=0.0, theta_p=0.4, theta_max=75.0, map_resolution=0.4),
        capacity=CapacityConfig(edge_map_points=4096, surf_map_points=8192, edge_tile_cap=128, surf_tile_cap=128, **cap),
    )


def _snap(pts, leaf, rng):
    """Keep points away from voxel boundaries, where fp rounding of two
    differently-ordered computations could flip a voxel assignment."""
    centers = (np.floor(pts / leaf) + 0.5) * leaf
    return (centers + rng.uniform(-0.3, 0.3, pts.shape) * leaf).astype(np.float32)


def _cloud(rng, cap, n_pts, leaf, width=2):
    xyz = np.zeros((cap, 3), np.float32)
    rg = np.zeros((cap, width), np.float32)
    valid = np.zeros(cap, bool)
    pts = rng.uniform(-40, 40, (n_pts, 3))
    pts[:, 2] = rng.uniform(-3, 8, n_pts)
    xyz[:n_pts] = _snap(pts, leaf, rng)
    rg[:n_pts, :2] = rng.integers(0, 30, (n_pts, 2))
    if width > 2:
        rg[:n_pts, 2] = rng.uniform(size=n_pts) > 0.8
    valid[:n_pts] = True
    return xyz, rg, valid


def _assert_maps_equal(tmap, jmap):
    np.testing.assert_array_equal(n(tmap.valid), n(jmap.valid))
    np.testing.assert_array_equal(n(tmap.tile_start), n(jmap.tile_start))
    np.testing.assert_array_equal(n(tmap.rg), n(jmap.rg))
    np.testing.assert_array_equal(n(tmap.origin), n(jmap.origin))
    np.testing.assert_allclose(n(tmap.xyz), n(jmap.xyz), atol=1e-5)
    np.testing.assert_allclose(n(tmap.xyz_t), n(jmap.xyz_t), atol=1e-5)


@pytest.mark.parametrize(
    "kind,leaf_mult,n_map,n_scan,width",
    [("edge", 1.0, 1500, 800, 2), ("surf", 2.0, 3000, 2000, 2), ("surf", 2.0, 2500, 1500, 3), ("edge", 1.0, 3900, 3900, 2)],
)
def test_fused_merge_matches(kind, leaf_mult, n_map, n_scan, width):
    jcfg = _cfg()
    tcfg = torch_config(jcfg)
    leaf = jcfg.odometry.map_resolution * leaf_mult
    rng = np.random.default_rng(n_map + width)
    cap = jms.map_capacity(jcfg, kind)
    mxyz, mrg, mvalid = _cloud(rng, cap, n_map, leaf, width)
    sxyz, srg, svalid = _cloud(rng, 2048 if n_scan <= 2048 else 4096, n_scan, leaf, width)
    pose_t = np.array([1.3, -2.1, 0.4], np.float32)
    jidx = jms.build_index(*(jnp.array(x) for x in (mxyz, mrg, mvalid)), jnp.zeros(3), jcfg, kind)
    tidx = tms.build_index(t(mxyz), t(mrg), t(mvalid), torch.zeros(3), tcfg, kind)
    _assert_maps_equal(tidx, jidx)
    jm, jdrop = jms.merge_scan_into_index(jidx, *(jnp.array(x) for x in (sxyz, srg, svalid, pose_t)), leaf, jcfg, kind)
    tm, tdrop = tms.merge_scan_into_index(tidx, t(sxyz), t(srg), t(svalid), t(pose_t), leaf, tcfg, kind)
    assert int(n(tdrop)) == int(n(jdrop))
    _assert_maps_equal(tm, jm)
    assert int(n(tms.tile_overflow_count(tm, tcfg, kind))) == int(n(jms.tile_overflow_count(jm, jcfg, kind)))
    assert n(tm.valid).sum() > 100


def test_merge_overflow_and_tile_cap_counters():
    jcfg = _cfg()
    jcfg = jcfg.replace(capacity=dataclasses.replace(jcfg.capacity, edge_map_points=512))
    tcfg = torch_config(jcfg)
    rng = np.random.default_rng(11)
    leaf = jcfg.odometry.map_resolution
    mxyz, mrg, mvalid = _cloud(rng, 512, 400, leaf)
    sxyz, srg, svalid = _cloud(rng, 2048, 2000, leaf)
    jidx = jms.build_index(*(jnp.array(x) for x in (mxyz, mrg, mvalid)), jnp.zeros(3), jcfg, "edge")
    tidx = tms.build_index(t(mxyz), t(mrg), t(mvalid), torch.zeros(3), tcfg, "edge")
    jm, jdrop = jms.merge_scan_into_index(jidx, *(jnp.array(x) for x in (sxyz, srg, svalid)), jnp.zeros(3), leaf, jcfg, "edge")
    tm, tdrop = tms.merge_scan_into_index(tidx, t(sxyz), t(srg), t(svalid), torch.zeros(3), leaf, tcfg, "edge")
    assert int(n(tdrop)) == int(n(jdrop)) > 0
    _assert_maps_equal(tm, jm)
    # A dense cluster overflows the kNN tile cap.
    dense = np.zeros((512, 3), np.float32)
    dense[:500] = rng.uniform([0.1, 0.1, 0.0], [3.9, 3.9, 5.0], (500, 3))
    dv = np.arange(512) < 500
    jd = jms.build_index(jnp.array(dense), jnp.zeros((512, 2)), jnp.array(dv), jnp.zeros(3), jcfg, "edge")
    td = tms.build_index(t(dense), torch.zeros((512, 2)), t(dv), torch.zeros(3), tcfg, "edge")
    over = int(n(tms.tile_overflow_count(td, tcfg, "edge")))
    assert over == int(n(jms.tile_overflow_count(jd, jcfg, "edge"))) > 0


def test_empty_index_and_queries_match():
    jcfg = _cfg()
    tcfg = torch_config(jcfg)
    for kind in ("edge", "surf"):
        _assert_maps_equal(tms.empty_index(tcfg, kind, 3), jms.empty_index(jcfg, kind, 3))
    rng = np.random.default_rng(12)
    mxyz, mrg, mvalid = _cloud(rng, 4096, 3000, 0.4)
    mxyz[:3000] = mxyz[:3000] * np.array([0.2, 0.2, 0.3], np.float32)  # dense enough to gate
    tidx = tms.build_index(t(mxyz), t(mrg), t(mvalid), torch.zeros(3), tcfg, "edge")
    q = rng.uniform(-6, 6, (200, 3)).astype(np.float32)
    qv = rng.uniform(size=200) > 0.1
    qs = tms.sort_queries_for_index(tidx, t(q), t(qv), tcfg, "edge")
    i1, d1 = tms.query_index_presorted(tidx, t(q)[qs.order], qs.bounds, tcfg, "edge")
    i2, d2 = tms.query_index(tidx, t(q), t(qv), tcfg, "edge")
    np.testing.assert_array_equal(n(d1)[n(qs.inv)][qv], n(d2)[qv])
    np.testing.assert_array_equal(n(i1)[n(qs.inv)][qv], n(i2)[qv])
    assert np.isfinite(n(d2)[qv, 4]).any()


def test_merge_rejects_unsupported_settings():
    tcfg = torch_config(_cfg(knn_tiles=512))
    idx = tms.empty_index(torch_config(_cfg()), "edge")
    with pytest.raises(ValueError, match="int32"):
        tms.merge_scan_into_index(idx, torch.zeros((8, 3)), torch.zeros((8, 2)), torch.ones(8, dtype=torch.bool), torch.zeros(3), 0.4, tcfg, "edge")
    # The grid index builds; an unknown index raises.
    pts = (torch.zeros((8, 3)), torch.zeros((8, 2)), torch.ones(8, dtype=torch.bool), torch.zeros(3))
    grid = tms.build_index(*pts, torch_config(_cfg(knn_impl="grid")), "edge")
    assert type(grid).__name__ == "HashGrid" and int(grid.valid.sum()) == 8
    with pytest.raises(ValueError, match="knn_impl"):
        tms.build_index(*pts, torch_config(_cfg(knn_impl="kdtree")), "edge")
