"""The port's voxel ops (``pfilter_tpu_torch/ops/voxel.py``) against the
reference's ``pfilter_tpu.ops.voxel`` on the same numpy inputs: twins of
``tests/test_voxel.py`` and the ops the unfused map merge and the sharded map
use (crop, eviction, aging, anchored voxel ids, the spatial hash, the
anchored downsample).

Tolerance: masks, ids, hashes, counters and drop counts must be equal;
centroids are segment sums whose order may differ between the libraries,
so they agree within 1e-5 m."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfilter_tpu.ops import voxel as jvox
from pfilter_tpu_torch.ops import voxel as tvox
from torch_parity import n, t


def _points(rng, n_pts, cap, scale=20.0):
    xyz = rng.uniform(-scale, scale, size=(cap, 3)).astype(np.float32)
    rg = rng.integers(0, 50, size=(cap, 2)).astype(np.float32)
    valid = np.arange(cap) < n_pts
    return xyz, rg, valid


def _both(xyz, rg, valid):
    return jvox.PointSet(jnp.array(xyz), jnp.array(rg), jnp.array(valid)), tvox.PointSet(t(xyz), t(rg), t(valid))


def _assert_sets(tps, jps, atol=0.0):
    np.testing.assert_array_equal(n(tps.valid), np.asarray(jps.valid))
    np.testing.assert_array_equal(n(tps.rg), np.asarray(jps.rg))
    np.testing.assert_allclose(n(tps.xyz), np.asarray(jps.xyz), atol=atol, rtol=0)


@pytest.mark.parametrize("anchored", [False, True])
def test_voxel_downsample_matches_reference(anchored):
    rng = np.random.default_rng(0)
    j, tp = _both(*_points(rng, 700, 1024, scale=10.0))
    anchor = np.array([1.7, -3.2, 0.4], np.float32)
    kw_j = {"anchor_t": jnp.array(anchor)} if anchored else {}
    kw_t = {"anchor_t": t(anchor)} if anchored else {}
    jo, jd = jvox.voxel_downsample_rgbds_counted(j, 2.0, 512, **kw_j)
    to, td = tvox.voxel_downsample_rgbds_counted(tp, 2.0, 512, **kw_t)
    assert int(n(td)) == int(jd)
    _assert_sets(to, jo, atol=1e-5)
    assert 0 < int(n(to.valid).sum()) < 700
    # Compaction: valid slots first.
    k = int(n(to.valid).sum())
    assert n(to.valid)[:k].all() and not n(to.valid)[k:].any()


def test_voxel_downsample_empty():
    out = tvox.voxel_downsample_rgbds(tvox.empty_pointset(64), 1.0, 32)
    assert int(n(out.valid).sum()) == 0
    jout = jvox.voxel_downsample_rgbds(jvox.empty_pointset(64), 1.0, out_cap=32)
    _assert_sets(out, jout)


def test_crop_box():
    rng = np.random.default_rng(1)
    j, tp = _both(*_points(rng, 1000, 1024, scale=150.0))
    center = np.array([10.0, -5.0, 0.0], np.float32)
    _assert_sets(tvox.crop_box(tp, t(center), 100.0), jvox.crop_box(j, jnp.array(center), 100.0))
    inside = np.all(np.abs(n(tp.xyz) - center) <= 100.0, -1)
    np.testing.assert_array_equal(n(tvox.crop_box(tp, t(center), 100.0).valid), n(tp.valid) & inside)


def test_persistence_predicate_and_eviction():
    """Evict iff g < r*theta_p && r > k_new && g < theta_max+1 (ref :12-13)."""
    rg = np.array([[10.0, 2.0], [10.0, 5.0], [0.0, 0.0], [255.0, 80.0], [255.0, 60.0]], np.float32)
    keep = tvox.persistence_keep(t(rg), 0.0, 0.4, 75.0)
    np.testing.assert_array_equal(n(keep), [False, True, True, True, False])
    rng = np.random.default_rng(5)
    j, tp = _both(rng.uniform(-5, 5, (300, 3)).astype(np.float32), rng.integers(0, 256, (300, 2)).astype(np.float32), rng.uniform(size=300) > 0.2)
    _assert_sets(tvox.evict_unstable(tp, 0.0, 0.4, 75.0), jvox.evict_unstable(j, 0.0, 0.4, 75.0))


def test_floam_mode_never_evicts():
    rg = np.random.default_rng(2).integers(0, 256, size=(100, 2)).astype(np.float32)
    assert bool(n(tvox.persistence_keep(t(rg), 0.0, 0.0, 0.0)).all())


def test_aging():
    rg = np.array([[0.0, 1.0], [248.0, 0.0], [251.0, 0.0], [255.0, 3.0], [7.0, 1.0]], np.float32)
    valid = np.array([True, True, True, True, False])
    j, tp = _both(np.zeros((5, 3), np.float32), rg, valid)
    out = tvox.age_points(tp)
    _assert_sets(out, jvox.age_points(j))
    np.testing.assert_allclose(n(out.rg[:, 0]), [2.0, 250.0, 255.0, 255.0, 7.0])
    np.testing.assert_allclose(n(out.rg[:, 1]), rg[:, 1])
    _assert_sets(tvox.age_points(tp, 3.0, 100.0), jvox.age_points(j, 3.0, 100.0))


def test_rgbds_counted_overflow():
    xyz = np.zeros((100, 3), np.float32)
    xyz[:, 0] = np.arange(100) * 1.0 + 0.25  # 100 distinct 0.5 m voxels
    ps = tvox.PointSet(t(xyz), torch.zeros((100, 2)), torch.ones(100, dtype=torch.bool))
    out, dropped = tvox.voxel_downsample_rgbds_counted(ps, 0.5, out_cap=64)
    assert int(dropped) == 36 and int(out.valid.sum()) == 64
    assert int(tvox.voxel_downsample_rgbds_counted(ps, 0.5, out_cap=128)[1]) == 0


def test_anchored_ids_and_spatial_hash():
    """Anchored ids (absolute voxels in a 512^3 window around the anchor,
    points outside it get the sentinel) and the XOR-of-primes hash, whose
    int32 products wrap, equal the reference's; with non-finite points."""
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-150.0, 150.0, (2000, 3)).astype(np.float32)
    xyz[:5] = [[np.nan, 0, 0], [np.inf, 1, 1], [-np.inf, 2, 2], [1e12, 3, 3], [0.2, 0.2, 0.2]]
    valid = rng.uniform(size=2000) > 0.1
    anchor = np.array([12.3, -40.1, 1.7], np.float32)
    for leaf in (0.4, 0.8):
        ji = jvox.voxel_ids_anchored(jnp.array(xyz[5:]), jnp.array(valid[5:]), leaf, jnp.array(anchor))
        ti = tvox.voxel_ids_anchored(t(xyz[5:]), t(valid[5:]), leaf, t(anchor))
        np.testing.assert_array_equal(n(ti), np.asarray(ji))
        assert (n(ti) == tvox.INVALID_ID).any() and (n(ti) != tvox.INVALID_ID).any()
        jh = jvox.spatial_hash(jnp.array(xyz[5:]), leaf)
        th = tvox.spatial_hash(t(xyz[5:]), leaf)
        np.testing.assert_array_equal(n(th), np.asarray(jh))
        assert (n(th) >= 0).all()
    # Non-finite and far points: the same ids as the reference's saturating
    # cast gives (NaN reads as voxel 0; +-inf and 1e12 m fall outside the
    # window); the port clamps before its cast, so its hashes stay defined.
    ti = n(tvox.voxel_ids_anchored(t(xyz[:5]), torch.ones(5, dtype=torch.bool), 0.4, t(anchor)))
    ji = np.asarray(jvox.voxel_ids_anchored(jnp.array(xyz[:5]), jnp.ones(5, bool), 0.4, jnp.array(anchor)))
    np.testing.assert_array_equal(ti, ji)
    assert (ti[1:4] == tvox.INVALID_ID).all() and ti[4] != tvox.INVALID_ID
    assert (n(tvox.spatial_hash(t(xyz[:5]), 0.4)) >= 0).all()
