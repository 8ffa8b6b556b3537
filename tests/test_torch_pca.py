"""Parity of the port's neighbourhood PCA (ops/pca_radius.py, pca_classify.py,
pca_voxel.py) with the reference package, and of the CUDA moment kernel with
its plain version (on a card only).

Radius moments against the Pallas kernel (interpret mode) at
``tests/test_pca.py``'s NT=8 shapes, with the bounds of ``test_pca.py:45-52``:
counts exact except boundary points, mean 1e-4, covariance 1e-3.  A
boundary point is a candidate whose squared distance lies within 1e-5 of r^2:
the Pallas kernel takes d^2 from an augmented-coordinate matmul, the port from
``dx*dx + dy*dy + dz*dz``, so the two may put it on either side: a row with
such points may differ in count by at most their number, and its mean and
covariance are not compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfilter_tpu.config import PCAClassifyConfig
from pfilter_tpu.ops import knn_tiled as jknn
from pfilter_tpu.ops import pca_classify as jcls
from pfilter_tpu.ops import pca_radius as jpr
from pfilter_tpu.ops import pca_voxel as jvox
from pfilter_tpu_torch.config import PCAClassifyConfig as TPCAClassifyConfig
from pfilter_tpu_torch.ops import knn_tiled as tknn
from pfilter_tpu_torch.ops import pca_classify as tcls
from pfilter_tpu_torch.ops import pca_radius as tpr
from pfilter_tpu_torch.ops import pca_voxel as tvox
from torch_parity import n, t

NT = 8
TILE_CELLS = 4
BOUNDARY = 1e-5


def _tiled(xyz, valid, tile_cap):
    cap = len(xyz)
    jorigin = jknn.tile_origin_for_pose(jnp.zeros(3), NT, TILE_CELLS)
    jmap = jknn.build_tiled(jnp.asarray(xyz), jnp.zeros((cap, 2)), jnp.asarray(valid), jorigin, NT, TILE_CELLS, tile_cap)
    torigin = tknn.tile_origin_for_pose(torch.zeros(3), NT, TILE_CELLS)
    tmap = tknn.build_tiled(t(xyz), torch.zeros((cap, 2)), t(valid), torigin, NT, TILE_CELLS, tile_cap)
    return jmap, tmap


def _cloud(case):
    rng = np.random.default_rng(0)
    if case == "uniform":  # test_pca.py's cloud
        xyz = rng.uniform(-10, 10, size=(800, 3)).astype(np.float32)
        valid = np.ones(800, bool)
        valid[::7] = False
        return xyz, valid, 256
    # One 3-tile row packed far past 3*tile_cap (plus a sparse background):
    # the capping of each halo row is compared, not just the sums.
    dense = rng.uniform([0.1, -5.9, -1.0], [3.9, 5.9, 1.0], size=(1200, 3))
    sparse = rng.uniform(-12, 12, size=(300, 3))
    xyz = np.concatenate([dense, sparse]).astype(np.float32)
    valid = rng.uniform(size=len(xyz)) > 0.05
    return xyz, valid, 128


def _boundary_points(xyz, valid, radius):
    """Per query, the number of valid points within BOUNDARY of its ball's
    surface (in squared distance)."""
    d = np.sum((xyz[:, None].astype(np.float64) - xyz[None].astype(np.float64)) ** 2, -1)
    near = (np.abs(d - radius * radius) < BOUNDARY) & valid[None, :]
    return near.sum(1)


@pytest.mark.parametrize("case", ["uniform", "row_over_cap"])
def test_radius_moments_match_pallas(case):
    xyz, valid, tile_cap = _cloud(case)
    jmap, tmap = _tiled(xyz, valid, tile_cap)
    want = jpr.radius_pca_moments(jmap, jnp.asarray(xyz), jnp.asarray(valid), NT, TILE_CELLS, tile_cap, radius=1.0, interpret=True)
    got = tpr.radius_pca_moments(tmap, t(xyz), t(valid), NT, TILE_CELLS, tile_cap, radius=1.0)
    trunc = int(n(tknn.halo_overflow(tmap, NT, 3 * tile_cap)))
    if case == "row_over_cap":
        assert trunc > 500  # rows are capped: the comparison covers the cap
    else:
        assert trunc == 0
    n_edge = _boundary_points(xyz, valid, 1.0)
    edge = n_edge > 0
    ok = valid & ~edge
    np.testing.assert_array_equal(n(got.count)[ok], np.asarray(want.count)[ok])
    d_count = np.abs(n(got.count) - np.asarray(want.count))
    assert np.all(d_count[valid & edge] <= n_edge[valid & edge])
    np.testing.assert_array_equal(n(got.count)[~valid], 0)
    m = ok & (np.asarray(want.count) > 0)
    np.testing.assert_allclose(n(got.mean)[m], np.asarray(want.mean)[m], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(got.cov)[m], np.asarray(want.cov)[m], rtol=1e-3, atol=1e-3)
    # The plain entry point is the same function on the CPU.
    plain = tpr.radius_pca_moments_plain(tmap, t(xyz), t(valid), NT, TILE_CELLS, tile_cap, radius=1.0)
    for a, b in zip(plain, got):
        np.testing.assert_array_equal(n(a), n(b))


def test_radius_moments_without_cap_match_bruteforce():
    """Where no row is capped, the moments are the exact-ball ones."""
    xyz, valid, tile_cap = _cloud("uniform")
    jmap, tmap = _tiled(xyz, valid, tile_cap)
    want = jpr.radius_pca_moments_reference(jmap, jnp.asarray(xyz), jnp.asarray(valid), radius=1.0)
    got = tpr.radius_pca_moments(tmap, t(xyz), t(valid), NT, TILE_CELLS, tile_cap, radius=1.0)
    np.testing.assert_array_equal(n(got.count)[valid], np.asarray(want.count)[valid])
    m = valid & (np.asarray(want.count) > 0)
    np.testing.assert_allclose(n(got.mean)[m], np.asarray(want.mean)[m], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(got.cov)[m], np.asarray(want.cov)[m], rtol=1e-3, atol=1e-3)


def test_empty_and_invalid_queries_give_zero_moments():
    xyz = np.zeros((64, 3), np.float32)
    valid = np.zeros(64, bool)
    _, tmap = _tiled(xyz, valid, 128)
    got = tpr.radius_pca_moments(tmap, t(xyz), t(valid), NT, TILE_CELLS, 128)
    for x in got:
        assert not n(x).any()


def _structures(rng):
    """test_pca.py's pillar, beam, facade and blob."""
    pillar = np.column_stack([rng.normal(5, 0.03, 120), rng.normal(5, 0.03, 120), rng.uniform(0, 4, 120)])
    beam = np.column_stack([rng.uniform(-8, -2, 120), rng.normal(3, 0.03, 120), rng.normal(2.0, 0.03, 120)])
    facade = np.column_stack([rng.uniform(-6, 0, 1500), rng.normal(-5, 0.03, 1500), rng.uniform(0, 4, 1500)])
    blob = rng.normal([8, -8, 1], 0.5, size=(150, 3))
    return np.concatenate([pillar, beam, facade, blob]).astype(np.float32)


def test_classify_masks_match_on_structures():
    xyz = _structures(np.random.default_rng(1))
    valid = np.ones(len(xyz), bool)
    jmap, tmap = _tiled(xyz, valid, 256)
    jm = jpr.radius_pca_moments(jmap, jnp.asarray(xyz), jnp.asarray(valid), NT, TILE_CELLS, 256, radius=1.0, interpret=True)
    tm = tpr.radius_pca_moments(tmap, t(xyz), t(valid), NT, TILE_CELLS, 256, radius=1.0)
    # Classify the same moments in both packages: the masks are equal.
    jc = jcls.classify(jnp.asarray(xyz), jnp.asarray(valid), jm, PCAClassifyConfig())
    tc = tcls.classify(t(xyz), t(valid), tpr.PCAMoments(*(t(np.asarray(x)) for x in jm)), TPCAClassifyConfig())
    for f in ("beam_mask", "pillar_mask", "facade_mask"):
        np.testing.assert_array_equal(n(getattr(tc, f)), np.asarray(getattr(jc, f)), err_msg=f)
    np.testing.assert_allclose(n(tc.linearity), np.asarray(jc.linearity), atol=1e-4)
    # And on the port's own moments, within a handful of points.
    tc2 = tcls.classify(t(xyz), t(valid), tm, TPCAClassifyConfig())
    for f in ("beam_mask", "pillar_mask", "facade_mask"):
        assert (n(getattr(tc2, f)) != np.asarray(getattr(jc, f))).sum() <= 3, f
    assert n(tc2.pillar_mask).sum() > 50 and n(tc2.facade_mask).sum() > 500


@pytest.mark.parametrize("offset", [(0.0, 0.0, 0.0), (55.0, -62.0, 3.0)])
def test_voxel_moments_match(offset):
    """test_pca.py's cloud, near the origin and at world-scale coordinates.
    Same-order float sums up to rounding: count exact, mean 1e-5 m, cov
    1e-4 relative."""
    rng = np.random.default_rng(1)
    xyz = (rng.uniform(-8, 8, size=(600, 3)) + np.array(offset)).astype(np.float32)
    valid = np.ones(600, bool)
    valid[::9] = False
    want = jvox.voxel_pca_moments(jnp.asarray(xyz), jnp.asarray(valid), leaf=0.7)
    got = tvox.voxel_pca_moments(t(xyz), t(valid), leaf=0.7)
    np.testing.assert_array_equal(n(got.count), np.asarray(want.count))
    np.testing.assert_allclose(n(got.mean), np.asarray(want.mean), atol=1e-5)
    np.testing.assert_allclose(n(got.cov), np.asarray(want.cov), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("max_voxels", [16384, 64])
def test_voxel_classify_matches(max_voxels):
    """Classes on the structures equal the reference's; with 64 rows the
    table overflows and both count the same dropped voxels."""
    xyz = _structures(np.random.default_rng(2))
    valid = np.ones(len(xyz), bool)
    want = jvox.voxel_pca_classify(jnp.asarray(xyz), jnp.asarray(valid), PCAClassifyConfig(), max_voxels=max_voxels)
    got = tvox.voxel_pca_classify(t(xyz), t(valid), TPCAClassifyConfig(), max_voxels=max_voxels)
    for f in ("beam_mask", "pillar_mask", "facade_mask", "n_voxel_dropped"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    assert (int(n(got.n_voxel_dropped)) > 0) == (max_voxels == 64)
    if max_voxels > 64:
        assert n(got.facade_mask).sum() > 500


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version: counts exact; means within
    1e-4 m and scatter covariances within 1e-3 m^2 per neighbour (the sums
    differ only in summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the moment kernel is built for sm_90a and has no CPU mode")
    dev = torch.device("cuda")
    for case in ("uniform", "row_over_cap"):
        xyz, valid, tile_cap = _cloud(case)
        origin = tknn.tile_origin_for_pose(torch.zeros(3, device=dev), NT, TILE_CELLS)
        x, v = t(xyz).to(dev), t(valid).to(dev)
        tmap = tknn.build_tiled(x, torch.zeros((len(xyz), 2), device=dev), v, origin, NT, TILE_CELLS, tile_cap)
        launches = tpr.KERNEL_LAUNCHES
        a = tpr.radius_pca_moments(tmap, x, v, NT, TILE_CELLS, tile_cap)
        b = tpr.radius_pca_moments_plain(tmap, x, v, NT, TILE_CELLS, tile_cap)
        assert tpr.KERNEL_LAUNCHES == launches + 1
        np.testing.assert_array_equal(n(a.count), n(b.count))
        np.testing.assert_allclose(n(a.mean), n(b.mean), rtol=0, atol=1e-4)
        per = np.maximum(n(b.count), 1.0)[:, None, None]
        assert np.all(np.abs(n(a.cov) - n(b.cov)) <= 1e-3 * per), case
