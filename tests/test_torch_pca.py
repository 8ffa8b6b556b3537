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


def _cull_emulated(q_world, c_world, center, radius):
    """The kernel's cull for one work item (its plain version,
    ``cull_keep_plain``), and the fp32 squared distance of every (query,
    candidate) pair in the kernel's operation order."""
    keep, cc, lo, hi = (n(x) for x in tpr.cull_keep_plain(t(q_world), t(c_world), t(center), radius))
    f = np.float32
    qc = (q_world.astype(f) - center.astype(f)).astype(f)
    d = (qc[:, None, :] - cc[None, :, :]).astype(f)
    sq = (d * d).astype(f)
    d2 = ((sq[..., 0] + sq[..., 1]).astype(f) + sq[..., 2]).astype(f)
    return keep, d2 < f(radius * radius), cc, lo, hi


@pytest.mark.parametrize("radius", [1.0, 0.35])
@pytest.mark.parametrize("world", [(0.0, 0.0, 0.0), (1000.3, -2000.7, 31.0)])
def test_cull_never_drops_a_ball_candidate(radius, world):
    """The PCA kernel's staging cull (csrc/pca_radius.cu), emulated: on
    candidates placed adversarially at the cull and ball boundaries — at
    r (1 +- k ulp) from the corners of the item's query box along the axes and
    the diagonals, and one ulp either side of the box faces grown by r — no
    candidate with fp32 d^2 < r^2 for any query of the box is rejected, and
    the cull does reject candidates."""
    rng = np.random.default_rng(21)
    world = np.asarray(world, np.float32)
    origin = tknn.tile_origin_for_pose(torch.from_numpy(world), NT, TILE_CELLS)
    t_id = n(tknn._tile_ids(torch.from_numpy(world[None]), torch.ones(1, dtype=torch.bool), origin, NT, TILE_CELLS))[0]
    center = n(tknn._tile_centers(origin, NT, TILE_CELLS))[t_id]
    # The item: 8 box corners and 24 points inside, around the tile center.
    half = np.array([1.3, 0.9, 0.6], np.float32)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32) * half
    q = (center + np.concatenate([corners, rng.uniform(-half, half, (24, 3))])).astype(np.float32)
    dirs = [np.eye(3)[a] * sg for a in range(3) for sg in (-1.0, 1.0)]
    dirs += [np.array([sx, sy, sz]) / np.sqrt(3.0) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    scales = [1.0 + k * 2.0**-23 for k in range(-8, 9)] + [1 - 1e-6, 1 + 1e-6]
    cands = [q[i] + np.float32(radius * sc) * np.asarray(d, np.float32) for i in range(8) for d in dirs for sc in scales]
    # Up to three world-coordinate ulps either side of each face of the box
    # grown by r, and of the box grown by reach (the cull's own faces).
    qc = q - center
    for a in range(3):
        for face, sg in ((qc[:, a].min(), -1.0), (qc[:, a].max(), 1.0)):
            for grow in (radius, radius + tpr.CULL_MARGIN):
                v = np.float32(center[a] + face + sg * grow)
                steps = [v]
                for _ in range(3):
                    steps = [np.nextafter(steps[0], np.float32(-np.inf))] + steps + [np.nextafter(steps[-1], np.float32(np.inf))]
                for v in steps:
                    pts = (center + rng.uniform(qc.min(0) - 0.2, qc.max(0) + 0.2, (20, 3))).astype(np.float32)
                    pts[:, a] = v
                    cands.append(pts)
    c = np.concatenate([np.reshape(x, (-1, 3)) for x in cands]).astype(np.float32)
    keep, in_ball, cc, lo, hi = _cull_emulated(q, c, center, radius)
    hit = in_ball.any(0)
    assert hit.sum() > 200 and (~hit).sum() > 200  # both sides of the ball are exercised
    assert np.all(keep[hit]), f"{int((hit & ~keep).sum())} ball candidates culled"
    assert (~keep).sum() > 50  # the cull rejects candidates just beyond reach
    # The margin is what keeps them: without it the box would cut ball points.
    tight = np.all((cc >= (qc.min(0) - np.float32(radius)).astype(np.float32)) & (cc <= (qc.max(0) + np.float32(radius)).astype(np.float32)), 1)
    assert np.all(keep[tight])


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
