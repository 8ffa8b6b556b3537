"""The port's grid kNN (``pfilter_tpu_torch/ops/knn.py``, ``knn_impl="grid"``)
against the reference's ``pfilter_tpu.ops.knn`` on the same numpy inputs:
twins of the five tests of ``tests/test_knn.py`` plus a map of duplicated
points.

Tolerance: none.  Both packages compute the same float32 arithmetic (cell
coordinates, packed ids, squared distances summed x, y, z in that order), so
the sorted grids, distances and indices must be equal; among equal distances
both return the lower candidate position first (``lax.top_k``'s order, a
stable sort in the port)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfilter_tpu.ops import knn as jknn
from pfilter_tpu_torch.ops import knn as tknn
from torch_parity import n, t


def _build(rng, n_map, cap, spread=40.0):
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n_map] = rng.uniform(-spread, spread, size=(n_map, 3)).astype(np.float32)
    rg = rng.integers(0, 20, size=(cap, 2)).astype(np.float32)
    valid = np.zeros(cap, bool)
    valid[:n_map] = True
    jgrid = jknn.build_grid(jnp.array(xyz), jnp.array(rg), jnp.array(valid), jknn.grid_origin_for_pose(jnp.zeros(3), 1.0), 1.0)
    tgrid = tknn.build_grid(t(xyz), t(rg), t(valid), tknn.grid_origin_for_pose(torch.zeros(3), 1.0), 1.0)
    return xyz, valid, jgrid, tgrid


def _assert_grids_equal(tgrid, jgrid):
    for f in tknn.HashGrid._fields:
        np.testing.assert_array_equal(n(getattr(tgrid, f)), np.asarray(getattr(jgrid, f)), err_msg=f)


def _query_both(jgrid, tgrid, q, qv, k, p):
    jr = jknn.knn_query(jgrid, jnp.array(q), jnp.array(qv), k, p)
    tr = tknn.knn_query(tgrid, t(q), t(qv), k, p)
    np.testing.assert_array_equal(n(tr.sqdist), np.asarray(jr.sqdist))
    np.testing.assert_array_equal(n(tr.idx), np.asarray(jr.idx))
    return tr


def test_grid_sorted_and_complete():
    rng = np.random.default_rng(0)
    xyz, valid, jgrid, tgrid = _build(rng, 500, 512)
    _assert_grids_equal(tgrid, jgrid)
    ids = n(tgrid.cell_ids)
    assert np.all(np.diff(ids.astype(np.int64)) >= 0)
    assert int(n(tgrid.valid).sum()) == 500
    got = n(tgrid.xyz)[n(tgrid.valid)]
    assert set(map(tuple, got.tolist())) == set(map(tuple, xyz[valid].tolist()))


def test_knn_matches_bruteforce_within_gate():
    rng = np.random.default_rng(1)
    n_map, cap, k = 2000, 2048, 5
    xyz, valid, jgrid, tgrid = _build(rng, n_map, cap, spread=4.0)
    q = rng.uniform(-3.5, 3.5, size=(256, 3)).astype(np.float32)
    res = _query_both(jgrid, tgrid, q, np.ones(256, bool), k, 16)
    sq, idx = n(res.sqdist), n(res.idx)
    d2 = ((q[:, None] - xyz[:n_map][None]) ** 2).sum(-1)
    exact = np.sort(d2, axis=1)[:, :k]
    gated = exact[:, k - 1] < 1.0
    assert gated.sum() > 50
    np.testing.assert_allclose(sq[gated], exact[gated], rtol=1e-4, atol=1e-5)
    grid_xyz = n(tgrid.xyz)
    for qi in np.nonzero(gated)[0][:20]:
        for j in range(k):
            d = ((grid_xyz[idx[qi, j]] - q[qi]) ** 2).sum()
            np.testing.assert_allclose(d, sq[qi, j], rtol=1e-4, atol=1e-5)


def test_knn_sparse_returns_inf():
    rng = np.random.default_rng(2)
    _, _, jgrid, tgrid = _build(rng, 10, 64, spread=50.0)
    q = np.array([[200.0, 200.0, 200.0]], np.float32)  # far from everything
    res = _query_both(jgrid, tgrid, q, np.ones(1, bool), 5, 16)
    assert np.all(np.isinf(n(res.sqdist)))


def test_invalid_queries_masked():
    rng = np.random.default_rng(3)
    _, _, jgrid, tgrid = _build(rng, 100, 128, spread=1.5)
    q = np.zeros((4, 3), np.float32)
    qv = np.array([True, False, True, False])
    res = _query_both(jgrid, tgrid, q, qv, 5, 16)
    sq = n(res.sqdist)
    assert np.all(np.isinf(sq[~qv])) and np.all(np.isfinite(sq[qv]))


def test_rg_travels_with_points():
    rng = np.random.default_rng(4)
    cap = 64
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:32] = rng.uniform(-5, 5, size=(32, 3)).astype(np.float32)
    rg = np.zeros((cap, 2), np.float32)
    rg[:32] = np.stack([np.arange(32), np.arange(32) * 2], -1)
    valid = np.arange(cap) < 32
    origin = tknn.grid_origin_for_pose(torch.zeros(3), 1.0)
    grid = tknn.build_grid(t(xyz), t(rg), t(valid), origin, 1.0)
    jgrid = jknn.build_grid(jnp.array(xyz), jnp.array(rg), jnp.array(valid), jknn.grid_origin_for_pose(jnp.zeros(3), 1.0), 1.0)
    _assert_grids_equal(grid, jgrid)
    g_xyz, g_rg, g_valid = n(grid.xyz), n(grid.rg), n(grid.valid)
    for i in np.nonzero(g_valid)[0]:
        src = np.where((xyz == g_xyz[i]).all(-1))[0][0]
        np.testing.assert_allclose(g_rg[i], rg[src])


@pytest.mark.parametrize("copies", [2, 7])
def test_duplicate_points_give_reference_indices(copies):
    """Each map point stored ``copies`` times (equal distances from every
    query), queries on the points themselves (distance 0, tied ``copies``
    ways), 1 cm off and around them; invalid queries among them."""
    rng = np.random.default_rng(10 + copies)
    base = rng.uniform(-3.0, 3.0, (120, 3)).astype(np.float32)
    pts = np.concatenate([np.repeat(base, copies, 0), rng.uniform(-6.0, 6.0, (300, 3)).astype(np.float32)])
    cap = pts.shape[0] + 64
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = pts
    valid = np.arange(cap) < len(pts)
    rg = np.zeros((cap, 2), np.float32)
    jgrid = jknn.build_grid(jnp.array(xyz), jnp.array(rg), jnp.array(valid), jknn.grid_origin_for_pose(jnp.zeros(3), 1.0), 1.0)
    tgrid = tknn.build_grid(t(xyz), t(rg), t(valid), tknn.grid_origin_for_pose(torch.zeros(3), 1.0), 1.0)
    _assert_grids_equal(tgrid, jgrid)
    q = np.concatenate([base, base + np.float32(0.01), rng.uniform(-3.0, 3.0, (200, 3)).astype(np.float32)])
    qv = rng.uniform(size=len(q)) > 0.1
    res = _query_both(jgrid, tgrid, q, qv, 5, 32)
    sq = n(res.sqdist)
    # The ties are real: the first `copies` distances of an on-point query are equal.
    on_point = np.nonzero(qv[: len(base)])[0]
    assert (sq[on_point, : min(copies, 5)] == 0.0).all()
