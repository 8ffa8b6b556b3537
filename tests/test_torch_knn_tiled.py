"""Parity of the port's tiled kNN (ops/knn_tiled.py) with the reference
package's Pallas kernel (interpret mode on the CPU) and its brute-force
reference, and of the CUDA kernel with its plain version (on a card only).

Tolerance against the Pallas kernel is the reference's own
(tests/test_knn_tiled.py:57-58): it packs a lane index into the low 13
mantissa bits, so its distances run up to 2^-10 relative low; the port's
are exact fp32, and its selection breaks near-ties by true distance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfilter_tpu.ops import knn_tiled as jknn
from pfilter_tpu_torch.ops import knn_tiled as tknn
from torch_parity import n, t

NT = 16
TILE_CELLS = 4
TILE_CAP = 128
TRUNC = 2.0 ** -(23 - jknn._IDX_BITS)


def _maps(seed, n_map, cap, spread, dense_row=0):
    rng = np.random.default_rng(seed)
    xyz = np.zeros((cap, 3), np.float32)
    pts = rng.uniform(-spread, spread, size=(n_map, 3))
    if dense_row:  # pack one 3-tile row past the 3*tile_cap cap
        pts[:dense_row] = rng.uniform([0.1, -5.9, -1.0], [3.9, 5.9, 1.0], size=(dense_row, 3))
    xyz[:n_map] = pts
    rg = rng.integers(0, 20, size=(cap, 2)).astype(np.float32)
    valid = np.zeros(cap, bool)
    valid[:n_map] = True
    jorigin = jknn.tile_origin_for_pose(jnp.zeros(3), NT, TILE_CELLS)
    jmap = jknn.build_tiled(jnp.array(xyz), jnp.array(rg), jnp.array(valid), jorigin, NT, TILE_CELLS, TILE_CAP)
    torigin = tknn.tile_origin_for_pose(torch.zeros(3), NT, TILE_CELLS)
    tmap = tknn.build_tiled(t(xyz), t(rg), t(valid), torigin, NT, TILE_CELLS, TILE_CAP)
    return jmap, tmap


def _queries(seed, m, spread, invalid_frac=0.0):
    rng = np.random.default_rng(seed + 100)
    q = rng.uniform(-spread, spread, size=(m, 3)).astype(np.float32)
    qv = rng.uniform(size=m) >= invalid_frac
    return q, qv


def test_build_and_sort_layout_equal():
    jmap, tmap = _maps(0, 900, 1024, 20.0)
    for f in jknn.TiledMap._fields:
        np.testing.assert_array_equal(n(getattr(tmap, f)), n(getattr(jmap, f)), err_msg=f)
    q, qv = _queries(0, 400, 30.0, invalid_frac=0.2)
    js = jknn.sort_queries(jnp.array(q), jnp.array(qv), jmap.origin, NT, TILE_CELLS)
    ts = tknn.sort_queries(t(q), t(qv), tmap.origin, NT, TILE_CELLS)
    for f in jknn.QuerySort._fields:
        np.testing.assert_array_equal(n(getattr(ts, f)), n(getattr(js, f)), err_msg=f)
    np.testing.assert_array_equal(n(tknn._tile_centers(tmap.origin, NT, TILE_CELLS)).reshape(-1), n(jknn._tile_centers(jmap.origin, NT, TILE_CELLS)))
    jst, jcnt = jknn._halo_ranges(jmap, NT, 3 * TILE_CAP)
    tst, tcnt = tknn._halo_ranges(tmap, NT, 3 * TILE_CAP)
    np.testing.assert_array_equal(n(tst).reshape(-1), n(jst))
    np.testing.assert_array_equal(n(tcnt).reshape(-1), n(jcnt))


@pytest.mark.parametrize(
    "case",
    [
        dict(seed=1, n_map=1500, cap=2048, spread=6.0, dense_row=0, qspread=5.0, inv=0.0),
        dict(seed=2, n_map=600, cap=1024, spread=25.0, dense_row=0, qspread=40.0, inv=0.25),  # border tiles, invalid
        dict(seed=3, n_map=1400, cap=2048, spread=10.0, dense_row=700, qspread=6.0, inv=0.1),  # halo row over the cap
    ],
)
def test_query_sorted_matches_pallas_kernel(case):
    jmap, tmap = _maps(case["seed"], case["n_map"], case["cap"], case["spread"], case["dense_row"])
    q, qv = _queries(case["seed"], 256, case["qspread"], case["inv"])
    ts = tknn.sort_queries(t(q), t(qv), tmap.origin, NT, TILE_CELLS)
    sq = q[n(ts.order)]
    bounds = n(ts.bounds)
    jr = jknn.query_tiled_sorted(jmap, jnp.array(sq), jnp.array(bounds), NT, TILE_CELLS, TILE_CAP, interpret=True)
    before = tknn.KERNEL_LAUNCHES
    tr = tknn.query_tiled_sorted(tmap, t(sq), t(bounds), NT, TILE_CELLS, TILE_CAP)
    assert tknn.KERNEL_LAUNCHES == before  # a CPU tensor takes the plain version
    jd, td = n(jr.sqdist), n(tr.sqdist)
    ji, ti = n(jr.idx), n(tr.idx)
    if case["dense_row"]:
        _, cnt = tknn._halo_ranges(tmap, NT, 10**9)
        assert int(cnt.max()) > 3 * TILE_CAP  # the cap binds somewhere
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    fin = np.isfinite(td)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=2 * TRUNC, atol=1e-5)
    # Same neighbour coordinates except where the Pallas kernel's truncated
    # keys reorder near-ties (true distances within its truncation).
    mx = n(tmap.xyz_t[:3]).T
    diff = (ti != ji) & fin
    d_t = ((mx[ti] - sq[:, None]) ** 2).sum(-1)
    d_j = ((mx[ji] - sq[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(d_t[diff], d_j[diff], rtol=4 * TRUNC, atol=1e-5)
    assert diff.sum() <= 0.05 * fin.sum()
    # Invalid queries (sorted last) get inf.
    assert np.isinf(td[int(bounds[-1]) :]).all()


def test_query_matches_bruteforce_within_gate():
    jmap, tmap = _maps(4, 1500, 2048, 6.0)
    q, qv = _queries(4, 300, 5.0)
    # A cap no halo row reaches here, so the tiled query is exact.
    tr = tknn.query_tiled(tmap, t(q), t(qv), NT, TILE_CELLS, 4 * TILE_CAP)
    ref = tknn.query_tiled_reference(tmap, t(q), t(qv))
    jref = jknn.query_tiled_reference(jmap, jnp.array(q), jnp.array(qv))
    np.testing.assert_allclose(n(ref.sqdist), n(jref.sqdist), rtol=1e-6, atol=1e-6)
    gated = n(ref.sqdist)[:, 4] < 1.0
    assert gated.sum() > 30
    np.testing.assert_allclose(n(tr.sqdist)[gated], n(ref.sqdist)[gated], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(n(tr.idx)[gated], n(ref.idx)[gated])


def test_fewer_candidates_than_k_and_empty_map():
    jmap, tmap = _maps(5, 3, 128, 1.0)
    q = np.array([[0.0, 0.0, 0.0], [50.0, 50.0, 0.0]], np.float32)
    tr = tknn.query_tiled(tmap, t(q), torch.ones(2, dtype=torch.bool), NT, TILE_CELLS, TILE_CAP)
    d = n(tr.sqdist)
    assert np.isfinite(d[0, :3]).all() and np.isinf(d[0, 3:]).all()
    assert np.isinf(d[1]).all() and (n(tr.idx)[1] == 0).all()
    _, empty = _maps(6, 0, 128, 1.0)
    er = tknn.query_tiled(empty, t(q), torch.ones(2, dtype=torch.bool), NT, TILE_CELLS, TILE_CAP)
    assert np.isinf(n(er.sqdist)).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kNN kernel has no CPU mode (its plain version is tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,dense_row,inv", [(1, 0, 0.0), (3, 700, 0.2)])
def test_cuda_kernel_equals_plain_version(cuda_device, seed, dense_row, inv):
    _, tmap = _maps(seed, 1400, 2048, 10.0, dense_row)
    tmap = tknn.TiledMap(*(x.to(cuda_device) for x in tmap))
    q, qv = _queries(seed, 2000, 8.0, inv)
    ts = tknn.sort_queries(t(q).to(cuda_device), t(qv).to(cuda_device), tmap.origin, NT, TILE_CELLS)
    sq = t(q).to(cuda_device)[ts.order].contiguous()
    before = tknn.KERNEL_LAUNCHES
    rk = tknn.query_tiled_sorted(tmap, sq, ts.bounds, NT, TILE_CELLS, TILE_CAP)
    rp = tknn.query_tiled_sorted_plain(tmap, sq, ts.bounds, NT, TILE_CELLS, TILE_CAP)
    torch.cuda.synchronize()
    assert tknn.KERNEL_LAUNCHES == before + 1
    np.testing.assert_array_equal(n(rk.sqdist), n(rp.sqdist))
    np.testing.assert_array_equal(n(rk.idx), n(rp.idx))
