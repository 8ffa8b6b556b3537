"""Parity of the port's tiled kNN (ops/knn_tiled.py) with the reference
package's Pallas kernel (interpret mode on the CPU) and its brute-force
reference, and of the CUDA kernel with its plain version (on a card only).

Tolerance against the Pallas kernel is the reference's own
(tests/test_knn_tiled.py:57-58): it packs a lane index into the low 13
mantissa bits, so its distances run up to 2^-10 relative low; the port's
are exact fp32, and its selection breaks near-ties by true distance."""

import importlib.util
from pathlib import Path

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



def _packed_ab():
    """``tools/torch_knn_packed_keys_ab.py``, imported by path."""
    path = Path(__file__).resolve().parent.parent / "tools" / "torch_knn_packed_keys_ab.py"
    spec = importlib.util.spec_from_file_location("torch_knn_packed_keys_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "case",
    [
        dict(seed=1, n_map=1500, cap=2048, spread=6.0, dense_row=0, qspread=5.0, inv=0.0),
        dict(seed=2, n_map=600, cap=1024, spread=25.0, dense_row=0, qspread=40.0, inv=0.25),
        dict(seed=3, n_map=1400, cap=2048, spread=10.0, dense_row=700, qspread=6.0, inv=0.1),
        dict(seed=5, n_map=1900, cap=2048, spread=30.0, dense_row=0, qspread=30.0, inv=0.0),
    ],
)
def test_packed_key_emulation_matches_pallas_kernel(case):
    """The A/B tool's packed-key kNN (its variant (b)) computes what the
    reference's Pallas kernel computes: the same neighbours, and the same
    lane-truncated distances but on at most one in a thousand returned (the
    XLA CPU dot's rounding is not reproduced everywhere), each such within one
    truncation step."""
    jmap, tmap = _maps(case["seed"], case["n_map"], case["cap"], case["spread"], case["dense_row"])
    q, qv = _queries(case["seed"], 512, case["qspread"], case["inv"])
    ts = tknn.sort_queries(t(q), t(qv), tmap.origin, NT, TILE_CELLS)
    sq = q[n(ts.order)]
    jr = jknn.query_tiled_sorted(jmap, jnp.array(sq), jnp.array(n(ts.bounds)), NT, TILE_CELLS, TILE_CAP, interpret=True)
    jd, ji = np.asarray(jr.sqdist), np.asarray(jr.idx)
    pr = _packed_ab().query_tiled_sorted_packed(tmap, t(sq), ts.bounds, NT, TILE_CELLS, TILE_CAP)
    pd, pi = n(pr.sqdist), n(pr.idx)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    np.testing.assert_array_equal(pi[fin], ji[fin])
    diff = pd[fin] != jd[fin]
    assert diff.sum() <= max(1, fin.sum() // 1000)
    np.testing.assert_allclose(pd[fin][diff], jd[fin][diff], rtol=TRUNC, atol=0)

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


def _border_duplicates(row, dev=None):
    """A map and tile-sorted queries with query tiles in the window's first
    (``row=0``) or last tile row, where a query tile's halo reads that row
    twice.  Tile ids are not moved off the border ring (as ``build_tiled``
    and ``sort_queries`` would), so the doubled row holds points: 40 points,
    each stored three times in consecutive slots, plus a sparse background;
    the queries are the points themselves (distance 0, six ways tied across
    the two reads), points 1 cm off, and random points in the row."""
    rng = np.random.default_rng(31 + row)
    x0 = -NT * TILE_CELLS / 2 + row * TILE_CELLS  # the row's first x, origin at -NT*TILE_CELLS/2
    lo, hi = [x0 + 0.05, -8.0, -1.0], [x0 + TILE_CELLS - 0.05, 8.0, 1.0]
    base = rng.uniform(lo, hi, (40, 3)).astype(np.float32)
    span = NT * TILE_CELLS / 2 - 0.1
    pts = np.concatenate([np.repeat(base, 3, 0), rng.uniform(-span, span, (400, 3)).astype(np.float32)])
    q = np.concatenate([base, base + np.float32(0.01), rng.uniform(lo, hi, (60, 3)).astype(np.float32)])
    origin = tknn.tile_origin_for_pose(torch.zeros(3), NT, TILE_CELLS)

    def tiles(xyz):
        c = torch.clamp(torch.floor((xyz[:, :2] - origin[:2]) / TILE_CELLS).to(torch.int32), 0, NT - 1)
        return c[:, 0] * NT + c[:, 1]

    x = t(pts)
    m_order = torch.argsort(tiles(x), stable=True)
    sx = x[m_order]
    sv = torch.ones(len(pts), dtype=torch.bool)
    tmap = tknn.TiledMap(
        xyz=sx, rg=torch.zeros((len(pts), 2)), valid=sv, xyz_t=tknn.transposed_coords(sx, sv, TILE_CAP),
        tile_start=tknn._tile_range(tiles(sx), NT), origin=origin,
    )
    qt = t(q)
    q_order = torch.argsort(tiles(qt), stable=True)
    sq = qt[q_order].contiguous()
    bounds = tknn._tile_range(tiles(sq), NT)
    if dev is not None:
        tmap = tknn.TiledMap(*(f.to(dev) for f in tmap))
        sq, bounds = sq.to(dev), bounds.to(dev)
    return tmap, sq, bounds


@pytest.mark.parametrize("row", [0, NT - 1])
def test_plain_breaks_ties_by_halo_position(row):
    """The tie rule the kernel must reproduce: (distance, halo position), the
    position of a candidate being its place in the three halo rows read one
    after another.  In the window's first and last tile rows a row is read
    twice, so a slot is its own tie and the rule differs from (distance,
    slot); the plain version is held to a direct numpy emulation."""
    tmap, sq, bounds = _border_duplicates(row)
    got = tknn.query_tiled_sorted_plain(tmap, sq, bounds, NT, TILE_CELLS, TILE_CAP)
    ts, b = n(tmap.tile_start), n(bounds)
    xt = n(tmap.xyz_t)[:3]
    ctr = n(tknn._tile_centers(tmap.origin, NT, TILE_CELLS))
    f, w = np.float32, 3 * TILE_CAP
    n_differ = 0
    for p in range(int(b[-1])):
        tile = int(np.searchsorted(b, p, side="right") - 1)
        tx, ty = divmod(tile, NT)
        assert tx == row
        slots = []
        for dr in (-1, 0, 1):
            r = min(max(tx + dr, 0), NT - 1)
            s0 = ts[r * NT + max(ty - 1, 0)]
            slots.extend(range(s0, s0 + min(ts[r * NT + min(ty + 1, NT - 1) + 1] - s0, w)))
        slots = np.asarray(slots)
        c = ctr[tile]
        qc = (n(sq)[p] - c).astype(f)
        dd = (qc[:, None] - (xt[:, slots] - c[:, None]).astype(f)).astype(f)
        sqd = (dd * dd).astype(f)
        d = ((sqd[0] + sqd[1]).astype(f) + sqd[2]).astype(f)
        by_pos = np.lexsort((np.arange(len(slots)), d))[:5]
        np.testing.assert_array_equal(n(got.sqdist)[p], d[by_pos])
        np.testing.assert_array_equal(n(got.idx)[p], slots[by_pos])
        n_differ += not np.array_equal(slots[np.lexsort((slots, d))[:5]], slots[by_pos])
    assert n_differ >= 40  # the case separates the two rules


def _work_list_case(case):
    """(queries, valid) for the work-list cases, at NT=16 tiles of 4 m."""
    rng = np.random.default_rng(11)
    if case == "no_queries":
        return np.zeros((0, 3), np.float32), np.zeros(0, bool)
    if case == "all_invalid":
        return rng.uniform(-5, 5, (40, 3)).astype(np.float32), np.zeros(40, bool)
    if case == "one_tile":  # every query in one tile: many chunks, one ragged
        return rng.uniform([0.2, 0.2, -1], [3.8, 3.8, 1], (1000, 3)).astype(np.float32), np.ones(1000, bool)
    if case == "border":  # mostly far outside the window: clamped into the border ring
        q = rng.uniform(-400, 400, (700, 3)).astype(np.float32)
        return q, rng.uniform(size=700) > 0.2
    # sparse: empty tiles between single queries, chunk-sized tiles, invalid rows
    q = np.concatenate([rng.uniform(-30, 30, (150, 3)), rng.uniform([4.1, 4.1, 0], [7.9, 7.9, 1], (64, 3))])
    return q.astype(np.float32), rng.uniform(size=len(q)) > 0.1


@pytest.mark.parametrize("chunk", [tknn.CHUNK, 32])
@pytest.mark.parametrize("case", ["no_queries", "all_invalid", "one_tile", "border", "sparse"])
def test_work_list_covers_each_processed_query_once(case, chunk):
    """The kernels' work list (work_list on a CPU tensor: its plain version):
    every processed query lies in exactly one item, inside its own tile's
    range, tiles in order, and no item is empty or larger than a chunk;
    invalid queries are in none, and the rows fit the list's size."""
    q, qv = _work_list_case(case)
    origin = tknn.tile_origin_for_pose(torch.zeros(3), NT, TILE_CELLS)
    qs = tknn.sort_queries(t(q), t(qv), origin, NT, TILE_CELLS)
    work = n(tknn.work_list(qs.bounds, NT, chunk, len(q)))
    assert work.dtype == np.int32 and work.shape[1] == 4
    n_items = int(work[0, 0])
    assert 1 + n_items <= work.shape[0]
    tile, q0, cnt = work[1 : 1 + n_items, 0], work[1 : 1 + n_items, 1], work[1 : 1 + n_items, 2]
    bounds = n(qs.bounds).astype(np.int64)
    n_proc = int(bounds[-1])
    assert n_proc == int(qv.sum())
    assert np.all((cnt >= 1) & (cnt <= chunk))
    assert np.all((q0 >= bounds[tile]) & (q0 + cnt <= bounds[tile + 1]))
    assert np.all(np.diff(tile) >= 0)
    covered = np.zeros(len(q), np.int64)
    for a, c in zip(q0, cnt):
        covered[a : a + c] += 1
    np.testing.assert_array_equal(covered[:n_proc], 1)
    np.testing.assert_array_equal(covered[n_proc:], 0)
    per_tile = np.diff(bounds)
    assert n_items == int(np.sum(-(-per_tile // chunk)))
    if case == "one_tile":
        assert len(set(tile.tolist())) == 1 and n_items == -(-1000 // chunk)
    if case == "border":
        tx, ty = tile // NT, tile % NT
        assert np.any((tx == 1) | (tx == NT - 2) | (ty == 1) | (ty == NT - 2))


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


@pytest.mark.cuda
@pytest.mark.parametrize("row", [0, NT - 1])
def test_cuda_kernel_equals_plain_on_border_duplicates(cuda_device, row):
    """Ties where a query tile's halo reads a row twice: the kernel keeps the
    plain version's (distance, halo position) order, indices identical."""
    tmap, sq, bounds = _border_duplicates(row, cuda_device)
    rk = tknn.query_tiled_sorted(tmap, sq, bounds, NT, TILE_CELLS, TILE_CAP)
    rp = tknn.query_tiled_sorted_plain(tmap, sq, bounds, NT, TILE_CELLS, TILE_CAP)
    np.testing.assert_array_equal(n(rk.sqdist), n(rp.sqdist))
    np.testing.assert_array_equal(n(rk.idx), n(rp.idx))
