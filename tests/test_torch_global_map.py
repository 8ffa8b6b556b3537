"""The port's global visualization map (``models/global_map.py``) against the
reference package's: twins of ``tests/test_global_map.py``'s unit tests, the
same poses and scans into both maps, and FIFO slot reuse.

Tolerance: counts, cells, slot assignment and validity are exact; points
agree within 2^-15 m (3.05e-5 m).  The reference transforms the scan under
``jax.jit``, whose fused arithmetic differs from its own eager
``transform_points`` by up to 2 float32 ulps of the rotated point (1.5e-5 m
at the scans' 64-128 m), plus one ulp of the world coordinate when the
translation is added (1.5e-5 m at 128-256 m, the largest here); the port's
host transform equals the eager one bit for bit (checked below), and the
centroids carry that difference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfilter_tpu.models import global_map as jgm
from pfilter_tpu.ops import se3 as jse3
from pfilter_tpu_torch.models import global_map as tgm
from pfilter_tpu_torch.models.global_map import CELL_SIZE, GlobalMap

POINT_TOL_M = 2.0**-15
IDENTITY_Q = np.array([1.0, 0, 0, 0], np.float32)


def _scan(rng, n, spread=40.0):
    xyz = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(0, 5, size=n)
    return xyz, np.ones(n, bool)


def _cpu_map(**kw):
    return GlobalMap(device="cpu", **kw)


def test_insert_and_get():
    rng = np.random.default_rng(0)
    gm = _cpu_map(max_cells=64, cell_cap=4096, resolution=0.4)
    xyz, valid = _scan(rng, 5000)
    gm.update(IDENTITY_Q, np.zeros(3, np.float32), xyz, valid)
    m = gm.get_map()
    assert 100 < len(m) <= 5000
    # All map points near some input point (downsampling moves <= leaf).
    d = np.abs(m[:, None] - xyz[None]).max(-1).min(1)
    assert d.max() < 0.4


def test_voxel_dedup_across_frames():
    """Re-inserting the same static scene must not grow the map."""
    rng = np.random.default_rng(1)
    gm = _cpu_map(max_cells=64, cell_cap=4096, resolution=0.4)
    xyz, valid = _scan(rng, 3000)
    gm.update(IDENTITY_Q, np.zeros(3, np.float32), xyz, valid)
    n1 = len(gm.get_map())
    gm.update(IDENTITY_Q, np.zeros(3, np.float32), xyz, valid)
    n2 = len(gm.get_map())
    assert abs(n2 - n1) <= 0.02 * n1


def test_pose_transform_applied():
    rng = np.random.default_rng(2)
    gm = _cpu_map(max_cells=64, cell_cap=4096, resolution=0.4)
    xyz = rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    gm.update(IDENTITY_Q, np.array([200.0, 0.0, 0.0], np.float32), xyz, np.ones(500, bool))
    m = gm.get_map()
    assert np.abs(m[:, 0] - 200.0).max() < 6.0


def test_cells_grow_along_trajectory():
    rng = np.random.default_rng(3)
    gm = _cpu_map(max_cells=128, cell_cap=2048, resolution=0.4)
    for i in range(4):
        xyz, valid = _scan(rng, 2000, spread=30.0)
        gm.update(IDENTITY_Q, np.array([i * CELL_SIZE, 0.0, 0.0], np.float32), xyz, valid)
    m = gm.get_map()
    # Map spans the whole trajectory.
    assert m[:, 0].min() < 0 and m[:, 0].max() > 3 * CELL_SIZE


def _poses(rng, n, step):
    """Yaw-rotated poses marching along x, as float32 host arrays."""
    yaw = rng.uniform(-np.pi, np.pi, n)
    q = np.stack([np.cos(yaw / 2), np.zeros(n), np.zeros(n), np.sin(yaw / 2)], -1).astype(np.float32)
    t = np.stack([np.arange(n) * step, rng.uniform(-5, 5, n), np.zeros(n)], -1).astype(np.float32)
    return q, t


def _feed_both(max_cells, cell_cap, n_frames, step, seed):
    rng = np.random.default_rng(seed)
    jmap = jgm.GlobalMap(max_cells=max_cells, cell_cap=cell_cap, resolution=0.4)
    tmap = _cpu_map(max_cells=max_cells, cell_cap=cell_cap, resolution=0.4)
    q, t = _poses(rng, n_frames, step)
    for i in range(n_frames):
        xyz, valid = _scan(rng, 3000, spread=60.0)
        valid = rng.uniform(size=len(valid)) > 0.05
        jmap.update(jnp.asarray(q[i]), jnp.asarray(t[i]), jnp.asarray(xyz), jnp.asarray(valid))
        tmap.update(q[i], t[i], xyz, valid)
    return jmap, tmap


def _assert_same_cells(jmap, tmap):
    assert tmap._slot_of == jmap._slot_of and tmap._next == jmap._next
    jc = np.asarray(jmap.store.count)
    np.testing.assert_array_equal(tmap.store.count.numpy(), jc)
    np.testing.assert_array_equal(tmap.store.valid.numpy(), np.asarray(jmap.store.valid))
    # Same points in the same slots, in the same order: each cell is its
    # voxels in ascending voxel-id order.
    jx, tx = np.asarray(jmap.store.xyz), tmap.store.xyz.numpy()
    v = np.asarray(jmap.store.valid)
    np.testing.assert_allclose(tx[v], jx[v], rtol=0, atol=POINT_TOL_M)


def _sorted_points(m):
    return m[np.lexsort(np.round(m, 3).T[::-1])]


def test_get_map_matches_reference():
    jmap, tmap = _feed_both(max_cells=64, cell_cap=4096, n_frames=5, step=30.0, seed=4)
    jm, tm = jmap.get_map(), tmap.get_map()
    assert len(tm) == len(jm) > 1000
    np.testing.assert_allclose(_sorted_points(tm), _sorted_points(jm), rtol=0, atol=POINT_TOL_M)
    _assert_same_cells(jmap, tmap)


def test_fifo_slot_reuse_keeps_stale_points_like_reference():
    """With fewer slots than cells, the oldest cell's slot is reused without
    being cleared, in both packages: the new cell keeps the old points."""
    jmap, tmap = _feed_both(max_cells=6, cell_cap=2048, n_frames=6, step=50.0, seed=5)
    assert tmap._next == 6 and len(tmap._slot_of) == 6  # slots were reused
    _assert_same_cells(jmap, tmap)
    # Stale points: some slot now holds points outside the cell it is filed under.
    stale = 0
    for cell, s in tmap._slot_of.items():
        pts = tmap.store.xyz[s][tmap.store.valid[s]].numpy()
        stale += int((np.floor(pts / CELL_SIZE).astype(np.int64) != np.asarray(cell)).any(1).sum())
    assert stale > 0


def test_host_transform_equals_reference_eager_transform():
    rng = np.random.default_rng(7)
    q, t = _poses(rng, 3, 40.0)
    xyz = rng.uniform(-60, 60, (2000, 3)).astype(np.float32)
    for i in range(3):
        want = np.asarray(jse3.transform_points(jse3.Pose(q=jnp.asarray(q[i]), t=jnp.asarray(t[i])), jnp.asarray(xyz)))
        got = tgm.se3.transform_points(tgm.se3.Pose(q=torch.from_numpy(q[i]), t=torch.from_numpy(t[i])), torch.from_numpy(xyz))
        np.testing.assert_array_equal(got.numpy(), want)


def test_padding_slots_touch_no_cell():
    """``touched`` entries of -1 write nothing; a slot not listed is left alone."""
    store = tgm.empty_store(4, 64, "cpu")
    store.xyz[3] = 7.0
    store.valid[3, :5] = True
    xyz = np.random.default_rng(6).uniform(0, 10, (40, 3)).astype(np.float32)
    slot = np.zeros(40, np.int32)
    touched = np.full(tgm._TOUCH_CAP, -1, np.int32)
    touched[0] = 0
    out = tgm._insert(store, xyz, slot, touched, 0.4)
    assert int(out.count[0]) > 0
    assert out.valid[3, :5].all() and float(out.xyz[3].max()) == 7.0
    assert int(out.count[1]) == int(out.count[2]) == int(out.count[3]) == 0


@pytest.mark.cuda
def test_update_refuses_device_tensors():
    """``update`` takes host data: a CUDA tensor raises rather than being
    read back (which would wait for the device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gm = GlobalMap(max_cells=4, cell_cap=64)
    with pytest.raises(TypeError):
        gm.update(IDENTITY_Q, np.zeros(3, np.float32), torch.zeros((10, 3), device="cuda"), np.ones(10, bool))
