"""The port's fast ground filter (``pfilter_tpu_torch/ops/fast_ground.py``,
``ground.method="fast"``) against the reference's
``pfilter_tpu.ops.fast_ground`` on the same numpy scenes, for every
``normal_method`` (0-3), every ``distance_weight_method`` (0-2) and
``fixed_num_downsampling``; the twins of ``tests/test_fast_ground.py``; and
the dispatch into the BPF front-end and the ES pre-filter.

Tolerances: the four masks must be equal; heights above ground are float32
differences of the same operands, equal in every case measured (stated at
1e-6 m).  Normals (methods 1-3, the TLS plane of each grid's ground points)
are held to a float64 TLS of the same points, within 1e-3 on every grid of
at least 3 ground points whose two smallest covariance eigenvalues differ
by at least 1 % of the trace (measured: at most 8.0e-5); on grids with a
smaller gap the plane's normal is not determined by the data.  The port
takes the moments about each grid's anchor; the reference takes them in
sensor coordinates in float32, whose cancellation moves its normals by up
to 8.8e-2 on such grids (measured), so against the reference the normals
are held within 3e-2 on grids with a gap of at least 10 % (measured: at
most 2.04e-2)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pfilter_tpu.config import FastGroundConfig
from pfilter_tpu.models import bpf_frontend as jfe
from pfilter_tpu.ops import fast_ground as jfg
from pfilter_tpu.utils import synthetic
from pfilter_tpu_torch.models import bpf_frontend as tfe
from pfilter_tpu_torch.ops import fast_ground as tfg
from pfilter_tpu_torch.pipeline import ESPipeline
from test_bpf import small_config
from torch_parity import n, t, torch_config

HAG_TOL_M = 1e-6
NORMAL_TOL = 1e-3  # against the float64 TLS, gap >= GAP
GAP = 1e-2
REF_NORMAL_TOL = 3e-2  # against the reference, gap >= REF_GAP
REF_GAP = 0.1


def _make_scene(rng, n_ground=12000, n_wall=1500, n_high=300, tilt=0.0):
    """Ground at z ~ tilt * x + noise, a wall, high canopy points, 5 % invalid."""
    gx, gy = rng.uniform(-40, 40, n_ground), rng.uniform(-40, 40, n_ground)
    g = np.stack([gx, gy, tilt * gx + rng.normal(0.0, 0.03, n_ground)], -1)
    w = np.stack([rng.uniform(9.8, 10.2, n_wall), rng.uniform(-20, 20, n_wall), rng.uniform(0.2, 4.0, n_wall)], -1)
    h = np.stack([rng.uniform(-40, 40, n_high), rng.uniform(-40, 40, n_high), rng.uniform(7.0, 12.0, n_high)], -1)
    xyz = np.concatenate([g, w, h]).astype(np.float32)
    xyz = xyz[rng.permutation(len(xyz))]
    valid = rng.uniform(size=len(xyz)) > 0.05
    return xyz, valid


def _both(xyz, valid, cfg):
    want = jfg.fast_ground_filter(jnp.asarray(xyz), jnp.asarray(valid), cfg)
    tcfg = torch_config(cfg)
    got = tfg.fast_ground_filter(t(xyz), t(valid), tcfg)
    for f in ("ground_mask", "ground_down_mask", "nonground_mask"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(n(got.height_above_ground), np.asarray(want.height_above_ground), atol=HAG_TOL_M, rtol=0)
    ground, normal = n(got.ground_mask), n(got.normal)
    if cfg.normal_method == 0:
        np.testing.assert_array_equal(normal, np.asarray(want.normal))
        return got
    np.testing.assert_allclose(np.linalg.norm(normal[ground], axis=1), 1.0, atol=1e-5)
    assert (normal[ground, 2] >= 0).all() and not normal[~ground].any()
    exact, gap, enough = tfg.tls_normals_float64(xyz, ground, n(tfg.grid_layout(t(xyz), t(valid), tcfg)[2]))
    sel = ground & enough & (gap >= GAP)
    assert sel.sum() > 0.5 * (ground & enough).sum()
    np.testing.assert_allclose(normal[sel], exact[sel], atol=NORMAL_TOL, rtol=0)
    sel = ground & enough & (gap >= REF_GAP)
    np.testing.assert_allclose(normal[sel], np.asarray(want.normal)[sel], atol=REF_NORMAL_TOL, rtol=0)
    return got


@pytest.mark.parametrize("normal_method", [0, 1, 2, 3])
@pytest.mark.parametrize("dw_method", [0, 1, 2])
def test_matches_reference(normal_method, dw_method):
    rng = np.random.default_rng(10 * normal_method + dw_method)
    xyz, valid = _make_scene(rng, tilt=0.05 * normal_method)
    cfg = FastGroundConfig(normal_method=normal_method, distance_weight_method=dw_method, ground_down_rate=4)
    got = _both(xyz, valid, cfg)
    assert 0 < n(got.ground_mask).sum() < valid.sum()
    assert n(got.nonground_mask).sum() > 0 and (n(got.ground_down_mask) <= n(got.ground_mask)).all()


@pytest.mark.parametrize("down_fixed_num", [500, 1, 100000])
def test_fixed_num_downsampling_matches_reference(down_fixed_num):
    rng = np.random.default_rng(3)
    xyz, valid = _make_scene(rng)
    cfg = FastGroundConfig(distance_weight_method=0, ground_down_rate=1, fixed_num_downsampling=True, down_fixed_num=down_fixed_num)
    got = _both(xyz, valid, cfg)
    n_down, n_ground = int(n(got.ground_down_mask).sum()), int(n(got.ground_mask).sum())
    # The stride is total // down_fixed_num, at least 1: one point, every
    # ground point, or ~500 of them (stride-quantised).
    if down_fixed_num == 500:
        assert 400 <= n_down <= 1100
    else:
        assert n_down == (1 if down_fixed_num == 1 else n_ground)


def test_fast_ground_classification():
    """Twin of ``test_fast_ground_classification``: flat ground is ground,
    the wall and the canopy are non-ground, heights above ground ~ z."""
    rng = np.random.default_rng(0)
    xyz, _ = _make_scene(rng, n_ground=40000, n_wall=4000, n_high=800)
    valid = np.ones(len(xyz), bool)
    res = _both(xyz, valid, FastGroundConfig(distance_weight_method=0, ground_down_rate=1, nonground_down_rate=1))
    gm, ngm = n(res.ground_mask), n(res.nonground_mask)
    assert not np.any(gm & ngm)
    low = xyz[:, 2] < 0.1
    wall = (np.abs(xyz[:, 0] - 10.0) < 0.3) & (xyz[:, 2] > 0.8)
    assert gm[low].mean() > 0.9 and (~gm[wall]).all() and ngm[wall].mean() > 0.9
    assert ngm[xyz[:, 2] > 7.0].mean() > 0.9
    hag = n(res.height_above_ground)
    sel = wall & ngm
    assert np.percentile(np.abs(hag[sel] - xyz[sel, 2]), 90) < 0.3 and (hag[sel] > 0.3).mean() > 0.95


def test_fast_ground_normals():
    """Twin of ``test_fast_ground_normals``: a tilted plane's per-grid TLS
    normals point along (-0.1, 0, 1)."""
    rng = np.random.default_rng(2)
    xy = rng.uniform(-30, 30, (40000, 2))
    xyz = np.concatenate([xy, (0.1 * xy[:, 0] + rng.normal(0, 0.01, 40000))[:, None]], -1).astype(np.float32)
    cfg = FastGroundConfig(normal_method=1, distance_weight_method=0, ground_down_rate=1, max_height_difference=0.8, neighbor_height_diff=3.0)
    res = _both(xyz, np.ones(len(xyz), bool), cfg)
    gm = n(res.ground_mask)
    assert gm.sum() > 0.5 * len(xyz)
    expect = np.array([-0.1, 0.0, 1.0]) / np.linalg.norm([-0.1, 0.0, 1.0])
    assert np.median(n(res.normal)[gm] @ expect) > 0.99


def test_distance_weighting_thins_near_keeps_far():
    """Twin of ``test_fast_ground_distance_weighted_downsampling``."""
    rng = np.random.default_rng(1)
    xyz, _ = _make_scene(rng, n_ground=40000, n_wall=4000, n_high=800)
    valid = np.ones(len(xyz), bool)
    g0 = n(_both(xyz, valid, FastGroundConfig(distance_weight_method=0, ground_down_rate=4)).ground_mask)
    g2 = n(_both(xyz, valid, FastGroundConfig(distance_weight_method=2, ground_down_rate=4, standard_distance=15.0)).ground_mask)
    d = np.linalg.norm(xyz[:, :2], axis=1)
    assert g2[d > 30.0].mean() > g0[d > 30.0].mean()
    assert g2[d < 10.0].sum() <= g0[d < 10.0].sum() * 1.5


def test_fast_method_dispatches_into_frontend_and_es_prefilter():
    """Twin of ``test_fast_method_dispatches_into_frontend``, and the ES
    pre-filter (``es_ground_filter``): ``ground.method="fast"`` routes both
    through the fast filter, with the reference's masks; another method
    raises ``ValueError``."""
    jcfg = small_config()
    jcfg = jcfg.replace(ground=dataclasses.replace(jcfg.ground, method="fast"))
    tcfg = torch_config(jcfg)
    world = synthetic.make_world(seed=5, corridor_len=60.0)
    poses = synthetic.make_trajectory(1, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, jcfg.lidar, n_azimuth=900, noise=0.004)
    x, v = np.asarray(xyz[0]), np.asarray(valid[0])
    want = jfe.run_frontend(jnp.asarray(x), jnp.asarray(v), jcfg)
    got = tfe.run_frontend(t(x), t(v), tcfg)
    for f in tfe.FrontendResult._fields:
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    g = n(got.ground_mask)
    assert 0 < g.sum() < 0.5 * v.sum()
    assert np.abs(x[g, 2] - x[g, 2].mean()).mean() < 0.5
    es = tcfg.replace(mode="es", es_ground_filter=True)
    pipe = ESPipeline(es, device="cpu")
    ng = jfg.fast_ground_filter(jnp.asarray(x), jnp.asarray(v), jcfg.fast_ground).nonground_mask
    np.testing.assert_array_equal(n(pipe._prefilter(t(x), t(v))), np.asarray(ng))
    bad = es.replace(ground=dataclasses.replace(es.ground, method="ransac"))
    with pytest.raises(ValueError, match="ground.method"):
        ESPipeline(bad, device="cpu")._prefilter(t(x), t(v))
