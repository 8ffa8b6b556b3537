"""Parity of the port's feature extraction (ops/features.py) and scan renderer
(utils/synthetic.py) with the reference package.

Feature masks must be equal bit for bit: the same fp32 arithmetic in the same
order, stable sorts on the same keys, first-index argmax.  The renderer with
``noise=0`` must give the same points (atol 1e-5 m) and the same masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pfilter_tpu.config import LidarConfig
from pfilter_tpu.ops import features as jfeat
from pfilter_tpu.utils import synthetic as jsyn
from pfilter_tpu_torch.ops import features as tfeat
from pfilter_tpu_torch.utils import synthetic as tsyn
from torch_parity import n, t, tiny_config


@pytest.fixture(scope="module")
def scan():
    """A rendered 16-beam city scan (reference renderer), padded to the tiny
    config's scan capacity, plus both configs."""
    jcfg, tcfg = tiny_config()
    world = jsyn.make_city_world(seed=7)
    poses = jsyn.make_loop_trajectory(40, speed=1.5)
    i = 30
    xyz, valid = jsyn.render_scan(jsyn.se3.Pose(q=poses.q[i], t=poses.t[i]), world, jcfg.lidar, 512, noise=0.01, t_time=float(i))
    cap = jcfg.capacity.scan_points
    x = np.zeros((cap, 3), np.float32)
    v = np.zeros(cap, bool)
    x[: len(xyz)], v[: len(xyz)] = np.asarray(xyz), np.asarray(valid)
    return jcfg, tcfg, x, v


def test_ring_ids_and_bins_match(scan):
    jcfg, tcfg, x, v = scan
    jr, jv = jfeat.ring_ids(jnp.array(x), jnp.array(v), jcfg.lidar)
    tr, tv = tfeat.ring_ids(t(x), t(v), tcfg.lidar)
    np.testing.assert_array_equal(n(tr), n(jr))
    np.testing.assert_array_equal(n(tv), n(jv))
    jg = jfeat.bin_rings(jnp.array(x), jnp.array(v), jcfg.lidar, jcfg.capacity)
    tg = tfeat.bin_rings(t(x), t(v), tcfg.lidar, tcfg.capacity)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(n(b), n(a))
    extra = (np.arange(len(x)) % 7 == 0).astype(np.float32)
    np.testing.assert_array_equal(
        n(tfeat.bin_extra(t(x), t(v), t(extra), tcfg.lidar, tcfg.capacity)),
        n(jfeat.bin_extra(jnp.array(x), jnp.array(v), jnp.array(extra), jcfg.lidar, jcfg.capacity)),
    )


@pytest.mark.parametrize("num_lines", [16, 32, 64])
def test_ring_ids_all_beam_formulas(num_lines):
    rng = np.random.default_rng(num_lines)
    pts = rng.normal(size=(4000, 3)).astype(np.float32) * [20, 20, 3]
    mask = rng.uniform(size=4000) > 0.05
    lidar = LidarConfig(num_lines=num_lines)
    tl = tiny_config()[1].lidar.__class__(num_lines=num_lines)
    jr, jv = jfeat.ring_ids(jnp.array(pts), jnp.array(mask), lidar)
    tr, tv = tfeat.ring_ids(t(pts), t(mask), tl)
    np.testing.assert_array_equal(n(tr), n(jr))
    np.testing.assert_array_equal(n(tv), n(jv))


def test_curvature_and_reach_match(scan):
    jcfg, tcfg, x, v = scan
    jg = jfeat.bin_rings(jnp.array(x), jnp.array(v), jcfg.lidar, jcfg.capacity)
    tg = tfeat.bin_rings(t(x), t(v), tcfg.lidar, tcfg.capacity)
    jc, jcv = jfeat.ring_curvature(jg, jcfg.features)
    tc, tcv = tfeat.ring_curvature(tg, tcfg.features)
    np.testing.assert_array_equal(n(tcv), n(jcv))
    np.testing.assert_allclose(n(tc), n(jc), rtol=1e-6, atol=1e-6)
    for a, b in zip(jfeat._suppression_reach(jg, jcfg.features), tfeat._suppression_reach(tg, tcfg.features)):
        np.testing.assert_array_equal(n(b), n(a))


def test_extract_features_masks_equal(scan):
    jcfg, tcfg, x, v = scan
    jf = jax.jit(lambda a, b: jfeat.extract_features(a, b, jcfg.lidar, jcfg.features, jcfg.capacity))(jnp.array(x), jnp.array(v))
    tf = tfeat.extract_features(t(x), t(v), tcfg.lidar, tcfg.features, tcfg.capacity)
    assert n(jf.edge_mask).sum() > 100 and n(jf.surf_mask).sum() > 1000
    np.testing.assert_array_equal(n(tf.edge_mask), n(jf.edge_mask))
    np.testing.assert_array_equal(n(tf.surf_mask), n(jf.surf_mask))
    np.testing.assert_array_equal(n(tf.xyz), n(jf.xyz))
    np.testing.assert_array_equal(n(tf.ring), n(jf.ring))
    # Compiled, the reference fuses the 11-tap sum (another rounding order)
    # and |sum - 11 p|^2 cancels about three digits of it; eager, the values
    # agree to 1e-6 (test_curvature_and_reach_match).
    np.testing.assert_allclose(n(tf.curvature), n(jf.curvature), rtol=2e-3, atol=2e-3)


def test_surf_decimate_matches(scan):
    import dataclasses

    jcfg, tcfg, x, v = scan
    jfc = dataclasses.replace(jcfg.features, surf_decimate=2)
    tfc = dataclasses.replace(tcfg.features, surf_decimate=2)
    jf = jfeat.extract_features(jnp.array(x), jnp.array(v), jcfg.lidar, jfc, jcfg.capacity)
    tf = tfeat.extract_features(t(x), t(v), tcfg.lidar, tfc, tcfg.capacity)
    np.testing.assert_array_equal(n(tf.surf_mask), n(jf.surf_mask))


def test_worlds_and_trajectories_equal():
    for ref, out in (
        (jsyn.make_city_world(seed=7), tsyn.make_city_world(seed=7)),
        (jsyn.make_world(seed=3, corridor_len=80.0, n_movers=3, clutter_per_100m=2.0), tsyn.make_world(seed=3, corridor_len=80.0, n_movers=3, clutter_per_100m=2.0)),
    ):
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    for ref, out in (
        (jsyn.make_loop_trajectory(300, speed=1.5), tsyn.make_loop_trajectory(300, speed=1.5)),
        (jsyn.make_trajectory(20, speed=0.8), tsyn.make_trajectory(20, speed=0.8)),
    ):
        np.testing.assert_array_equal(np.asarray(out.q), np.asarray(ref.q))
        np.testing.assert_array_equal(np.asarray(out.t), np.asarray(ref.t))
    for lines in (16, 32, 64):
        np.testing.assert_array_equal(tsyn.beam_elevations(lines), jsyn.beam_elevations(lines))


@pytest.mark.parametrize("frame", [0, 25])
def test_renderer_matches_without_noise(frame):
    jcfg, tcfg = tiny_config()
    world = jsyn.make_city_world(seed=7)
    poses = jsyn.make_loop_trajectory(30, speed=1.5)
    pose = (poses.q[frame], poses.t[frame])
    jx, jv, jm = jsyn.render_scan(jsyn.se3.Pose(*pose), world, jcfg.lidar, 600, noise=0.0, t_time=float(frame), return_mover=True)
    tx, tv, tm = tsyn.render_scan(tsyn.se3.Pose(*pose), tsyn.make_city_world(seed=7), tcfg.lidar, 600, noise=0.0, t_time=float(frame), return_mover=True, device="cpu")
    np.testing.assert_array_equal(n(tv), n(jv))
    np.testing.assert_array_equal(n(tm), n(jm))
    np.testing.assert_allclose(n(tx)[n(jv)], n(jx)[n(jv)], atol=1e-5)
    assert n(tv).sum() > 5000


def test_renderer_noise_is_seeded():
    _, tcfg = tiny_config()
    world = tsyn.make_city_world(seed=7)
    pose = tsyn.se3.Pose(q=np.array([1.0, 0, 0, 0], np.float32), t=np.array([0.0, 0.0, 1.73], np.float32))
    a, _ = tsyn.render_scan(pose, world, tcfg.lidar, 256, noise=0.01, seed=5, device="cpu")
    b, _ = tsyn.render_scan(pose, world, tcfg.lidar, 256, noise=0.01, seed=5, device="cpu")
    c, _ = tsyn.render_scan(pose, world, tcfg.lidar, 256, noise=0.0, device="cpu")
    np.testing.assert_array_equal(n(a), n(b))
    assert 0.0 < float(np.abs(n(a) - n(c)).max()) < 0.2
