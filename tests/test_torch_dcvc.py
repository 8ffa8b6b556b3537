"""Parity of the port's DCVC clustering (ops/dcvc.py) with the reference
package: labels, cluster sizes and keep masks equal exactly on the non-ground
part of a rendered 32-beam scan and on constructed blobs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pfilter_tpu.config import DCVCConfig, GroundConfig, LidarConfig
from pfilter_tpu.ops import dcvc as jdcvc
from pfilter_tpu.ops import ground as jground
from pfilter_tpu.utils import synthetic
from pfilter_tpu_torch.config import DCVCConfig as TDCVCConfig
from pfilter_tpu_torch.config import LidarConfig as TLidarConfig
from pfilter_tpu_torch.ops import dcvc as tdcvc
from torch_parity import n, t

LIDAR = LidarConfig(num_lines=32, min_distance=1.0, max_distance=60.0)


def _tcfg(cfg, lidar):
    return TDCVCConfig(**dataclasses.asdict(cfg)), TLidarConfig(**dataclasses.asdict(lidar))


def test_bounds_and_grid_match():
    for cfg, lidar in ((DCVCConfig(), LIDAR), (DCVCConfig(delta_a=2.0, delta_p=2.0, start_r=0.5), LidarConfig())):
        tc, tl = _tcfg(cfg, lidar)
        np.testing.assert_array_equal(tdcvc.polar_bounds(tc, tl), jdcvc.polar_bounds(cfg, lidar))
        assert tdcvc._grid_dims(tc, tl) == jdcvc._grid_dims(cfg, lidar)


def _nonground_scan(seed):
    world = synthetic.make_world(seed=seed, corridor_len=60.0)
    poses = synthetic.make_trajectory(1, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, LIDAR, n_azimuth=900, noise=0.004)
    ng = jground.segment_ground(xyz[0], valid[0], GroundConfig()).nonground_mask
    return np.asarray(xyz[0]), np.asarray(ng)


def _blobs(seed):
    rng = np.random.default_rng(seed)
    blobs = [
        rng.normal([10, 0, 0], 0.3, size=(150, 3)),
        rng.normal([0, 15, 1], 0.3, size=(120, 3)),
        rng.normal([-12, -8, 0.5], 0.3, size=(100, 3)),
        rng.normal([-20, 0.2, 0.0], 0.3, size=(90, 3)),  # straddles the azimuth wrap
    ]
    noise = rng.uniform(-30, 30, size=(60, 3))
    xyz = np.concatenate(blobs + [noise]).astype(np.float32)
    valid = rng.uniform(size=len(xyz)) > 0.05
    return xyz, valid


@pytest.mark.parametrize(
    "source,seed,cfg",
    [
        ("rendered", 5, DCVCConfig()),
        ("rendered", 6, DCVCConfig(min_seg=30, max_iters=16)),
        ("blobs", 0, DCVCConfig(min_seg=80)),
        ("blobs", 1, DCVCConfig(min_seg=95, max_iters=4)),
    ],
)
def test_cluster_matches_reference(source, seed, cfg):
    xyz, valid = _nonground_scan(seed) if source == "rendered" else _blobs(seed)
    want = jdcvc.cluster(jnp.asarray(xyz), jnp.asarray(valid), cfg, LIDAR)
    tc, tl = _tcfg(cfg, LIDAR)
    got = tdcvc.cluster(t(xyz), t(valid), tc, tl)
    for f in ("label", "cluster_size", "keep"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    keep = n(got.keep)
    assert 0 < keep.sum() < valid.sum()  # some clusters kept, some dropped


def test_atan2_f32_is_the_reference_atan2():
    """``atan2_f32`` gives the bits of the reference's compiled float32
    ``atan2`` (glibc's ``atan2f``) on random rays, on the axes and at signed
    zeros; PyTorch's own CPU ``atan2`` differs from it on many of them."""
    import jax
    import torch

    g = np.random.default_rng(3)
    y = np.concatenate([g.normal(0.0, s, 20000) for s in (1e-3, 1.0, 80.0)]).astype(np.float32)
    x = np.concatenate([g.normal(0.0, s, 20000) for s in (80.0, 1.0, 1e-3)]).astype(np.float32)
    sp = np.array([0.0, -0.0, 1.0, -1.0, 3.0, -7.5, 1e-30, 1e30], np.float32)
    y, x = np.concatenate([y, np.repeat(sp, len(sp))]), np.concatenate([x, np.tile(sp, len(sp))])
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    got = n(tdcvc.atan2_f32(t(y), t(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (n(torch.atan2(t(y), t(x))) != want).mean() > 0.05


def test_cluster_bins_tied_azimuths_as_the_compiled_reference():
    """On a scan whose azimuths lie on a 0.2-degree grid, one ray in six
    sits exactly on the half of a 1.2-degree azimuth bin, where the bin
    depends on the last ulp of ``az / delta_a``.  Compiled, the reference
    multiplies by the reciprocal (XLA's rewrite of a division by a
    constant), and its pipelines run compiled: the port bins as it does,
    label for label, where the reference's eager run would not."""
    import jax

    world = synthetic.make_world(seed=5, corridor_len=60.0)
    poses = synthetic.make_trajectory(1, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, LIDAR, n_azimuth=1800, noise=0.004)
    xyz, valid = np.asarray(xyz[0]), np.asarray(valid[0])
    cfg = DCVCConfig()
    want = jax.jit(lambda a, b: jdcvc.cluster(a, b, cfg, LIDAR))(jnp.asarray(xyz), jnp.asarray(valid))
    eager = jdcvc.cluster(jnp.asarray(xyz), jnp.asarray(valid), cfg, LIDAR)
    got = tdcvc.cluster(t(xyz), t(valid), *_tcfg(cfg, LIDAR))
    for f in ("label", "cluster_size", "keep"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    assert (np.asarray(eager.label) != np.asarray(want.label)).sum() > 100  # the ties decide differently eagerly
