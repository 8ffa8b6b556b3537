"""Parity of the port's grid ground segmentation (ops/ground.py) with the
reference package: ground and non-ground masks equal exactly, on a rendered
32-beam scan and on constructed scenes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pfilter_tpu.config import GroundConfig, LidarConfig
from pfilter_tpu.ops import ground as jground
from pfilter_tpu.utils import synthetic
from pfilter_tpu_torch.config import GroundConfig as TGroundConfig
from pfilter_tpu_torch.config import PipelineConfig as TPipelineConfig
from pfilter_tpu_torch.ops import ground as tground
from torch_parity import n, t

LIDAR = LidarConfig(num_lines=32, min_distance=1.0, max_distance=60.0)


def _rendered(seed):
    world = synthetic.make_world(seed=seed, corridor_len=60.0)
    poses = synthetic.make_trajectory(1, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, LIDAR, n_azimuth=900, noise=0.004)
    return np.asarray(xyz[0]), np.asarray(valid[0])


def _scene(seed):
    """Flat ground, a box wall on ground, a floating slab, sparse cells,
    invalid points and points beyond the grid window."""
    rng = np.random.default_rng(seed)
    g = np.column_stack([rng.uniform(-20, 20, (4000, 2)), rng.normal(0, 0.02, 4000)])
    wall = np.column_stack([rng.uniform(8, 9, 600), rng.uniform(-2, 2, 600), rng.uniform(0.5, 2.5, 600)])
    slab = np.column_stack([rng.uniform(-15, -12, 300), rng.uniform(10, 13, 300), rng.normal(4.0, 0.02, 300)])
    sparse = np.column_stack([rng.uniform(30, 60, (20, 2)), rng.normal(0, 0.02, 20)])
    far = rng.uniform(100, 300, (50, 3)) * rng.choice([-1, 1], (50, 3))
    xyz = np.concatenate([g, wall, slab, sparse, far]).astype(np.float32)
    valid = rng.uniform(size=len(xyz)) > 0.05
    return xyz, valid


@pytest.mark.parametrize(
    "source,seed,cfg",
    [
        ("rendered", 5, GroundConfig()),
        ("rendered", 6, GroundConfig(grid_size=2.0, num_cells=48)),
        ("scene", 0, GroundConfig()),
        ("scene", 1, GroundConfig(point_height_tol=0.1, neighbor_height_tol=0.5)),
    ],
)
def test_masks_match_reference(source, seed, cfg):
    xyz, valid = _rendered(seed) if source == "rendered" else _scene(seed)
    want = jground.segment_ground(jnp.asarray(xyz), jnp.asarray(valid), cfg)
    got = tground.segment_ground(t(xyz), t(valid), TGroundConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(n(got.ground_mask), np.asarray(want.ground_mask))
    np.testing.assert_array_equal(n(got.nonground_mask), np.asarray(want.nonground_mask))
    g, ng = n(got.ground_mask), n(got.nonground_mask)
    assert g.sum() > 500 and ng.sum() > 100 and not (g & ng).any()


def test_dispatch():
    xyz, valid = _scene(0)
    cfg = TPipelineConfig()
    got = tground.segment_ground_dispatch(t(xyz), t(valid), cfg)
    want = tground.segment_ground(t(xyz), t(valid), cfg.ground)
    np.testing.assert_array_equal(n(got.ground_mask), n(want.ground_mask))
    # "fast" runs the fast ground filter, with the reference's dispatch masks.
    fast = cfg.replace(ground=dataclasses.replace(cfg.ground, method="fast"))
    got = tground.segment_ground_dispatch(t(xyz), t(valid), fast)
    from pfilter_tpu.config import PipelineConfig

    jfast = PipelineConfig().replace(ground=dataclasses.replace(PipelineConfig().ground, method="fast"))
    want = jground.segment_ground_dispatch(jnp.asarray(xyz), jnp.asarray(valid), jfast)
    np.testing.assert_array_equal(n(got.ground_mask), np.asarray(want.ground_mask))
    np.testing.assert_array_equal(n(got.nonground_mask), np.asarray(want.nonground_mask))
    assert n(got.ground_mask).sum() > 0
    with pytest.raises(ValueError, match="unknown ground.method"):
        tground.segment_ground_dispatch(t(xyz), t(valid), cfg.replace(ground=dataclasses.replace(cfg.ground, method="x")))
