"""CPU runs of the port do not depend on the number of intra-op threads.

With several threads PyTorch splits two kinds of float sums by thread, so
their rounding followed the thread count: ``index_put_`` with accumulate
adds float rows with atomics from several threads once the work passes
PyTorch's grain size (32,768 elements), and a BLAS product (``J^T W J``,
``J^T W r`` of the Gauss-Newton normal equations) splits its inner sum by
thread.  On the tiny config the second moved ES poses by up to 0.13 mm
between one and four threads.  The port's CPU path sums both in a fixed
order (``voxel.segment_add``, ``gauss_newton.normal_equations``), so its
poses are bit for bit the same on any number of threads.  The suite itself
runs one thread per worker (``torch_parity``); these tests ask for four."""

import numpy as np
import pytest
import torch

from pfilter_tpu_torch.ops import gauss_newton, voxel
from pfilter_tpu_torch.pipeline import make_pipeline
from pfilter_tpu_torch.utils import synthetic
from torch_parity import tiny_config

N_FRAMES = 6
THREADS = 4


def _at_threads(n, fn):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        return fn()
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("mode", ["es", "bpf"])
def test_pipeline_poses_do_not_depend_on_thread_count(mode):
    _, tcfg = tiny_config()
    tcfg = tcfg.replace(mode=mode)
    world = synthetic.make_world(seed=3, corridor_len=80.0)
    poses = synthetic.make_trajectory(N_FRAMES, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, tcfg.lidar, 512, noise=0.0, device="cpu")

    def run():
        pipe = make_pipeline(tcfg, device="cpu")
        for i in range(N_FRAMES):
            pipe.process_frame(xyz[i], valid[i])
        return pipe

    one, many = _at_threads(1, run), _at_threads(THREADS, run)
    for a, b in zip(one.trajectory, many.trajectory):
        np.testing.assert_array_equal(a, b)
    for r1, r4 in zip(one.records, many.records):
        np.testing.assert_array_equal(r1.overflow, r4.overflow)
    assert np.linalg.norm(one.trajectory[1][-1]) > 2.0  # the trajectory moved


def test_segment_add_does_not_depend_on_thread_count():
    """Far above the grain size, with many rows per segment: the same bits
    on one and on four threads, and those of a serial ``index_put_``."""
    g = np.random.default_rng(0)
    seg = torch.from_numpy(g.integers(0, 1000, 200_000))
    values = torch.from_numpy(g.standard_normal((200_000, 3)).astype(np.float32))
    sums = [_at_threads(n, lambda: voxel.segment_add(torch.zeros(1000, 3), seg, values)) for n in (1, THREADS)]
    assert torch.equal(sums[0], sums[1])
    serial = _at_threads(1, lambda: torch.zeros(1000, 3).index_put_((seg,), values, accumulate=True))
    assert torch.equal(sums[0], serial)


def test_normal_equations_do_not_depend_on_thread_count():
    """``J^T W J`` and ``J^T W r`` of 50,000 rows: the same bits on one and
    on four threads, within float32 rounding of a float64 product."""
    g = np.random.default_rng(1)
    r = torch.from_numpy(g.standard_normal(50_000).astype(np.float32))
    j = torch.from_numpy(g.standard_normal((50_000, 6)).astype(np.float32))
    w = torch.from_numpy(g.uniform(0.0, 1.0, 50_000).astype(np.float32))
    valid = torch.from_numpy(g.uniform(size=50_000) > 0.1)
    out = [_at_threads(n, lambda: gauss_newton.normal_equations(r, j, w, valid)) for n in (1, THREADS)]
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    jw = (j * torch.where(valid, w, torch.zeros_like(w))[:, None]).double()
    np.testing.assert_allclose(out[0][0].numpy(), (jw.T @ j.double()).numpy(), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(out[0][1].numpy(), (jw.T @ r.double()).numpy(), rtol=1e-6, atol=1e-3)
