"""The compiled frame (``pfilter_tpu_torch/graphs.py``): on a CUDA device
each single-device pipeline captures its steady frame once as a CUDA graph
and replays it, as the reference package ``jax.jit``s its frame.  On the
CPU there is no graph: ``graphs=True`` raises, the default runs eagerly and
its poses are unchanged against the reference (the ES slice's tolerance,
1 cm / 2e-3 rad, ``tests/test_torch_es.py``).  The map-sharded pipelines
do the same on the CPU (their compiled frame on the card:
``tests/test_torch_sharded_graphs.py``).  The replayed-against-eager test
needs the card and skips here."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pfilter_tpu.pipeline import ESPipeline as JESPipeline
from pfilter_tpu.utils import synthetic
from pfilter_tpu_torch.parallel import mesh
from pfilter_tpu_torch.parallel.pipeline import ShardedBPFPipeline, ShardedESPipeline
from pfilter_tpu_torch.pipeline import BPFPipeline, ESPipeline, make_pipeline
from torch_parity import rotation_angle, tiny_config

N_FRAMES = 5  # the tiny config's outer iterations reach their floor of 2 at frame 2
POS_TOL_M = 1e-2
ROT_TOL_RAD = 2e-3


@pytest.fixture(scope="module")
def scans():
    jcfg, tcfg = tiny_config()
    world = synthetic.make_world(seed=3, corridor_len=80.0)
    poses = synthetic.make_trajectory(N_FRAMES, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, jcfg.lidar, n_azimuth=512, noise=0.0)
    return jcfg, tcfg, np.asarray(xyz), np.asarray(valid)


def _configs(scans, mode):
    jcfg, tcfg = scans[0], scans[1]
    return jcfg.replace(mode=mode), tcfg.replace(mode=mode)


@pytest.mark.parametrize("mode", ["es", "bpf"])
def test_graphs_true_on_the_cpu_raises(scans, mode):
    _, tcfg = _configs(scans, mode)
    with pytest.raises(ValueError, match="CUDA"):
        make_pipeline(tcfg, device="cpu", graphs=True)


def _run(pipe, xyz, valid):
    for i in range(N_FRAMES):
        pipe.process_frame(xyz[i], valid[i])
    return pipe


@pytest.mark.parametrize("mode", ["es", "bpf"])
def test_default_cpu_pipeline_runs_eagerly(scans, mode):
    """The default (``graphs=None``) resolves to eager on the CPU, past the
    frame where the card would capture, and its poses equal an explicit
    ``graphs=False`` run bit for bit."""
    _, tcfg = _configs(scans, mode)
    xyz, valid = scans[2], scans[3]
    default = _run(make_pipeline(tcfg, device="cpu"), xyz, valid)
    eager = _run(make_pipeline(tcfg, device="cpu", graphs=False), xyz, valid)
    assert default.graphs is False and default.captures == [] and default.replays == 0
    for a, b in zip(default.trajectory, eager.trajectory):
        np.testing.assert_array_equal(a, b)


def test_default_cpu_pipeline_matches_reference(scans):
    """The default ES pipeline on the CPU stays within the slice's tolerance
    of the reference's compiled pipeline (``torch_parity``'s tiny config)."""
    jcfg, tcfg = _configs(scans, "es")
    xyz, valid = scans[2], scans[3]
    tq, tt = _run(make_pipeline(tcfg, device="cpu"), xyz, valid).trajectory
    ref = JESPipeline(cfg=jcfg)
    for i in range(N_FRAMES):
        ref.process_frame(xyz[i], valid[i])
    jq, jt = ref.trajectory
    assert np.isfinite(tt).all()
    assert np.linalg.norm(tt - jt, axis=1).max() < POS_TOL_M
    assert rotation_angle(tq, jq).max() < ROT_TOL_RAD
    assert np.linalg.norm(tt[-1]) > 2.0  # the trajectory moved


@pytest.mark.parametrize("cls", [ShardedESPipeline, ShardedBPFPipeline])
def test_sharded_pipelines_never_capture(scans, cls, tmp_path):
    """On the CPU neither sharded pipeline captures, as no single-device one
    does: asking for a CUDA graph raises, the default (``graphs=None``)
    resolves to eager, and frames past the outer iterations' floor run
    eagerly.  (On a card both capture their steady frame:
    ``tests/test_torch_sharded_graphs.py``.)"""
    jcfg, tcfg = _configs(scans, "es" if cls is ShardedESPipeline else "bpf")
    xyz, valid = scans[2], scans[3]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        grid = mesh.make_mesh(1, 1, device="cpu")
        with pytest.raises(ValueError, match="CUDA"):
            cls(tcfg, mesh=grid, graphs=True)
        pipe = cls(tcfg, mesh=grid)
        assert pipe.graphs is False and pipe._graphs is None
        for i in range(N_FRAMES):
            pipe.process_frame(xyz[i], valid[i])
    finally:
        dist.destroy_process_group()
    assert pipe.captures == [] and pipe.replays == 0
    assert np.isfinite(pipe.trajectory[1]).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured and replayed only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [ESPipeline, BPFPipeline])
def test_replayed_frames_equal_eager_frames(scans, cls, cuda_device):
    """On the card: one capture at frame 2, every later frame replayed, and
    the poses bit for bit those of an eager run; the state a caller kept
    before a replay is not written by it."""
    _, tcfg = _configs(scans, "es" if cls is ESPipeline else "bpf")
    xyz, valid = scans[2], scans[3]
    eager, replayed = cls(tcfg, device=cuda_device, graphs=False), cls(tcfg, device=cuda_device)
    kept = None
    for i in range(N_FRAMES):
        eager.process_frame(xyz[i], valid[i])
        if i == N_FRAMES - 1:
            kept = replayed.state
            before = kept.pose.t.clone()
        replayed.process_frame(xyz[i], valid[i])
    assert len(replayed.captures) == 1 and replayed.replays == N_FRAMES - 3
    for a, b in zip(eager.trajectory, replayed.trajectory):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(kept.pose.t, before)
