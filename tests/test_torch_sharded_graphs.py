"""The compiled map-sharded frame (``pfilter_tpu_torch/parallel/pipeline.py``
over ``graphs.py``): on a card both sharded pipelines capture their steady
frame, NCCL collectives included, as one CUDA graph, as the reference
``jax.jit``s its ``shard_map``.  Here, on the CPU over a gloo group of one
rank in the pytest process: a recording stand-in for ``FrameGraphs`` (it
runs the frame eagerly and records its key) shows that each sharded
pipeline asks for a graph at the frames, and with the keys, at which its
single-device pipeline asks for one, and changes no pose; the counter
carry adds a capture's kernel launches and collectives once per replay and
never during the capture.  The replayed-against-eager test over NCCL needs
the card and skips here."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pfilter_tpu_torch import graphs
from pfilter_tpu_torch.ops import knn_tiled, pca_radius
from pfilter_tpu_torch.parallel import mesh as meshlib
from pfilter_tpu_torch.parallel.pipeline import ShardedBPFPipeline, ShardedESPipeline
from pfilter_tpu_torch.pipeline import BPFPipeline, ESPipeline
from pfilter_tpu_torch.utils import synthetic
from torch_parity import tiny_config

N_FRAMES = 5  # the tiny config's outer iterations reach their floor of 2 at frame 2
FLOOR_FRAMES = [2, 3, 4]
PAIRS = [(ESPipeline, ShardedESPipeline), (BPFPipeline, ShardedBPFPipeline)]


@pytest.fixture(scope="module")
def scans():
    _, tcfg = tiny_config()
    world = synthetic.make_world(seed=3, corridor_len=80.0)
    poses = synthetic.make_trajectory(N_FRAMES, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, tcfg.lidar, 512, noise=0.0, device="cpu")
    return tcfg, xyz, valid


@pytest.fixture
def grid(tmp_path):
    """A gloo group of one rank in this process, and its 1 x 1 mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        yield meshlib.make_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _cfg(tcfg, cls):
    return tcfg.replace(mode="bpf" if issubclass(cls, BPFPipeline) else "es")


class Recorder:
    """A stand-in for ``graphs.FrameGraphs`` on the CPU: runs the frame
    eagerly and records the key a graph would be captured or replayed under."""

    def __init__(self):
        self.keys, self.opt_counts = [], []

    def __call__(self, fn, *args):
        self.keys.append(graphs.signature(args))
        self.opt_counts.append(args[0].opt_count)
        return fn(*args)


def _recorded(pipe, xyz, valid):
    """Run every frame with a :class:`Recorder` in place of the frame graphs:
    (the frames that asked for a graph, the recorder, the poses)."""
    pipe._graphs = Recorder()
    frames = []
    for i in range(N_FRAMES):
        n = len(pipe._graphs.keys)
        pipe.process_frame(xyz[i], valid[i])
        if len(pipe._graphs.keys) > n:
            frames.append(i)
    return frames, pipe._graphs, pipe.trajectory


@pytest.mark.parametrize("single_cls, sharded_cls", PAIRS)
def test_sharded_pipelines_ask_for_graphs_as_single_device_ones(scans, grid, single_cls, sharded_cls):
    """Both sharded pipelines ask for a graph at exactly the frames, and under
    exactly the keys (the state at the outer iterations' floor), at which the
    single-device pipeline asks for its own, and the frames run through the
    stand-in give the sharded eager run's poses bit for bit."""
    tcfg, xyz, valid = scans
    cfg = _cfg(tcfg, sharded_cls)
    frames, single, _ = _recorded(single_cls(cfg, device="cpu", graphs=False), xyz, valid)
    s_frames, sharded, (rq, rt) = _recorded(sharded_cls(cfg, mesh=grid, graphs=False), xyz, valid)
    eager = sharded_cls(cfg, mesh=grid, graphs=False)
    for i in range(N_FRAMES):
        eager.process_frame(xyz[i], valid[i])
    eq, et = eager.trajectory
    assert frames == s_frames == FLOOR_FRAMES
    assert sharded.keys == single.keys and all(k == single.keys[0] for k in single.keys)  # one graph per run
    assert sharded.opt_counts == single.opt_counts == [cfg.odometry.min_outer_iters] * len(FLOOR_FRAMES)
    np.testing.assert_array_equal(rq, eq)
    np.testing.assert_array_equal(rt, et)


class _NoGraph:
    """What ``_Graph.replay`` needs of a ``torch.cuda.CUDAGraph``."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_capture_counts_carried_once_per_replay(monkeypatch):
    """A capture's kernel launches and collectives are taken back when the
    capture ends (a capture runs nothing) and added once per replay."""
    for mod, name in graphs.LAUNCH_COUNTERS:
        monkeypatch.setattr(mod, name, 7)
    mesh = meshlib.Mesh(1, 1, 0, 0, None, torch.device("cpu"))
    mesh.counts.update(all_gather=3, all_reduce=5)
    counters = graphs.Counters(graphs.LAUNCH_COUNTERS + tuple(mesh.counters()))
    start = counters.read()
    assert counters.labels() == ["knn_tiled.KERNEL_LAUNCHES", "knn_tiled.WORK_LIST_LAUNCHES", "pca_radius.KERNEL_LAUNCHES", "all_gather", "all_reduce"]
    # The capture: the frame's Python code counts as it would eagerly.
    knn_tiled.KERNEL_LAUNCHES += 2
    knn_tiled.WORK_LIST_LAUNCHES += 3
    pca_radius.KERNEL_LAUNCHES += 1
    mesh.counts["all_gather"] += 4
    mesh.counts["all_reduce"] += 10
    counted = counters.take_back(start)
    assert counted == [2, 3, 1, 4, 10]
    assert counters.read() == start  # nothing counted during the capture
    static_in, out = [torch.zeros(3)], (torch.arange(3.0),)
    replayed = graphs._Graph(_NoGraph(), static_in, out, counters, counted)
    for n in range(1, 4):
        got = replayed.replay([torch.full((3,), float(n))])
        assert counters.read() == [s + n * d for s, d in zip(start, counted)]
        assert replayed.graph.replays == n
        assert torch.equal(static_in[0], torch.full((3,), float(n)))  # inputs copied in
        assert got[0] is not out[0] and torch.equal(got[0], out[0])  # outputs cloned
    assert mesh.counts == {"all_gather": 3 + 3 * 4, "all_reduce": 5 + 3 * 10}


@pytest.mark.parametrize("cls", [ShardedESPipeline, ShardedBPFPipeline])
def test_sharded_graph_options(scans, grid, cls):
    """A sharded pipeline's frame graph carries its mesh's collective counts
    beside the kernels' launches and captures in ``thread_local`` mode (the
    process group's watchdog thread queries events during a capture)."""
    pipe = cls(_cfg(scans[0], cls), mesh=grid, graphs=False)
    opts = pipe._graph_options()
    assert opts["capture_error_mode"] == "thread_local"
    assert opts["counters"].pairs == graphs.LAUNCH_COUNTERS + ((grid.counts, "all_gather"), (grid.counts, "all_reduce"))
    assert ESPipeline(_cfg(scans[0], ESPipeline), device="cpu")._graph_options() == {}


@pytest.fixture
def nccl_grid():
    """A NCCL group of one rank on the card, and its 1 x 1 mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL collectives are captured in a CUDA graph only on the card")
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        yield meshlib.make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [ShardedESPipeline, ShardedBPFPipeline])
def test_replayed_sharded_frames_equal_eager_frames(scans, nccl_grid, cls):
    """On the card over NCCL at ``n_seq = n_map = 1``: one capture at frame
    2, every later frame replayed, the poses bit for bit an eager run's, and
    the collectives of every frame, counted through replays, as eager."""
    tcfg, xyz, valid = scans
    cfg = _cfg(tcfg, cls)
    runs = {}
    for g in (False, None):
        pipe = cls(cfg, mesh=nccl_grid, graphs=g)
        per_frame = []
        for i in range(N_FRAMES):
            before = dict(nccl_grid.counts)
            pipe.process_frame(xyz[i].cuda(), valid[i].cuda())
            per_frame.append({k: nccl_grid.counts[k] - before[k] for k in before})
        runs[g] = (pipe, per_frame)
    (eager, eager_counts), (replayed, replayed_counts) = runs[False], runs[None]
    assert eager.captures == [] and len(replayed.captures) == 1 and replayed.replays == N_FRAMES - 3
    assert replayed_counts == eager_counts
    for a, b in zip(eager.trajectory, replayed.trajectory):
        np.testing.assert_array_equal(a, b)
