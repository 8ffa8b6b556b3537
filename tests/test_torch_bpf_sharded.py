"""The port's map-sharded BPF step (``pfilter_tpu_torch/parallel/
bpf_sharded.py``) against the reference package's, on the CPU: the twin of
``tests/test_bpf_sharded.py``, with the harness of
``tests/test_torch_es_sharded.py`` (gloo workers, ``tests/torch_dist.py``).

Scans: the 16-beam tiny config in BPF mode on ``test_bpf_sharded.py``'s
world with its pole picket (so the pillar channel has correspondences),
four frames.  After the first frame each shard's three maps equal the
reference shard's exactly.  Poses are held to the ES slice's 1 cm /
2e-3 rad and counts and map sizes to 5 %, with the floors of
``tests/test_torch_bpf.py`` (4 correspondences, 8 map points) for this
config's small beam and pillar counts: the reference runs its front-end
compiled inside the sharded step, and its compiled and eager front-ends
already differ by a few points (``tests/test_torch_bpf.py``).  With one
shard (a gloo group of one rank in this process) the step equals the port's
single-device ``BPFPipeline`` bit for bit."""

import numpy as np
import pytest
import torch.distributed as dist

from pfilter_tpu.parallel import bpf_sharded as jbpf_sharded
from pfilter_tpu.utils import synthetic
from pfilter_tpu_torch import convert
from pfilter_tpu_torch.parallel import bpf_sharded, mesh
from pfilter_tpu_torch.pipeline import BPFPipeline
from torch_dist import Workers, job, rank_output, run_reference, write_scans
from torch_parity import n, rotation_angle, t, tiny_config, torch_config

N_FRAMES = 4
POS_TOL_M = 1e-2
ROT_TOL_RAD = 2e-3
COUNT_TOL = 0.05
MAPS = ("beam_map", "pillar_map", "facade_map")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bpf_sharded")
    jcfg = tiny_config()[0].replace(mode="bpf")
    world = synthetic.make_world(seed=5, corridor_len=60.0)
    picket = np.array([[2.0 + 1.4 * k, (-1.0) ** k * (4.0 + 0.35 * k), 0.16, 6.0] for k in range(8)], np.float32)
    world = world._replace(poles=np.concatenate([world.poles, picket]))
    poses = synthetic.make_trajectory(N_FRAMES, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, jcfg.lidar, n_azimuth=512, noise=0.004)
    xyz, valid = np.asarray(xyz), np.asarray(valid)
    scans = write_scans(tmp / "scans.npz", xyz[None], valid[None])
    workers = Workers(tmp, "two", 2, [job(jcfg, 1, 2, scans, tmp / "two", save_states=[0])])
    ref = run_reference(jbpf_sharded, jcfg, xyz[None], valid[None], 1, 2, N_FRAMES, keep=(0,))
    single = BPFPipeline(torch_config(jcfg), device="cpu")
    for i in range(N_FRAMES):
        single.process_frame(xyz[i], valid[i])
    workers.wait()
    return dict(tmp=tmp, ref=ref, single=single, jcfg=jcfg, xyz=xyz, valid=valid)


def _out(runs, name, rank=0):
    return rank_output(runs["tmp"] / name, rank)


def test_first_frame_shards_equal_reference(runs):
    """Each rank's beam, pillar and facade maps after the first frame equal
    the reference shard's block exactly, as point sets."""
    ref = runs["ref"]["states"][0]
    for shard in range(2):
        got = _out(runs, "two", shard)
        for kind in MAPS:
            m = getattr(ref, kind)
            valid = np.asarray(m.valid)[0, shard]
            want = np.concatenate([np.asarray(m.xyz)[0, shard], np.asarray(m.rg)[0, shard]], 1)[valid]
            have_valid = got[f"state0.{kind}.valid"]
            have = np.concatenate([got[f"state0.{kind}.xyz"], got[f"state0.{kind}.rg"]], 1)[have_valid]
            assert len(want) > 5, (kind, shard, len(want))
            np.testing.assert_array_equal(have[np.lexsort(have.T[::-1])], want[np.lexsort(want.T[::-1])], err_msg=f"{kind} shard {shard}")


def test_poses_match_reference(runs, record_property):
    """Four frames at n_map=2 within 1 cm / 2e-3 rad of the reference's
    sharded run (the largest gaps go into the test report's properties)."""
    ref = runs["ref"]
    got = _out(runs, "two")
    gap_t = np.linalg.norm(got["pose_t"] - ref["t"][0], axis=1)
    gap_r = rotation_angle(got["pose_q"], ref["q"][0])
    record_property("max_gap_m", float(gap_t.max()))
    record_property("max_gap_rad", float(gap_r.max()))
    assert np.isfinite(got["pose_t"]).all() and np.linalg.norm(got["pose_t"][-1]) > 1.5
    assert gap_t.max() < POS_TOL_M and gap_r.max() < ROT_TOL_RAD, (gap_t, gap_r)
    np.testing.assert_array_equal(_out(runs, "two", 1)["pose_t"], got["pose_t"])


def test_counts_and_map_sizes_match_reference(runs):
    ref = runs["ref"]["diags"]
    got = _out(runs, "two")
    corr = np.stack([np.asarray(d.n_corr[0]) for d in ref])
    sizes = np.stack([np.asarray(d.map_sizes[0]) for d in ref])
    assert np.all(np.abs(got["n_corr"] - corr) <= np.maximum(COUNT_TOL * corr, 4)), (got["n_corr"], corr)
    assert np.all(np.abs(got["map_sizes"] - sizes) <= np.maximum(COUNT_TOL * sizes, 8)), (got["map_sizes"], sizes)
    np.testing.assert_array_equal(got["overflow"], np.stack([np.asarray(d.overflow[0]) for d in ref]))


def test_every_channel_has_correspondences(runs):
    """A zero would mean a channel's collective path ran on empty arrays."""
    for rank in (0, 1):
        corr = _out(runs, "two", rank)["n_corr"][1:]
        assert (corr > 0).all(), (rank, corr)


def test_one_shard_equals_single_device(runs, tmp_path):
    """n_map=1: ``bpf_sharded.make_sharded_step`` (front-end included), over
    a gloo group of one rank in this process, equals the single-device
    ``BPFPipeline`` bit for bit: poses, counts, map sizes, overflow and the
    final state."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        cfg = torch_config(runs["jcfg"])
        m = mesh.make_mesh(1, 1, device="cpu")
        first, step = bpf_sharded.make_sharded_step(cfg, m, first=True), bpf_sharded.make_sharded_step(cfg, m)
        state = bpf_sharded.init_sharded_state(cfg, m)
        poses, diags = [], []
        for i in range(N_FRAMES):
            state, diag = (first if i == 0 else step)(state, t(runs["xyz"][i]), t(runs["valid"][i]))
            poses.append(n(state.pose.t))
            diags.append(diag)
        assert m.backend == "gloo" and m.counts["all_gather"] == 6 * (N_FRAMES - 1)
    finally:
        dist.destroy_process_group()
    single = runs["single"]
    np.testing.assert_array_equal(np.stack(poses), single.trajectory[1])
    for d, r in zip(diags, single.records):
        np.testing.assert_array_equal(n(d.n_corr), r.n_corr)
        np.testing.assert_array_equal(n(d.map_sizes), r.map_sizes)
        np.testing.assert_array_equal(n(d.overflow), r.overflow)
    got = convert.flatten_leaves(convert.bpf_state_to_numpy(state))
    for name, value in convert.flatten_leaves(convert.bpf_state_to_numpy(single.state)).items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
