"""The port's map-sharded ES step (``pfilter_tpu_torch/parallel/``) against
the reference package's (``pfilter_tpu/parallel/``), on the CPU: the twin of
``tests/test_es_sharded.py`` and of the sharded halves of
``tests/test_weighting.py`` and ``tests/test_pose_graph.py``.

The reference runs ``jax.shard_map`` on the suite's 8 virtual CPU devices in
this process; the port runs one gloo process per cell of the seq x map grid
(``tests/torch_dist.py``).  Each grid size spawns its workers once and runs
all its cases in them; the one-rank case runs in this process.  Scans are the 16-beam tiny config's
(``torch_parity.tiny_config``), five frames.

Tolerances: after the first frame no optimisation has run, so each shard's
maps equal the reference shard's exactly (hash, ownership, compaction and
capacity decide them).  Poses are held to the ES slice's cold-start
tolerance, 1 cm / 2e-3 rad, and correspondence counts and map sizes to 5 %
(``ROADMAP.md`` "Cold-start spread"); with ``weight_type=2`` the port is
stepped from the reference's state before every frame, as the single-device
weighting twin is.  With one shard the step equals the port's
single-device ``ESPipeline`` bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch.distributed as dist

from pfilter_tpu.parallel import es_sharded as jes_sharded
from pfilter_tpu.utils import synthetic
from pfilter_tpu_torch import convert
from pfilter_tpu_torch.parallel import mesh
from pfilter_tpu_torch.parallel.pipeline import ShardedESPipeline
from pfilter_tpu_torch.pipeline import ESPipeline
from torch_dist import Workers, job, rank_output, run_reference, write_scans, write_state
from torch_parity import rotation_angle, tiny_config, torch_config

N_FRAMES = 5
OPTION_FRAMES = 3
POS_TOL_M = 1e-2
ROT_TOL_RAD = 2e-3
COUNT_TOL = 0.05
MAP_FIELDS = ("edge_map", "surf_map")


def _render(jcfg, seed, corridor_len, speed):
    world = synthetic.make_world(seed=seed, corridor_len=corridor_len)
    poses = synthetic.make_trajectory(N_FRAMES, speed=speed)
    xyz, valid = synthetic.render_sequence(world, poses, jcfg.lidar, n_azimuth=512, noise=0.0)
    return np.asarray(xyz), np.asarray(valid)


def _options(jcfg):
    return {
        "weighted": jcfg.replace(
            odometry=dataclasses.replace(jcfg.odometry, weight_type=2),
            pose_graph=dataclasses.replace(jcfg.pose_graph, enabled=True, window=6),
        ),
        "per_iteration": jcfg.replace(odometry=dataclasses.replace(jcfg.odometry, assoc_once=False)),
        "grid": jcfg.replace(capacity=dataclasses.replace(jcfg.capacity, knn_impl="grid")),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("es_sharded")
    jcfg, _ = tiny_config()
    xyz_a, valid_a = _render(jcfg, 3, 80.0, 0.8)
    xyz_b, valid_b = _render(jcfg, 11, 45.0, 0.6)
    one = write_scans(tmp / "one.npz", xyz_a[None], valid_a[None])
    two = write_scans(tmp / "two.npz", np.stack([xyz_a, xyz_b]), np.stack([valid_a, valid_b]))
    opts = _options(jcfg)

    # The reference's weighted states first, so that every grid of workers
    # can start and run beside the reference's other runs.
    weighted = run_reference(jes_sharded, opts["weighted"], xyz_a[None], valid_a[None], 1, 2, N_FRAMES, keep=range(N_FRAMES - 1))
    states = {i + 1: write_state(tmp / f"weighted_state{i}.npz", s) for i, s in weighted["states"].items()}
    workers = [
        Workers(tmp, "four", 4, [job(jcfg, 1, 4, one, tmp / "a4", frames=1, save_states=[0]), job(jcfg, 2, 2, two, tmp / "d")]),
        Workers(
            tmp, "two", 2,
            [
                job(jcfg, 1, 2, one, tmp / "b", save_states=[0]),
                job(opts["weighted"], 1, 2, one, tmp / "c", states=states),
                job(opts["per_iteration"], 1, 2, one, tmp / "f_per_iteration", frames=OPTION_FRAMES),
                job(opts["grid"], 1, 2, one, tmp / "f_grid", frames=OPTION_FRAMES),
            ],
        ),
    ]
    ref = {
        "weighted": weighted,
        "default": run_reference(jes_sharded, jcfg, xyz_a[None], valid_a[None], 1, 2, N_FRAMES, keep=(0,)),
        "four": run_reference(jes_sharded, jcfg, xyz_a[None], valid_a[None], 1, 4, 1, keep=(0,)),
        "per_iteration": run_reference(jes_sharded, opts["per_iteration"], xyz_a[None], valid_a[None], 1, 2, OPTION_FRAMES),
        "grid": run_reference(jes_sharded, opts["grid"], xyz_a[None], valid_a[None], 1, 2, OPTION_FRAMES),
    }
    # The port's single-device runs of both worlds, in this process.
    singles = []
    for x, v in ((xyz_a, valid_a), (xyz_b, valid_b)):
        pipe = ESPipeline(torch_config(jcfg), device="cpu")
        for i in range(N_FRAMES):
            pipe.process_frame(x[i], v[i])
        singles.append(pipe)
    for w in workers:
        w.wait()
    return dict(tmp=tmp, ref=ref, singles=singles, jcfg=jcfg, xyz=xyz_a, valid=valid_a)


def _out(runs, name, rank=0):
    return rank_output(runs["tmp"] / name, rank)


def _assert_poses_close(got, want_q, want_t, what, record_property):
    """Poses within the slice's tolerance; the largest gaps go into the
    test report's properties (``--junitxml``)."""
    gap_t = np.linalg.norm(got["pose_t"] - want_t, axis=1)
    gap_r = rotation_angle(got["pose_q"], want_q)
    record_property("max_gap_m", float(gap_t.max()))
    record_property("max_gap_rad", float(gap_r.max()))
    assert np.isfinite(got["pose_t"]).all()
    assert gap_t.max() < POS_TOL_M and gap_r.max() < ROT_TOL_RAD, f"{what}: gaps {gap_t} m, {gap_r} rad"


def _reference_counts(diags):
    corr = np.array([[int(d.n_edge_corr[0]), int(d.n_surf_corr[0])] for d in diags])
    sizes = np.array([[int(d.edge_map_size[0]), int(d.surf_map_size[0])] for d in diags])
    return corr, sizes


def _points(leaves, prefix, kind):
    valid = leaves[f"{prefix}.{kind}.valid"]
    pts = np.concatenate([leaves[f"{prefix}.{kind}.xyz"], leaves[f"{prefix}.{kind}.rg"]], 1)[valid]
    return pts[np.lexsort(pts.T[::-1])]


@pytest.mark.parametrize("n_map", [2, 4])
def test_first_frame_shards_equal_reference(runs, n_map):
    """(a) Each rank's edge and surf maps after the first frame equal the
    reference shard's block exactly, as point sets (coordinates and counters)."""
    ref = runs["ref"]["default" if n_map == 2 else "four"]["states"][0]
    name = "b" if n_map == 2 else "a4"
    for shard in range(n_map):
        got = _out(runs, name, shard)
        for kind in MAP_FIELDS:
            m = getattr(ref, kind)
            valid = np.asarray(m.valid)[0, shard]
            want = np.concatenate([np.asarray(m.xyz)[0, shard], np.asarray(m.rg)[0, shard]], 1)[valid]
            want = want[np.lexsort(want.T[::-1])]
            have = _points(got, "state0", kind)
            assert len(want) > 50, (kind, shard, len(want))
            np.testing.assert_array_equal(have, want, err_msg=f"{kind} shard {shard} of {n_map}")


def test_poses_match_reference(runs, record_property):
    """(b) Five frames at n_seq=1, n_map=2: poses within 1 cm / 2e-3 rad of
    the reference's sharded run; both ranks of the row hold the same poses."""
    ref = runs["ref"]["default"]
    got = _out(runs, "b")
    _assert_poses_close(got, ref["q"][0], ref["t"][0], "n_map=2", record_property)
    other = _out(runs, "b", 1)
    np.testing.assert_array_equal(other["pose_t"], got["pose_t"])
    np.testing.assert_array_equal(other["pose_q"], got["pose_q"])
    # The trajectory moved (a frozen step would match a frozen reference).
    assert np.linalg.norm(got["pose_t"][-1]) > 2.0


def test_counts_and_map_sizes_match_reference(runs):
    """(b) Correspondence counts and map sizes within 5 %, overflow lanes equal."""
    ref = runs["ref"]["default"]
    got = _out(runs, "b")
    corr, sizes = _reference_counts(ref["diags"])
    assert (corr[1:] > 0).all()
    assert np.all(np.abs(got["n_corr"] - corr) <= np.maximum(COUNT_TOL * corr, 2)), (got["n_corr"], corr)
    assert np.all(np.abs(got["map_sizes"] - sizes) <= COUNT_TOL * sizes), (got["map_sizes"], sizes)
    np.testing.assert_array_equal(got["overflow"], np.stack([np.asarray(d.overflow[0]) for d in ref["diags"]]))


def test_weighted_smoother_steps_from_reference_state(runs, record_property):
    """(c) ``weight_type=2`` (the shards' min/max all-reduce) with the
    smoother on: each frame stepped from the reference's sharded state,
    carried across with ``convert.sharded_state_from_jax_numpy``."""
    ref = runs["ref"]["weighted"]
    got = _out(runs, "c")
    sl = slice(1, N_FRAMES)
    _assert_poses_close({k: got[k][sl] for k in ("pose_q", "pose_t")}, ref["q"][0, sl], ref["t"][0, sl], "weighted", record_property)
    corr, sizes = _reference_counts(ref["diags"])
    assert np.all(np.abs(got["n_corr"][sl] - corr[sl]) <= np.maximum(COUNT_TOL * corr[sl], 2)), (got["n_corr"], corr)


def test_distinct_sequences_track_their_own_baselines(runs, record_property):
    """(d) n_seq=2, n_map=2 on two different worlds: each row tracks its own
    single-device run (the seq axis carries no communication), and the rows
    differ."""
    rows = [_out(runs, "d", 0), _out(runs, "d", 2)]
    np.testing.assert_array_equal(_out(runs, "d", 1)["pose_t"], rows[0]["pose_t"])
    np.testing.assert_array_equal(_out(runs, "d", 3)["pose_t"], rows[1]["pose_t"])
    assert np.linalg.norm(rows[0]["pose_t"][-1] - rows[1]["pose_t"][-1]) > 1e-3
    for i, (row, single) in enumerate(zip(rows, runs["singles"])):
        gap = np.linalg.norm(row["pose_t"] - single.trajectory[1], axis=1)
        record_property(f"row{i}_max_gap_m", float(gap.max()))
        assert gap.max() < 5e-2, gap


def test_one_shard_equals_single_device(runs, tmp_path):
    """(e) n_map=1 over gloo (a group of one rank, in this process, one
    intra-op thread as the single-device run) equals the port's
    single-device ``ESPipeline`` bit for bit: poses, records and the final
    state (a collective of one rank is a copy, the merge of one shard's
    candidates the identity)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        pipe = ShardedESPipeline(torch_config(runs["jcfg"]), mesh=mesh.make_mesh(1, 1, device="cpu"))
        for i in range(N_FRAMES):
            pipe.process_frame(runs["xyz"][i], runs["valid"][i])
    finally:
        dist.destroy_process_group()
    single = runs["singles"][0]
    for a, b in zip(pipe.trajectory, single.trajectory):
        np.testing.assert_array_equal(a, b)
    for r, w in zip(pipe.records, single.records):
        np.testing.assert_array_equal(r.overflow, w.overflow)
        assert (r.n_edge_corr, r.n_surf_corr, r.edge_map_size, r.surf_map_size) == (w.n_edge_corr, w.n_surf_corr, w.edge_map_size, w.surf_map_size)
    got = convert.flatten_leaves(convert.to_numpy(pipe.state))
    for name, value in convert.flatten_leaves(convert.to_numpy(single.state)).items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.mark.parametrize("option", ["per_iteration", "grid"])
def test_option_matches_reference(runs, option, record_property):
    """(f) ``assoc_once=False`` (a collective re-association in every outer
    iteration) and ``knn_impl="grid"`` (grid shards, the anchored unfused
    merge) at n_map=2, three frames, at the tolerances of (b)."""
    ref = runs["ref"][option]
    got = _out(runs, f"f_{option}")
    _assert_poses_close(got, ref["q"][0], ref["t"][0], option, record_property)
    corr, sizes = _reference_counts(ref["diags"])
    assert np.all(np.abs(got["map_sizes"] - sizes) <= COUNT_TOL * sizes), (got["map_sizes"], sizes)
    assert np.all(np.abs(got["n_corr"] - corr) <= np.maximum(COUNT_TOL * corr, 2)), (got["n_corr"], corr)
