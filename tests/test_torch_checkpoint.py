"""Checkpoint/resume in the port (``utils/checkpoint.py``): twins of
``tests/test_checkpoint.py`` at its ``small_config`` widths, a BPF round
trip, and checkpoints crossing between the packages in both directions.

Tolerances: a port checkpoint restored in the port resumes bit for bit
(``torch_parity`` runs torch on one thread).  A reference checkpoint resumed
in the port is held to the ES parity tolerance of ``tests/test_torch_es.py``,
1 cm / 2e-3 rad, against the reference's own continuation; a port
checkpoint restored in the reference equals the port's state array for
array."""

import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from pfilter_tpu.models import bpf_odometry as jbo
from pfilter_tpu.models import es_odometry as jes
from pfilter_tpu.pipeline import ESPipeline as JPipeline
from pfilter_tpu.utils import checkpoint as jckpt
from pfilter_tpu.utils import synthetic
from pfilter_tpu_torch import convert
from pfilter_tpu_torch.models import bpf_odometry as tbo
from pfilter_tpu_torch.models import es_odometry as tes
from pfilter_tpu_torch.ops import features as tfeat
from pfilter_tpu_torch.pipeline import ESPipeline
from pfilter_tpu_torch.utils import checkpoint
from tests.test_es_odometry import small_config
from torch_parity import n, rotation_angle, t, torch_config

POS_TOL_M = 1e-2
ROT_TOL_RAD = 2e-3
ES_LEAVES = (
    [f"edge_map.{f}" for f in ("xyz", "rg", "valid", "xyz_t", "tile_start", "origin")]
    + [f"surf_map.{f}" for f in ("xyz", "rg", "valid", "xyz_t", "tile_start", "origin")]
    + ["pose.q", "pose.t", "last_pose.q", "last_pose.t", "opt_count", "pg_q", "pg_t", "pg_h", "pg_valid"]
)


@pytest.fixture(scope="module")
def scans():
    cfg = small_config()
    world = synthetic.make_world(seed=3, corridor_len=60.0)
    poses = synthetic.make_trajectory(6, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, cfg.lidar, n_azimuth=720, noise=0.004)
    return cfg, torch_config(cfg), np.asarray(xyz), np.asarray(valid)


def _extract(tcfg, xyz, valid, i):
    return tfeat.extract_features(t(xyz[i]), t(valid[i]), tcfg.lidar, tcfg.features, tcfg.capacity)


def _port_state(tcfg, xyz, valid, frames):
    state = tes.first_frame(tes.init_state(tcfg, device="cpu"), _extract(tcfg, xyz, valid, 0), tcfg)
    for i in frames:
        state, _ = tes.es_step(state, _extract(tcfg, xyz, valid, i), tcfg)
    return state


@pytest.fixture(scope="module")
def port_run(scans):
    _, tcfg, xyz, valid = scans
    return _port_state(tcfg, xyz, valid, (1, 2, 3))


def test_leaf_names_are_the_reference_order(scans, tmp_path):
    _, tcfg, _, _ = scans
    state = tes.init_state(tcfg, device="cpu")
    checkpoint.save_state(tmp_path / "ckpt", state)
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["leaf_names"] == ES_LEAVES and meta["n_leaves"] == 21
    flat, treedef = __import__("jax").tree_util.tree_flatten_with_path(jes.init_state(scans[0]))
    assert meta["treedef"] == str(treedef)
    with np.load(tmp_path / "ckpt" / "state.npz") as z:
        assert z["opt_count"].dtype == np.int32 and z["opt_count"].shape == ()


def test_roundtrip_and_resume(scans, port_run, tmp_path):
    _, tcfg, xyz, valid = scans
    state = port_run
    checkpoint.save_state(tmp_path / "ckpt", state, step=3, extra={"seq": "synthetic"})
    template = tes.first_frame(tes.init_state(tcfg, device="cpu"), _extract(tcfg, xyz, valid, 0), tcfg)
    restored, meta = checkpoint.restore_state(tmp_path / "ckpt", template)
    assert meta["step"] == 3 and meta["extra"] == {"seq": "synthetic"}
    assert isinstance(restored.opt_count, int) and restored.opt_count == state.opt_count
    np.testing.assert_array_equal(n(restored.pose.t), n(state.pose.t))
    np.testing.assert_array_equal(n(restored.surf_map.valid), n(state.surf_map.valid))
    # Continue both for 2 more frames: identical trajectories.
    for i in (4, 5):
        state, _ = tes.es_step(state, _extract(tcfg, xyz, valid, i), tcfg)
        restored, _ = tes.es_step(restored, _extract(tcfg, xyz, valid, i), tcfg)
    np.testing.assert_array_equal(n(state.pose.t), n(restored.pose.t))
    np.testing.assert_array_equal(n(state.pose.q), n(restored.pose.q))


def test_shape_mismatch_rejected(scans, tmp_path):
    _, tcfg, _, _ = scans
    checkpoint.save_state(tmp_path / "ckpt", tes.init_state(tcfg, device="cpu"))
    cfg2 = replace(tcfg, capacity=replace(tcfg.capacity, edge_map_points=8192))
    with pytest.raises(ValueError, match="edge_map"):
        checkpoint.restore_state(tmp_path / "ckpt", tes.init_state(cfg2, device="cpu"))


def test_unknown_leaf_rejected(scans, tmp_path):
    _, tcfg, _, _ = scans
    checkpoint.save_state(tmp_path / "ckpt", tes.init_state(tcfg, device="cpu"))
    p = tmp_path / "ckpt" / "state.npz"
    with np.load(p) as z:
        kept = {k: z[k] for k in z.files}
    kept["extra_map.xyz"] = np.zeros(3, np.float32)
    np.savez_compressed(p, **kept)
    with pytest.raises(ValueError, match="unknown to the template"):
        checkpoint.restore_state(tmp_path / "ckpt", tes.init_state(tcfg, device="cpu"))


def test_missing_pg_leaves_backfilled(scans, tmp_path):
    """A checkpoint without the pg_* leaves restores with the template's
    pose-graph window."""
    _, tcfg, _, _ = scans
    state = tes.init_state(tcfg, device="cpu")
    state = state._replace(pose=state.pose._replace(t=torch.ones(3)))
    checkpoint.save_state(tmp_path / "ckpt", state, step=7)
    p = tmp_path / "ckpt" / "state.npz"
    with np.load(p) as z:
        kept = {k: z[k] for k in z.files if not k.startswith("pg_")}
    np.savez_compressed(p, **kept)
    meta_p = tmp_path / "ckpt" / "meta.json"
    meta = json.loads(meta_p.read_text())
    meta["leaf_names"] = [k for k in meta["leaf_names"] if not k.startswith("pg_")]
    meta["n_leaves"] = len(meta["leaf_names"])
    meta_p.write_text(json.dumps(meta))
    template = tes.init_state(tcfg, device="cpu")
    restored, rmeta = checkpoint.restore_state(tmp_path / "ckpt", template)
    assert sorted(rmeta["restored_from_template"]) == ["pg_h", "pg_q", "pg_t", "pg_valid"]
    np.testing.assert_array_equal(n(restored.pose.t), np.ones(3))
    np.testing.assert_array_equal(n(restored.pg_valid), n(template.pg_valid))
    # Any other missing leaf raises.
    with np.load(p) as z:
        kept = {k: z[k] for k in z.files if k != "pose.q"}
    np.savez_compressed(p, **kept)
    with pytest.raises(ValueError, match="pose.q"):
        checkpoint.restore_state(tmp_path / "ckpt", template)


def test_window_resize_backfills_pg(scans, tmp_path):
    _, tcfg, _, _ = scans
    state = tes.init_state(tcfg, device="cpu")
    state = state._replace(pose=state.pose._replace(t=2.0 * torch.ones(3)))
    checkpoint.save_state(tmp_path / "ckpt", state)
    cfg2 = replace(tcfg, pose_graph=replace(tcfg.pose_graph, window=tcfg.pose_graph.window + 3))
    restored, meta = checkpoint.restore_state(tmp_path / "ckpt", tes.init_state(cfg2, device="cpu"))
    assert sorted(meta["restored_from_template"]) == ["pg_h", "pg_q", "pg_t", "pg_valid"]
    assert restored.pg_q.shape[0] == tcfg.pose_graph.window + 3
    np.testing.assert_array_equal(n(restored.pose.t), 2.0 * np.ones(3))


def test_legacy_positional_checkpoint_restores(scans, port_run, tmp_path):
    """``leaf_{i}`` positional checkpoints restore in the reference's leaf order."""
    _, tcfg, _, _ = scans
    checkpoint.save_state(tmp_path / "ckpt", port_run, step=2)
    leaves = list(convert.flatten_leaves(convert.state_to_numpy(port_run)).values())
    np.savez_compressed(tmp_path / "ckpt" / "state.npz", **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    meta_p = tmp_path / "ckpt" / "meta.json"
    meta = json.loads(meta_p.read_text())
    del meta["leaf_names"]
    meta["n_leaves"] = len(leaves)
    meta_p.write_text(json.dumps(meta))
    restored, rmeta = checkpoint.restore_state(tmp_path / "ckpt", tes.init_state(tcfg, device="cpu"))
    assert rmeta["step"] == 2 and restored.opt_count == port_run.opt_count
    for a, b in zip(convert.flatten_leaves(convert.state_to_numpy(restored)).values(), leaves):
        np.testing.assert_array_equal(a, b)


def test_bpf_state_roundtrip(scans, tmp_path):
    jcfg, tcfg, _, _ = scans
    tcfg, jcfg = tcfg.replace(mode="bpf"), jcfg.replace(mode="bpf")
    state = tbo.init_state(tcfg, device="cpu")
    state = state._replace(pose=state.pose._replace(t=torch.tensor([1.0, 2.0, 3.0])), opt_count=5)
    checkpoint.save_state(tmp_path / "ckpt", state, step=1)
    restored, _ = checkpoint.restore_state(tmp_path / "ckpt", tbo.init_state(tcfg, device="cpu"))
    assert isinstance(restored, tbo.BPFState) and restored.opt_count == 5
    want = convert.flatten_leaves(convert.bpf_state_to_numpy(state))
    for k, a in convert.flatten_leaves(convert.bpf_state_to_numpy(restored)).items():
        np.testing.assert_array_equal(a, want[k])
    # The reference package reads it into its own BPFState.
    jstate, _ = jckpt.restore_state(tmp_path / "ckpt", jbo.init_state(jcfg))
    np.testing.assert_array_equal(np.asarray(jstate.pose.t), [1.0, 2.0, 3.0])
    assert int(jstate.opt_count) == 5


def test_reference_checkpoint_resumes_in_port(scans, tmp_path):
    """A checkpoint written by ``pfilter_tpu.utils.checkpoint.save_state``
    restores in the port and continues 2 frames like the reference does."""
    jcfg, tcfg, xyz, valid = scans
    jpipe = JPipeline(cfg=jcfg)
    for i in range(4):
        jpipe.process_frame(xyz[i], valid[i])
    jckpt.save_state(tmp_path / "ref", jpipe.state, step=3)
    restored, meta = checkpoint.restore_state(tmp_path / "ref", tes.init_state(tcfg, device="cpu"))
    assert meta["restored_from_template"] == [] and restored.opt_count == int(jpipe.state.opt_count)
    pipe = ESPipeline(tcfg, device="cpu", state=restored)
    for i in (4, 5):
        jpipe.process_frame(xyz[i], valid[i])
        pipe.process_frame(xyz[i], valid[i])
    jq, jt = jpipe.trajectory
    q, tt = pipe.trajectory
    assert np.linalg.norm(tt - jt[4:], axis=1).max() < POS_TOL_M
    assert rotation_angle(q, jq[4:]).max() < ROT_TOL_RAD


def test_port_checkpoint_restores_in_reference(scans, port_run, tmp_path):
    jcfg, _, _, _ = scans
    checkpoint.save_state(tmp_path / "port", port_run, step=3)
    jstate, meta = jckpt.restore_state(tmp_path / "port", jes.init_state(jcfg))
    assert meta["restored_from_template"] == []
    import jax

    got = {jckpt._leaf_name(kp): np.asarray(x) for kp, x in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    want = convert.flatten_leaves(convert.state_to_numpy(port_run))
    assert list(got) == list(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype, k
        np.testing.assert_array_equal(got[k], a)


GRID_MAP_FIELDS = ("xyz", "rg", "valid", "cell_ids", "origin", "cell_size")


def test_grid_state_checkpoints_cross_both_ways(scans, tmp_path):
    """A grid-index ES state (``knn_impl="grid"``: ``HashGrid`` maps) saved
    by each package restores in the other, leaf for leaf in the reference's
    names and order, and the port's grid state steps on after a round trip
    bit for bit."""
    import jax

    jcfg, tcfg, xyz, valid = scans
    jcfg = jcfg.replace(capacity=replace(jcfg.capacity, knn_impl="grid"))
    tcfg = torch_config(jcfg)
    leaves = (
        [f"edge_map.{f}" for f in GRID_MAP_FIELDS]
        + [f"surf_map.{f}" for f in GRID_MAP_FIELDS]
        + ["pose.q", "pose.t", "last_pose.q", "last_pose.t", "opt_count", "pg_q", "pg_t", "pg_h", "pg_valid"]
    )
    # Port -> reference.
    state = _port_state(tcfg, xyz, valid, (1, 2))
    checkpoint.save_state(tmp_path / "port", state, step=2)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta["leaf_names"] == leaves
    assert meta["treedef"] == str(jax.tree_util.tree_structure(jes.init_state(jcfg)))
    jstate, jmeta = jckpt.restore_state(tmp_path / "port", jes.init_state(jcfg))
    assert jmeta["restored_from_template"] == []
    got = {jckpt._leaf_name(kp): np.asarray(x) for kp, x in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    want = convert.flatten_leaves(convert.state_to_numpy(state))
    assert list(got) == list(want) == leaves
    for k, a in want.items():
        assert got[k].dtype == a.dtype, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    # Port -> port: the restored state steps on bit for bit.
    restored, _ = checkpoint.restore_state(tmp_path / "port", tes.init_state(tcfg, device="cpu"))
    assert type(restored.edge_map).__name__ == "HashGrid"
    a, _ = tes.es_step(state, _extract(tcfg, xyz, valid, 3), tcfg)
    b, _ = tes.es_step(restored, _extract(tcfg, xyz, valid, 3), tcfg)
    for x, y in zip(jax.tree_util.tree_leaves(convert.state_to_numpy(a)), jax.tree_util.tree_leaves(convert.state_to_numpy(b))):
        np.testing.assert_array_equal(x, y)
    # Reference -> port.
    jpipe = JPipeline(cfg=jcfg)
    for i in range(3):
        jpipe.process_frame(xyz[i], valid[i])
    jckpt.save_state(tmp_path / "ref", jpipe.state, step=2)
    tstate, tmeta = checkpoint.restore_state(tmp_path / "ref", tes.init_state(tcfg, device="cpu"))
    assert tmeta["restored_from_template"] == [] and tmeta["leaf_names"] == leaves
    ref = {jckpt._leaf_name(kp): np.asarray(x) for kp, x in jax.tree_util.tree_flatten_with_path(jpipe.state)[0]}
    back = convert.flatten_leaves(convert.state_to_numpy(tstate))
    assert list(back) == list(ref)
    for k, x in ref.items():
        np.testing.assert_array_equal(back[k], x, err_msg=k)
