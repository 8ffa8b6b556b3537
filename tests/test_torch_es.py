"""The port's ES odometry slice against the reference package: six frames of
``ESPipeline`` in both packages on the same rendered scans, state carried
across with ``convert.state_from_jax_numpy``, and the entry points' device
rules; the renderer's ``render_sequence`` and a numpy-fed corrupt frame.

Pose tolerance, 1 cm and 2e-3 rad: the cold-start frames of this tiny
16-beam config sit on gate boundaries, and the reference package's own
compiled and eager executions of the same first step already differ by
4.5 mm (measured); later frames agree far closer.  Map sizes agree within
2 % for the same reason (a correspondence flipped at a gate changes which
voxels survive eviction)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfilter_tpu.models import es_odometry as jes
from pfilter_tpu.ops import features as jfeat
from pfilter_tpu.pipeline import ESPipeline as JPipeline
from pfilter_tpu.utils import metrics, synthetic
from pfilter_tpu_torch import convert
from pfilter_tpu_torch.models import es_odometry as tes
from pfilter_tpu_torch.ops import features as tfeat
from pfilter_tpu_torch.pipeline import BPFPipeline, ESPipeline, make_pipeline
from pfilter_tpu_torch.utils import synthetic as tsyn
from torch_parity import n, rotation_angle, t, tiny_config, torch_config

N_FRAMES = 6
CARRY_AT = 3
POS_TOL_M = 1e-2
ROT_TOL_RAD = 2e-3


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = tiny_config()
    world = synthetic.make_world(seed=3, corridor_len=80.0)
    poses = synthetic.make_trajectory(N_FRAMES, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, jcfg.lidar, n_azimuth=512, noise=0.0)
    xyz, valid = np.asarray(xyz), np.asarray(valid)
    jpipe = JPipeline(cfg=jcfg)
    carried = None
    for i in range(N_FRAMES):
        if i == CARRY_AT:
            carried = jax.device_get(jpipe.state)
        jpipe.process_frame(xyz[i], valid[i])
    tpipe = ESPipeline(tcfg, device="cpu")
    for i in range(N_FRAMES):
        tpipe.process_frame(xyz[i], valid[i])
    gt = metrics.poses_to_matrices(np.asarray(poses.q), np.asarray(poses.t))
    gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    return dict(jcfg=jcfg, tcfg=tcfg, xyz=xyz, valid=valid, jpipe=jpipe, tpipe=tpipe, carried=carried, gt=gt)


def test_pipeline_poses_match_reference(runs):
    jq, jt = runs["jpipe"].trajectory
    tq, tt = runs["tpipe"].trajectory
    assert np.isfinite(tq).all() and np.isfinite(tt).all()
    assert np.linalg.norm(tt - jt, axis=1).max() < POS_TOL_M
    assert rotation_angle(tq, jq).max() < ROT_TOL_RAD
    # Both track the ground truth (~4 m driven).
    gt_t = runs["gt"][:, :3, 3]
    assert np.linalg.norm(tt - gt_t, axis=1).max() < 0.05
    assert np.linalg.norm(jt - gt_t, axis=1).max() < 0.05


def test_pipeline_records_match_reference(runs):
    for jr, tr in zip(runs["jpipe"].records, runs["tpipe"].records):
        np.testing.assert_array_equal(tr.overflow, jr.overflow)
        assert abs(tr.edge_map_size - jr.edge_map_size) <= 0.02 * jr.edge_map_size
        assert abs(tr.surf_map_size - jr.surf_map_size) <= 0.02 * jr.surf_map_size
        assert abs(tr.n_surf_corr - jr.n_surf_corr) <= max(0.05 * jr.n_surf_corr, 2)
        assert abs(tr.n_edge_corr - jr.n_edge_corr) <= max(0.05 * jr.n_edge_corr, 2)
    first_j, first_t = runs["jpipe"].records[0], runs["tpipe"].records[0]
    assert (first_t.edge_map_size, first_t.surf_map_size) == (first_j.edge_map_size, first_j.surf_map_size)
    assert runs["tpipe"].overflow_total == runs["jpipe"].overflow_total
    assert runs["tpipe"].n_dropped == runs["jpipe"].n_dropped == 0


def test_state_carried_across_then_stepped(runs):
    """Step the reference 3 frames, carry its state across, step both once more."""
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    state = convert.state_from_jax_numpy(runs["carried"], device="cpu")
    assert state.opt_count == int(runs["carried"].opt_count)
    for f in ("xyz", "rg", "valid", "xyz_t", "tile_start", "origin"):
        np.testing.assert_array_equal(n(getattr(state.surf_map, f)), np.asarray(getattr(runs["carried"].surf_map, f)))
    x, v = runs["xyz"][CARRY_AT], runs["valid"][CARRY_AT]
    tf = tfeat.extract_features(t(x), t(v), tcfg.lidar, tcfg.features, tcfg.capacity)
    new, diag = tes.es_step(state, tf, tcfg)
    jrec = runs["jpipe"].records[CARRY_AT]
    assert np.linalg.norm(n(new.pose.t) - jrec.pose_t) < 2e-3
    assert rotation_angle(n(new.pose.q)[None], jrec.pose_q[None])[0] < 1e-3
    assert abs(int(diag.surf_map_size) - jrec.surf_map_size) <= 0.02 * jrec.surf_map_size
    np.testing.assert_array_equal(n(diag.overflow), jrec.overflow)
    # Round trip through numpy is lossless.
    back = convert.state_from_jax_numpy(convert.state_to_numpy(new), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(convert.state_to_numpy(back)), jax.tree_util.tree_leaves(convert.state_to_numpy(new))):
        np.testing.assert_array_equal(a, b)


def test_first_frame_and_compaction_match(runs):
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    x, v = runs["xyz"][0], runs["valid"][0]
    jf = jfeat.extract_features(jnp.array(x), jnp.array(v), jcfg.lidar, jcfg.features, jcfg.capacity)
    tf = tfeat.extract_features(t(x), t(v), tcfg.lidar, tcfg.features, tcfg.capacity)
    for cap in (64, 4096):
        ja = jes._compact_idx(jf.xyz, jf.surf_mask, cap)
        ta = tes._compact_idx(tf.xyz, tf.surf_mask, cap)
        for a, b in zip(ja, ta):
            np.testing.assert_array_equal(n(b), n(a))
    js = jes.first_frame(jes.init_state(jcfg), jf, jcfg)
    ts = tes.first_frame(tes.init_state(tcfg, device="cpu"), tf, tcfg)
    for kind in ("edge_map", "surf_map"):
        for f in ("xyz", "rg", "valid", "xyz_t", "tile_start", "origin"):
            np.testing.assert_array_equal(n(getattr(getattr(ts, kind), f)), n(getattr(getattr(js, kind), f)))


def test_provenance_channel_matches_on_first_frame(runs):
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    x, v = runs["xyz"][0], runs["valid"][0]
    mover = (np.arange(len(x)) % 5 == 0)
    jp = JPipeline(cfg=jcfg, provenance=True)
    jp.process_frame(x, v, jnp.array(np.pad(mover, (0, jcfg.capacity.scan_points - len(x)))))
    tp = ESPipeline(tcfg, device="cpu", provenance=True)
    tp.process_frame(x, v, mover)
    np.testing.assert_array_equal(tp.records[0].contam, jp.records[0].contam)
    assert tp.records[0].contam.sum() > 0
    tp.process_frame(runs["xyz"][1], runs["valid"][1], mover)
    assert tp.records[1].contam.shape == (2,) and tp.n_dropped == 0


def test_async_fetch_matches_sync(runs):
    tcfg = runs["tcfg"]
    pipe = ESPipeline(tcfg, device="cpu", sync=False, fetch_lag=2)
    out = [pipe.process_frame(runs["xyz"][i], runs["valid"][i]) for i in range(3)]
    assert out[0] is None and out[1] is None and out[2] is not None
    q, tt = pipe.trajectory
    sq, st = runs["tpipe"].trajectory
    # The same computation, bit for bit (torch_parity runs torch on one
    # thread, so the CPU segment sums add in a fixed order).
    np.testing.assert_array_equal(tt, st[:3])
    np.testing.assert_array_equal(q, sq[:3])


def test_entry_points_need_cuda_unless_cpu_is_asked(runs, monkeypatch):
    tcfg = runs["tcfg"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ESPipeline(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.render_scan(tsyn.se3.Pose(np.array([1.0, 0, 0, 0]), np.zeros(3)), tsyn.make_world(seed=0, corridor_len=20.0), tcfg.lidar, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_from_jax_numpy(runs["carried"])
    assert ESPipeline(tcfg, device="cpu").device.type == "cpu"


def test_unported_options_raise(runs):
    """Every single-device option of the reference package runs through the
    port's entry points (the BPF mode, the fast ground pre-filter, the
    per-iteration outer loop, the grid kNN index); an unknown ``knn_impl``
    or ``ground.method`` raises ``ValueError``."""
    tcfg = runs["tcfg"]
    assert isinstance(make_pipeline(tcfg.replace(mode="bpf"), device="cpu"), BPFPipeline)
    assert isinstance(make_pipeline(tcfg, device="cpu"), ESPipeline)
    options = {
        "fast": tcfg.replace(es_ground_filter=True, ground=dataclasses.replace(tcfg.ground, method="fast")),
        "per_iteration": tcfg.replace(odometry=dataclasses.replace(tcfg.odometry, assoc_once=False)),
        "grid": tcfg.replace(capacity=dataclasses.replace(tcfg.capacity, knn_impl="grid")),
    }
    for name, cfg in options.items():
        pipe = make_pipeline(cfg, device="cpu")
        for i in range(2):
            pipe.process_frame(runs["xyz"][i], runs["valid"][i])
        q, tt = pipe.trajectory
        assert np.isfinite(q).all() and np.isfinite(tt).all() and pipe.n_dropped == 0, name
        assert pipe.records[1].n_surf_corr > 0, name
    assert type(pipe.state.edge_map).__name__ == "HashGrid"
    bad_impl = tcfg.replace(capacity=dataclasses.replace(tcfg.capacity, knn_impl="kdtree"))
    with pytest.raises(ValueError, match="knn_impl"):
        ESPipeline(bad_impl, device="cpu").process_frame(runs["xyz"][0], runs["valid"][0])
    bad_ground = options["fast"].replace(ground=dataclasses.replace(tcfg.ground, method="ransac"))
    with pytest.raises(ValueError, match="ground.method"):
        ESPipeline(bad_ground, device="cpu").process_frame(runs["xyz"][0], runs["valid"][0])


@pytest.mark.parametrize("option", ["per_iteration", "grid"])
def test_option_pipeline_matches_reference(runs, option):
    """``assoc_once=False`` (re-association in every outer iteration) and
    ``knn_impl="grid"`` (the grid kNN index, the unfused merge): six frames
    of both packages' ES pipelines on the same scans, held to the slice's
    1 cm / 2e-3 rad and to the same overflow counters."""
    jcfg = runs["jcfg"]
    if option == "per_iteration":
        jcfg = jcfg.replace(odometry=dataclasses.replace(jcfg.odometry, assoc_once=False))
    else:
        jcfg = jcfg.replace(capacity=dataclasses.replace(jcfg.capacity, knn_impl="grid"))
    jpipe, tpipe = JPipeline(cfg=jcfg), ESPipeline(torch_config(jcfg), device="cpu")
    for i in range(N_FRAMES):
        jpipe.process_frame(runs["xyz"][i], runs["valid"][i])
        tpipe.process_frame(runs["xyz"][i], runs["valid"][i])
    jq, jt = jpipe.trajectory
    tq, tt = tpipe.trajectory
    assert np.linalg.norm(tt - jt, axis=1).max() < POS_TOL_M
    assert rotation_angle(tq, jq).max() < ROT_TOL_RAD
    assert np.linalg.norm(tt - runs["gt"][:, :3, 3], axis=1).max() < 0.05
    for jr, tr in zip(jpipe.records, tpipe.records):
        np.testing.assert_array_equal(tr.overflow, jr.overflow)
        assert abs(tr.surf_map_size - jr.surf_map_size) <= 0.02 * jr.surf_map_size
    if option == "grid":  # no tile sort: the tiled lanes stay 0
        assert all(r.overflow[6] == r.overflow[7] == 0 for r in tpipe.records)


def test_outer_variant_parity_second_world():
    """Twin of ``tests/test_es_odometry.py::test_outer_variant_parity_second_world``
    in the port: on a second world (seed 9, clutter), ``assoc_once=True``
    and the per-iteration loop each track the ground truth within 25 cm and
    each other within 8 cm."""
    from tests.test_es_odometry import small_config

    cfg = torch_config(small_config())
    world = synthetic.make_world(seed=9, corridor_len=70.0, clutter_per_100m=4.0)
    n_frames = 10
    poses = synthetic.make_trajectory(n_frames, speed=0.9)
    xyz, valid = synthetic.render_sequence(world, poses, cfg.lidar, n_azimuth=900, noise=0.005)
    xyz, valid = np.asarray(xyz), np.asarray(valid)
    gt = metrics.poses_to_matrices(np.asarray(poses.q), np.asarray(poses.t))
    gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    trajs = {}
    for once in (True, False):
        c = cfg.replace(odometry=dataclasses.replace(cfg.odometry, assoc_once=once))
        feats = [tfeat.extract_features(t(xyz[i]), t(valid[i]), c.lidar, c.features, c.capacity) for i in range(n_frames)]
        state = tes.first_frame(tes.init_state(c, device="cpu"), feats[0], c)
        ts = [n(state.pose.t)]
        for i in range(1, n_frames):
            state, _ = tes.es_step(state, feats[i], c)
            ts.append(n(state.pose.t))
        trajs[once] = np.stack(ts)
    for once, ts in trajs.items():
        err = np.linalg.norm(ts - gt[:, :3, 3], axis=1)
        assert err.max() < 0.25, f"assoc_once={once}: max err {err.max():.3f}"
    gap = np.linalg.norm(trajs[True] - trajs[False], axis=1)
    assert gap.max() < 0.08, f"outer-variant divergence: {gap}"


def test_halo_escape_count_matches(runs):
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    rng = np.random.default_rng(0)
    q = rng.uniform(-30, 30, (500, 3)).astype(np.float32)
    qv = rng.uniform(size=500) > 0.1
    bounds = np.sort(rng.integers(0, 500, jcfg.capacity.knn_tiles**2 + 1)).astype(np.int32)
    origin = np.array([-128.0, -128.0, -128.0], np.float32)
    jc = jes._halo_escape_count(jnp.array(q), jnp.array(qv), jnp.array(bounds), jnp.array(origin), jcfg, "surf")
    tc = tes._halo_escape_count(t(q), t(qv), t(bounds), t(origin), tcfg, "surf")
    assert int(n(tc)) == int(n(jc)) > 0


def test_render_sequence_matches_reference():
    """Frame i is ``render_scan(seed=i, t_time=i)`` in both packages (movers
    advance with the frame); without range noise the validity masks are
    equal and the points agree to float32 ray-casting round-off: 1e-4 m plus
    2e-5 of the range (a ray grazing a wall scales the round-off of its
    direction by 1/sin of the angle; measured 4.6e-4 m at 45 m)."""
    jcfg, tcfg = tiny_config()
    world = synthetic.make_world(seed=5, corridor_len=60.0, n_movers=4)
    poses = synthetic.make_trajectory(3, speed=1.2)
    jx, jv = synthetic.render_sequence(world, poses, jcfg.lidar, n_azimuth=256, noise=0.0)
    tworld = tsyn.make_world(seed=5, corridor_len=60.0, n_movers=4)
    tposes = tsyn.make_trajectory(3, speed=1.2)
    tx, tv = tsyn.render_sequence(tworld, tposes, tcfg.lidar, 256, noise=0.0, device="cpu")
    assert tx.shape == jx.shape and tv.shape == jv.shape
    np.testing.assert_array_equal(n(tv), n(jv))
    np.testing.assert_allclose(n(tx)[n(tv)], n(jx)[n(jv)], rtol=2e-5, atol=1e-4)
    # Seeded noise: frame i is render_scan with seed=i, t_time=i.
    nx, _ = tsyn.render_sequence(tworld, tposes, tcfg.lidar, 256, noise=0.01, device="cpu")
    one, _ = tsyn.render_scan(tsyn.se3.Pose(q=tposes.q[2], t=tposes.t[2]), tworld, tcfg.lidar, 256, noise=0.01, seed=2, t_time=2, device="cpu")
    np.testing.assert_array_equal(n(nx[2]), n(one))


def test_corrupt_frame_dropped_numpy_fed():
    """Twin of ``tests/test_fault_tolerance.py::test_corrupt_frame_dropped``,
    fed numpy scans (the pinned staging path of ``_device_scan``): a garbage
    scan leaves the pose finite and near the pre-fault pose, and tracking
    recovers."""
    from tests.test_es_odometry import small_config

    cfg = small_config()
    world = synthetic.make_world(seed=3, corridor_len=60.0)
    poses = synthetic.make_trajectory(6, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, cfg.lidar, n_azimuth=720, noise=0.004)
    xyz, valid = np.asarray(xyz), np.asarray(valid)
    pipe = ESPipeline(torch_config(cfg), device="cpu", max_jump_m=3.0)
    for i in range(3):
        pipe.process_frame(xyz[i], valid[i])
    t_before = pipe.records[-1].pose_t
    garbage = np.random.default_rng(0).uniform(-500, 500, size=(xyz.shape[1], 3)).astype(np.float32)
    pipe.process_frame(garbage, valid[0])
    t_after = pipe.records[-1].pose_t
    assert np.isfinite(t_after).all()
    assert np.linalg.norm(t_after - t_before) < 3.0
    for i in (3, 4, 5):
        pipe.process_frame(xyz[i], valid[i])
    assert np.isfinite(pipe.records[-1].pose_t).all()
    # Fed the same scans as tensors, the pipeline gives the same poses bit for bit.
    tens = ESPipeline(torch_config(cfg), device="cpu", max_jump_m=3.0)
    for x, v in [(xyz[0], valid[0]), (xyz[1], valid[1]), (xyz[2], valid[2]), (garbage, valid[0])]:
        tens.process_frame(t(x), t(v))
    np.testing.assert_array_equal(np.stack([r.pose_t for r in tens.records]), np.stack([r.pose_t for r in pipe.records[:4]]))
