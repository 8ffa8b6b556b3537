"""The port's BPF slice against the reference package, on the CPU: the
front-end's masks for both moment back-ends, four frames of ``BPFPipeline``
in both packages on the same rendered scans (``tests/test_bpf.py``'s
32-beam ``small_config`` widths), one ``bpf_step`` from a state carried
across with ``convert.bpf_state_from_jax_numpy``, and the ES pre-filters.

Front-end masks are compared with the reference compiled, as its pipelines
run it, and agree exactly: the port bins DCVC's azimuths as the compiled
reference does (``ops/dcvc.py``).  The reference's own compiled and eager
front-ends differ by ~120 of 11k non-ground points on frame 0 (XLA turns the
division by the bin width into a product with its reciprocal, and on this
scan's 0.3-degree azimuth grid one ray in four sits on a 1.2-degree bin's
half; ``tests/test_torch_dcvc.py``).  Pipeline poses are held to the ES
slice's 1 cm / 2e-3 rad and counts to 5 %.  The carried-over step gets the
reference's compiled masks, which isolates the odometry: 2 mm / 1e-3 rad."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfilter_tpu.models import bpf_frontend as jfe
from pfilter_tpu.models import bpf_odometry as jbo
from pfilter_tpu.ops import dcvc as jdcvc
from pfilter_tpu.ops import ground as jground
from pfilter_tpu.pipeline import BPFPipeline as JPipeline
from pfilter_tpu.utils import metrics, synthetic
from pfilter_tpu_torch import convert
from pfilter_tpu_torch.models import bpf_frontend as tfe
from pfilter_tpu_torch.models import bpf_odometry as tbo
from pfilter_tpu_torch.pipeline import BPFPipeline, ESPipeline, make_pipeline
from test_bpf import small_config
from torch_parity import n, rotation_angle, t, torch_config

N_FRAMES = 4
CARRY_AT = 2
POS_TOL_M = 1e-2
ROT_TOL_RAD = 2e-3


@pytest.fixture(scope="module")
def runs():
    jcfg = small_config()
    tcfg = torch_config(jcfg)
    world = synthetic.make_world(seed=5, corridor_len=60.0)
    poses = synthetic.make_trajectory(N_FRAMES, speed=0.8)
    xyz, valid = synthetic.render_sequence(world, poses, jcfg.lidar, n_azimuth=1200, noise=0.004)
    xyz, valid = np.asarray(xyz), np.asarray(valid)
    jpipe = JPipeline(cfg=jcfg)
    carried = None
    for i in range(N_FRAMES):
        if i == CARRY_AT:
            carried = jax.device_get(jpipe.state)
        jpipe.process_frame(xyz[i], valid[i])
    tpipe = BPFPipeline(tcfg, device="cpu")
    for i in range(N_FRAMES):
        tpipe.process_frame(xyz[i], valid[i])
    gt = metrics.poses_to_matrices(np.asarray(poses.q), np.asarray(poses.t))
    gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    return dict(jcfg=jcfg, tcfg=tcfg, xyz=xyz, valid=valid, jpipe=jpipe, tpipe=tpipe, carried=carried, gt=gt)


@pytest.mark.parametrize(
    "impl,overrides,filters",
    [
        ("voxel", {}, (True, True)),
        ("voxel", {"ground_as_facade": False}, (True, False)),
        ("radius", {}, (True, True)),
    ],
)
def test_frontend_masks_match_reference(runs, impl, overrides, filters):
    jcfg = runs["jcfg"]
    jcfg = jcfg.replace(pca=dataclasses.replace(jcfg.pca, impl=impl, **overrides))
    if impl == "radius":  # a cap the dense near-sensor rows overflow: the counter is compared too
        jcfg = jcfg.replace(capacity=dataclasses.replace(jcfg.capacity, frontend_tile_cap=128))
    tcfg = torch_config(jcfg)
    x, v = runs["xyz"][0], runs["valid"][0]
    want = jax.jit(lambda a, b: jfe.run_frontend(a, b, jcfg, *filters))(jnp.asarray(x), jnp.asarray(v))
    got = tfe.run_frontend(t(x), t(v), tcfg, *filters)
    for f in tfe.FrontendResult._fields:
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    assert n(got.facade_mask).sum() > 1000 and n(got.pillar_mask).sum() > 10
    assert (int(n(got.n_halo_truncated)) > 0) == (impl == "radius")


def test_pipeline_poses_match_reference(runs):
    jq, jt = runs["jpipe"].trajectory
    tq, tt = runs["tpipe"].trajectory
    assert np.isfinite(tq).all() and np.isfinite(tt).all()
    assert np.linalg.norm(tt - jt, axis=1).max() < POS_TOL_M
    assert rotation_angle(tq, jq).max() < ROT_TOL_RAD
    # Both track the ground truth within test_bpf.py's ATE bound.
    est = metrics.poses_to_matrices(tq, tt)
    assert metrics.ate_rmse(runs["gt"], est) < 0.2


def test_pipeline_records_match_reference(runs):
    for jr, tr in zip(runs["jpipe"].records, runs["tpipe"].records):
        np.testing.assert_array_equal(tr.overflow, jr.overflow)
        assert tr.n_scan_trunc == jr.n_scan_trunc == 0
        for a, b in zip(tr.map_sizes, jr.map_sizes):
            assert abs(int(a) - int(b)) <= max(0.05 * b, 8)
        for a, b in zip(tr.n_corr, jr.n_corr):
            assert abs(int(a) - int(b)) <= max(0.05 * b, 4)
    assert runs["tpipe"].overflow_total == runs["jpipe"].overflow_total == 0
    assert runs["tpipe"].n_dropped == runs["jpipe"].n_dropped == 0
    assert runs["tpipe"].records[-1].n_corr.sum() > 500


def test_state_carried_across_then_stepped(runs):
    """Carry the reference's state after 2 frames across, then step both
    packages once on the reference's own (compiled) front-end masks."""
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    state = convert.bpf_state_from_jax_numpy(runs["carried"], device="cpu")
    assert state.opt_count == int(runs["carried"].opt_count)
    for kind in ("beam_map", "pillar_map", "facade_map"):
        for f in ("xyz", "rg", "valid", "xyz_t", "tile_start", "origin"):
            np.testing.assert_array_equal(n(getattr(getattr(state, kind), f)), np.asarray(getattr(getattr(runs["carried"], kind), f)))
    x, v = runs["xyz"][CARRY_AT], runs["valid"][CARRY_AT]
    fr = jax.jit(lambda a, b: jfe.run_frontend(a, b, jcfg))(jnp.asarray(x), jnp.asarray(v))
    masks = {k: t(np.asarray(getattr(fr, k + "_mask"))) for k in tbo.CHANNELS}
    new, diag = tbo.bpf_step(state, t(x), masks, tcfg)
    jrec = runs["jpipe"].records[CARRY_AT]
    assert np.linalg.norm(n(new.pose.t) - jrec.pose_t) < 2e-3
    assert rotation_angle(n(new.pose.q)[None], jrec.pose_q[None])[0] < 1e-3
    np.testing.assert_array_equal(n(diag.overflow), jrec.overflow)
    for a, b in zip(n(diag.map_sizes), jrec.map_sizes):
        assert abs(int(a) - int(b)) <= max(0.02 * b, 4)
    # Round trip through numpy is lossless.
    back = convert.bpf_state_from_jax_numpy(convert.bpf_state_to_numpy(new), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(convert.bpf_state_to_numpy(back)), jax.tree_util.tree_leaves(convert.bpf_state_to_numpy(new))):
        np.testing.assert_array_equal(a, b)
    merged = tbo.merged_map(new)
    assert int(n(merged.valid).sum()) == int(n(diag.map_sizes).sum())


def test_first_frame_matches_reference(runs):
    """Seeding the three maps from the same masks gives the same maps."""
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    x, v = runs["xyz"][0], runs["valid"][0]
    fr = jfe.run_frontend(jnp.asarray(x), jnp.asarray(v), jcfg)
    jm = {k: getattr(fr, k + "_mask") for k in tbo.CHANNELS}
    js = jbo.first_frame(jbo.init_state(jcfg), jnp.asarray(x), jm, jcfg)
    ts = tbo.first_frame(tbo.init_state(tcfg, device="cpu"), t(x), {k: t(np.asarray(m)) for k, m in jm.items()}, tcfg)
    for kind in ("beam_map", "pillar_map", "facade_map"):
        for f in ("xyz", "rg", "valid", "xyz_t", "tile_start", "origin"):
            np.testing.assert_array_equal(n(getattr(getattr(ts, kind), f)), np.asarray(getattr(getattr(js, kind), f)), err_msg=f"{kind}.{f}")


def test_async_fetch_matches_sync(runs):
    pipe = BPFPipeline(runs["tcfg"], device="cpu", sync=False, fetch_lag=2)
    out = [pipe.process_frame(runs["xyz"][i], runs["valid"][i]) for i in range(3)]
    assert out[0] is None and out[1] is None and out[2] is not None
    q, tt = pipe.trajectory
    sq, st = runs["tpipe"].trajectory
    np.testing.assert_array_equal(tt, st[:3])
    np.testing.assert_array_equal(q, sq[:3])


def test_entry_points_and_options(runs, monkeypatch):
    tcfg = runs["tcfg"]
    assert isinstance(make_pipeline(tcfg, device="cpu"), BPFPipeline)
    with pytest.raises(ValueError, match="mode='bpf'"):
        BPFPipeline(tcfg.replace(mode="es"), device="cpu")
    per_iter = tcfg.replace(odometry=dataclasses.replace(tcfg.odometry, assoc_once=False))
    pipe = BPFPipeline(per_iter, device="cpu")
    for i in range(2):
        pipe.process_frame(runs["xyz"][i], runs["valid"][i])
    q, tt = pipe.trajectory
    assert np.isfinite(q).all() and np.isfinite(tt).all() and pipe.records[1].n_corr.sum() > 0
    bad = tcfg.replace(capacity=dataclasses.replace(tcfg.capacity, knn_impl="kdtree"))
    with pytest.raises(ValueError, match="knn_impl"):
        BPFPipeline(bad, device="cpu").process_frame(runs["xyz"][0], runs["valid"][0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pipeline(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.bpf_state_from_jax_numpy(runs["carried"])


@pytest.mark.parametrize("option", ["per_iteration_fast_ground", "grid"])
def test_option_pipeline_matches_reference(runs, option):
    """``assoc_once=False`` with ``ground.method="fast"`` (the per-iteration
    loop behind the fast ground filter), and ``knn_impl="grid"``: four
    frames of both packages' BPF pipelines on the same scans, held to the
    slice's 1 cm / 2e-3 rad, counts to 5 % and overflow equal."""
    jcfg = runs["jcfg"]
    if option == "grid":
        jcfg = jcfg.replace(capacity=dataclasses.replace(jcfg.capacity, knn_impl="grid"))
    else:
        jcfg = jcfg.replace(
            odometry=dataclasses.replace(jcfg.odometry, assoc_once=False), ground=dataclasses.replace(jcfg.ground, method="fast")
        )
    jpipe, tpipe = JPipeline(cfg=jcfg), BPFPipeline(torch_config(jcfg), device="cpu")
    for i in range(N_FRAMES):
        jpipe.process_frame(runs["xyz"][i], runs["valid"][i])
        tpipe.process_frame(runs["xyz"][i], runs["valid"][i])
    jq, jt = jpipe.trajectory
    tq, tt = tpipe.trajectory
    assert np.linalg.norm(tt - jt, axis=1).max() < POS_TOL_M
    assert rotation_angle(tq, jq).max() < ROT_TOL_RAD
    assert metrics.ate_rmse(runs["gt"], metrics.poses_to_matrices(tq, tt)) < 0.2
    for jr, tr in zip(jpipe.records, tpipe.records):
        np.testing.assert_array_equal(tr.overflow, jr.overflow)
        for a, b in zip(tr.n_corr, jr.n_corr):
            assert abs(int(a) - int(b)) <= max(0.05 * b, 8)
    assert tpipe.overflow_total == jpipe.overflow_total == 0


def test_es_prefilters_match_reference(runs):
    """es_ground_filter / es_curved_filter: the ES pipeline's input mask is
    the reference's ground + DCVC composition, compiled as its pipeline runs
    it, and the pipeline runs on it."""
    jcfg = runs["jcfg"].replace(mode="es", es_ground_filter=True, es_curved_filter=True)
    tcfg = torch_config(jcfg)
    x, v = runs["xyz"][0], runs["valid"][0]

    def prefilter(a, b):
        keep = jground.segment_ground_dispatch(a, b, jcfg).nonground_mask
        return jdcvc.cluster(a, keep, jcfg.dcvc, jcfg.lidar).keep

    want = jax.jit(prefilter)(jnp.asarray(x), jnp.asarray(v))
    pipe = ESPipeline(tcfg, device="cpu")
    np.testing.assert_array_equal(n(pipe._prefilter(t(x), t(v))), np.asarray(want))
    for i in range(2):
        pipe.process_frame(runs["xyz"][i], runs["valid"][i])
    q, tt = pipe.trajectory
    assert np.isfinite(q).all() and np.isfinite(tt).all() and pipe.overflow_total == 0
    assert np.linalg.norm(tt[1] - runs["gt"][1, :3, 3]) < 0.2
    only_ground = ESPipeline(tcfg.replace(es_curved_filter=False), device="cpu")
    assert n(only_ground._prefilter(t(x), t(v))).sum() > n(pipe._prefilter(t(x), t(v))).sum()
