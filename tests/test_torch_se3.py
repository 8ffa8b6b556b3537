"""Parity of the port's geometry and solver modules with the reference
package on the same numpy inputs: ops/se3.py, ops/eig3.py,
ops/gauss_newton.py, ops/pose_graph.py, ops/voxel.py, utils/metrics.py and
config.py (``matrix_to_quat``, ``rpe`` and the point-set helpers included).

Tolerances: fp32 elementwise math in the same order agrees to a few ulps
(atol 1e-5 on unit-scale values); reductions whose order differs between the
two libraries (matmul, einsum, segment sums) get a relative 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfilter_tpu import config as jconfig
from pfilter_tpu.ops import eig3 as jeig3
from pfilter_tpu.ops import gauss_newton as jgn
from pfilter_tpu.ops import pose_graph as jpg
from pfilter_tpu.ops import se3 as jse3
from pfilter_tpu.ops import voxel as jvoxel
from pfilter_tpu.utils import metrics as jmetrics
from pfilter_tpu_torch import config as tconfig
from pfilter_tpu_torch.ops import eig3 as teig3
from pfilter_tpu_torch.ops import gauss_newton as tgn
from pfilter_tpu_torch.ops import pose_graph as tpg
from pfilter_tpu_torch.ops import se3 as tse3
from pfilter_tpu_torch.ops import voxel as tvoxel
from pfilter_tpu_torch.utils import metrics as tmetrics
from torch_parity import n, t, torch_config

ATOL = 1e-5


def _quats(rng, m):
    q = rng.normal(size=(m, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def _xi(rng, m, scale=0.5):
    xi = (rng.normal(size=(m, 6)) * scale).astype(np.float32)
    xi[:3] *= 1e-4  # exercise the small-angle Taylor branch too
    xi[-1, :3] = 0.0
    return xi


@pytest.mark.parametrize("fn", ["quat_mul", "quat_rotate", "quat_to_matrix", "skew", "exp_se3", "log_se3"])
def test_se3_functions_match(fn):
    rng = np.random.default_rng(0)
    a, b = _quats(rng, 64), _quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32) * 10
    xi = _xi(rng, 64)
    if fn == "quat_mul":
        ref, out = jse3.quat_mul(jnp.array(a), jnp.array(b)), tse3.quat_mul(t(a), t(b))
    elif fn == "quat_rotate":
        ref, out = jse3.quat_rotate(jnp.array(a), jnp.array(v)), tse3.quat_rotate(t(a), t(v))
    elif fn == "quat_to_matrix":
        ref, out = jse3.quat_to_matrix(jnp.array(a)), tse3.quat_to_matrix(t(a))
    elif fn == "skew":
        ref, out = jse3.skew(jnp.array(v)), tse3.skew(t(v))
    elif fn == "exp_se3":
        jp, tp = jse3.exp_se3(jnp.array(xi)), tse3.exp_se3(t(xi))
        ref, out = np.concatenate([n(jp.q), n(jp.t)], 1), torch.cat([tp.q, tp.t], 1)
    else:
        pose = jse3.exp_se3(jnp.array(xi))
        ref = jse3.log_se3(pose)
        out = tse3.log_se3(tse3.Pose(q=t(pose.q), t=t(pose.t)))
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL * 10, rtol=1e-5)


def test_pose_ops_match():
    rng = np.random.default_rng(1)
    qa, qb = _quats(rng, 1)[0], _quats(rng, 1)[0]
    ta, tb = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    pts = rng.normal(size=(100, 3)).astype(np.float32) * 20
    xi = _xi(rng, 8, 0.1)[-2]
    ja, jb = jse3.Pose(jnp.array(qa), jnp.array(ta)), jse3.Pose(jnp.array(qb), jnp.array(tb))
    pa, pb = tse3.Pose(t(qa), t(ta)), tse3.Pose(t(qb), t(tb))
    for ref, out in (
        (jse3.constant_velocity_predict(ja, jb), tse3.constant_velocity_predict(pa, pb)),
        (jse3.pose_update_left(jnp.array(xi), ja), tse3.pose_update_left(t(xi), pa)),
        (jse3.pose_inverse(ja), tse3.pose_inverse(pa)),
    ):
        np.testing.assert_allclose(n(out.q), n(ref.q), atol=ATOL)
        np.testing.assert_allclose(n(out.t), n(ref.t), atol=ATOL * 10)
    np.testing.assert_allclose(
        n(tse3.transform_points(pa, t(pts))), n(jse3.transform_points(ja, jnp.array(pts))), atol=1e-4
    )


@pytest.mark.parametrize("maker", ["cov", "degenerate", "line", "sym"])
def test_eig3_matches_closed_form(maker):
    rng = np.random.default_rng(2)
    if maker == "cov":
        x = rng.normal(size=(256, 5, 3)).astype(np.float32)
        a = np.einsum("mki,mkj->mij", x - x.mean(1, keepdims=True), x - x.mean(1, keepdims=True))
    elif maker == "degenerate":
        a = np.zeros((8, 3, 3), np.float32)
        a[1] = np.eye(3)
        a[2] = np.diag([1.0, 1.0, 2.0])
    elif maker == "line":
        d = rng.normal(size=(64, 3))
        a = (np.einsum("mi,mj->mij", d, d) + 1e-6 * np.eye(3)).astype(np.float32)
    else:
        m = rng.normal(size=(128, 3, 3)).astype(np.float32)
        a = (m + m.transpose(0, 2, 1)) / 2
    a = a.astype(np.float32)
    w_ref, vs_ref = jeig3.eigh3_smallest(jnp.array(a))
    w_out, vs_out = teig3.eigh3_smallest(t(a))
    # The trigonometric form's eigenvalues carry an absolute error of order
    # eps * |A| amplified by acos near +-1 (near-rank-1 inputs); the two
    # libraries' cos/acos differ in the last bits, hence 1e-4 * |A|.
    scale = max(1.0, float(np.abs(a).max()))
    np.testing.assert_allclose(n(w_out), n(w_ref), atol=1e-4 * scale, rtol=1e-5)
    # Eigenvectors up to sign; a line's two small eigenvalues are equal, so
    # its smallest eigenvector is any vector of a plane and is not compared.
    if maker != "line":
        sign = np.sign(np.sum(n(vs_out) * n(vs_ref), -1, keepdims=True))
        sign[sign == 0] = 1
        np.testing.assert_allclose(n(vs_out) * sign, n(vs_ref), atol=2e-3)
    _, vl_ref = jeig3.eigh3_largest(jnp.array(a))
    _, vl_out = teig3.eigh3_largest(t(a))
    sign = np.sign(np.sum(n(vl_out) * n(vl_ref), -1, keepdims=True))
    sign[sign == 0] = 1
    np.testing.assert_allclose(n(vl_out) * sign, n(vl_ref), atol=2e-3)
    assert np.isfinite(n(teig3.eigh3(t(a))[1])).all()


def _factors(rng, m):
    pts = rng.normal(size=(m, 3)).astype(np.float32) * 10
    pa = pts + rng.normal(size=(m, 3)).astype(np.float32) * 0.3
    pb = pa + rng.normal(size=(m, 3)).astype(np.float32)
    normal = rng.normal(size=(m, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    d = (-np.sum(normal * pts, 1) + rng.normal(size=m) * 0.2).astype(np.float32)
    w = rng.uniform(0.5, 1.5, m).astype(np.float32)
    valid = rng.uniform(size=m) > 0.2
    return pts, pa, pb, normal, d, w, valid


def test_gauss_newton_iteration_matches():
    rng = np.random.default_rng(3)
    pts, pa, pb, normal, d, w, valid = _factors(rng, 500)
    q, tt = _quats(rng, 1)[0] * 0 + np.array([1, 0, 0, 0], np.float32), np.array([0.1, -0.2, 0.05], np.float32)
    geom_b = np.stack([d, np.zeros_like(d), np.zeros_like(d)], -1)
    jf = [
        jgn.Correspondences("edge", *(jnp.array(x) for x in (pts, pa, pb, w, valid))),
        jgn.Correspondences("surf", *(jnp.array(x) for x in (pts, normal, geom_b, w, valid))),
    ]
    tf = [
        tgn.Correspondences("edge", *(t(x) for x in (pts, pa, pb, w, valid))),
        tgn.Correspondences("surf", *(t(x) for x in (pts, normal, geom_b, w, valid))),
    ]
    jp, (jh, jb) = jgn.gn_iteration(jse3.Pose(jnp.array(q), jnp.array(tt)), jf, 0.1, 1e-6)
    tp, (th, tb) = tgn.gn_iteration(tse3.Pose(t(q), t(tt)), tf, 0.1, 1e-6)
    np.testing.assert_allclose(n(th), n(jh), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(n(tb), n(jb), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(n(tp.q), n(jp.q), atol=1e-5)
    np.testing.assert_allclose(n(tp.t), n(jp.t), atol=1e-4)


def test_solve_step_nan_on_indefinite_system():
    h = -torch.eye(6)
    assert torch.isnan(tgn.solve_step(h, torch.ones(6), 1e-6)).all()
    jref = jgn.solve_step(-jnp.eye(6), jnp.ones(6), 1e-6)
    assert np.isnan(n(jref)).all()


@pytest.mark.parametrize("fit", ["lines", "planes"])
def test_line_plane_fits_match(fit):
    rng = np.random.default_rng(4)
    m = 400
    c = rng.normal(size=(m, 1, 3)).astype(np.float32) * 5
    if fit == "lines":
        d = rng.normal(size=(m, 1, 3)).astype(np.float32)
        s = rng.normal(size=(m, 5, 1)).astype(np.float32)
        nb = c + s * d + rng.normal(size=(m, 5, 3)).astype(np.float32) * rng.uniform(0.01, 0.5, (m, 1, 1)).astype(np.float32)
        ja, jb, jok = jgn.fit_lines(jnp.array(nb), 3.0, 0.1)
        ta, tb, tok = tgn.fit_lines(t(nb), 3.0, 0.1)
        np.testing.assert_array_equal(n(tok), n(jok))
        # endpoints up to the direction's sign: compare the segment midpoint and length
        np.testing.assert_allclose(n((ta + tb) / 2), n((ja + jb) / 2), atol=1e-4)
        np.testing.assert_allclose(
            np.linalg.norm(n(ta - tb), axis=1), np.linalg.norm(n(ja - jb), axis=1), atol=1e-4
        )
    else:
        nb = c + rng.normal(size=(m, 5, 3)).astype(np.float32) * np.array([1, 1, 0.02], np.float32)
        jn, jd, jok = jgn.fit_planes(jnp.array(nb), 0.2)
        tn, td, tok = tgn.fit_planes(t(nb), 0.2)
        np.testing.assert_array_equal(n(tok), n(jok))
        sign = np.sign(np.sum(n(tn) * n(jn), 1))
        np.testing.assert_allclose(n(tn) * sign[:, None], n(jn), atol=1e-3)
        np.testing.assert_allclose(n(td) * sign, n(jd), atol=1e-3)


@pytest.mark.parametrize("floor", [0.0, 0.1])
def test_weight_normalizer_matches(floor):
    rng = np.random.default_rng(5)
    v = rng.uniform(0, 50, 300).astype(np.float32)
    valid = rng.uniform(size=300) > 0.3
    ref = jgn.minmax_normalize_weights(jnp.array(v), jnp.array(valid), floor)
    out = tgn.minmax_normalize_weights(t(v), t(valid), floor)
    np.testing.assert_allclose(n(out), n(ref), atol=1e-6)
    none = tgn.minmax_normalize_weights(t(v), torch.zeros(300, dtype=torch.bool), floor)
    assert torch.all(none == 1.0)


def _window(rng, k=8):
    q = (rng.normal(size=(k, 4)) * 0.05).astype(np.float32)
    q[:, 0] = 1
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tt = np.cumsum(rng.normal(size=(k, 3)) * 0.05 + [1.5, 0.0, 0.0], 0).astype(np.float32)
    a = rng.normal(size=(k, 6, 6)).astype(np.float32)
    h = np.einsum("kij,klj->kil", a, a) * 100
    valid = np.ones(k, bool)
    valid[:2] = False
    return q, tt, h.astype(np.float32), valid


def test_pose_graph_smoothing_matches():
    rng = np.random.default_rng(6)
    q, tt, h, valid = _window(rng)
    jq, jt = jpg.smooth_window(jnp.array(q), jnp.array(tt), jnp.array(h), jnp.array(valid))
    tq, tt_ = tpg.smooth_window(t(q), t(tt), t(h), t(valid))
    np.testing.assert_allclose(n(tq), n(jq), atol=1e-5)
    np.testing.assert_allclose(n(tt_), n(jt), atol=1e-4)
    assert np.isfinite(n(jt)).all()
    assert np.abs(n(jt) - tt).max() > 1e-3  # the smoother actually moved the window


def test_pose_graph_newest_and_push_match():
    rng = np.random.default_rng(7)
    q, tt, h, valid = _window(rng)
    pgc = jconfig.PoseGraphConfig()
    raw = (q[-1], tt[-1])
    jn = jpg.smoothed_newest(jnp.array(q), jnp.array(tt), jnp.array(h), jnp.array(valid), jse3.Pose(*map(jnp.array, raw)), pgc)
    tn = tpg.smoothed_newest(t(q), t(tt), t(h), t(valid), tse3.Pose(*map(t, raw)), torch_config(pgc))
    np.testing.assert_allclose(n(tn.q), n(jn.q), atol=1e-5)
    np.testing.assert_allclose(n(tn.t), n(jn.t), atol=1e-4)
    new = (q[0], tt[0] + 1, h[0])
    jw = jpg.push_window(*(jnp.array(x) for x in (q, tt, h, valid)), *(jnp.array(x) for x in new))
    tw = tpg.push_window(*(t(x) for x in (q, tt, h, valid)), *(t(x) for x in new))
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(n(b), n(a))


@pytest.mark.parametrize("leaf,n_pts", [(0.4, 3000), (0.8, 6000), (0.4, 50)])
def test_voxel_downsample_matches(leaf, n_pts):
    rng = np.random.default_rng(8)
    cap = 8192
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n_pts] = rng.uniform(-20, 20, (n_pts, 3))
    rg = rng.integers(0, 50, (cap, 2)).astype(np.float32)
    valid = np.zeros(cap, bool)
    valid[:n_pts] = rng.uniform(size=n_pts) > 0.1
    out_cap = 2048
    jds, jdrop = jvoxel.voxel_downsample_rgbds_counted(jvoxel.PointSet(*(jnp.array(x) for x in (xyz, rg, valid))), leaf, out_cap)
    tds, tdrop = tvoxel.voxel_downsample_rgbds_counted(tvoxel.PointSet(t(xyz), t(rg), t(valid)), leaf, out_cap)
    assert int(n(tdrop)) == int(n(jdrop))
    np.testing.assert_array_equal(n(tds.valid), n(jds.valid))
    np.testing.assert_allclose(n(tds.xyz), n(jds.xyz), atol=1e-5)
    np.testing.assert_array_equal(n(tds.rg), n(jds.rg))
    keep_ref = jvoxel.persistence_keep(jnp.array(rg), 0.0, 0.4, 75.0)
    np.testing.assert_array_equal(n(tvoxel.persistence_keep(t(rg), 0.0, 0.4, 75.0)), n(keep_ref))


def test_metrics_match():
    rng = np.random.default_rng(9)
    m = 120
    q = _quats(rng, m) * np.array([1, 0.01, 0.01, 0.3], np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tt = np.cumsum(rng.normal(size=(m, 3)) + [1.5, 0, 0], 0).astype(np.float32)
    gt = jmetrics.poses_to_matrices(q, tt)
    est = jmetrics.poses_to_matrices(q, tt + rng.normal(size=(m, 3)).astype(np.float32) * 0.3)
    np.testing.assert_array_equal(tmetrics.poses_to_matrices(q, tt), gt)
    np.testing.assert_array_equal(tmetrics.trajectory_distances(gt), jmetrics.trajectory_distances(gt))
    assert tmetrics.kitti_drift(gt, est, lengths=(50.0, 100.0)) == jmetrics.kitti_drift(gt, est, lengths=(50.0, 100.0))
    assert tmetrics.ate_rmse(gt, est) == jmetrics.ate_rmse(gt, est)


@pytest.mark.parametrize("delta", [1, 5])
def test_rpe_matches(delta):
    rng = np.random.default_rng(10)
    m = 60
    q = _quats(rng, m)
    tt = np.cumsum(rng.normal(size=(m, 3)), 0).astype(np.float32)
    gt = jmetrics.poses_to_matrices(q, tt)
    est = jmetrics.poses_to_matrices(_quats(rng, m), tt + rng.normal(size=(m, 3)).astype(np.float32) * 0.2)
    assert tmetrics.rpe(gt, est, delta) == jmetrics.rpe(gt, est, delta)


def test_matrix_to_quat_matches():
    """Every Shepperd pivot: random rotations plus half turns about x, y, z
    (the w pivot vanishes there) and the identity."""
    rng = np.random.default_rng(11)
    half_turns = np.array([[0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0.01, 0.99995, 0, 0]], np.float32)
    q = np.concatenate([_quats(rng, 64), half_turns / np.linalg.norm(half_turns, axis=1, keepdims=True)])
    m = n(jse3.quat_to_matrix(jnp.array(q)))
    ref = n(jse3.matrix_to_quat(jnp.array(m)))
    out = n(tse3.matrix_to_quat(t(m)))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # The same rotation as the input (up to the quaternion's sign).
    np.testing.assert_allclose(n(tse3.quat_to_matrix(t(out))), m, atol=ATOL)
    assert (out[:, 0] >= 0).all()
    piv = np.stack([1 + np.trace(m, axis1=1, axis2=2), 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                    1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2], 1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], -1)
    assert set(np.argmax(piv, -1)) == {0, 1, 2, 3}


def test_pointset_helpers_match():
    rng = np.random.default_rng(12)
    a = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(5, 2)).astype(np.float32), rng.uniform(size=5) > 0.5]
    b = [rng.normal(size=(3, 3)).astype(np.float32), rng.normal(size=(3, 2)).astype(np.float32), rng.uniform(size=3) > 0.5]
    ref = jvoxel.concat_pointsets(jvoxel.PointSet(*map(jnp.array, a)), jvoxel.PointSet(*map(jnp.array, b)))
    out = tvoxel.concat_pointsets(tvoxel.PointSet(*map(t, a)), tvoxel.PointSet(*map(t, b)))
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(n(x), n(y))
    for x, y in zip(tvoxel.empty_pointset(7, device="cpu"), jvoxel.empty_pointset(7)):
        assert x.dtype == t(n(y)).dtype
        np.testing.assert_array_equal(n(x), n(y))


@pytest.mark.parametrize("preset", ["kitti_config", "campus_32beam_config", "floam_equivalent_config", "PipelineConfig"])
def test_config_copy_matches(preset):
    ref = getattr(jconfig, preset)()
    out = getattr(tconfig, preset)()
    assert torch_config(ref) == out
    pairs = ["odometry.theta_p=0.5", "capacity.knn_tiles=32", "mode=bpf", "odometry.assoc_once=false"]
    assert torch_config(jconfig.apply_dotted_overrides(ref, pairs)) == tconfig.apply_dotted_overrides(out, pairs)
