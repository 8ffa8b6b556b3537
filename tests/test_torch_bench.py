"""The port's run of the bench protocol (``pfilter_tpu_torch/bench.py``):
its protocol and JSON line against the reference's ``bench.py`` and
``BENCH_r05.json``, its scorer against the stored reference runs' sidecar,
the long-run parity check (``utils/parity.compare_long``), and the runner end
to end on the CPU at a small config (16 beams, 360 azimuth, 8192-point
scans, 4 outer iterations), where every frame is eager and the kNN is its
plain version."""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pfilter_tpu_torch import bench
from pfilter_tpu_torch.utils import parity, synthetic

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "tests" / "data" / "torch_reference_v1.npz"
SMALL = ["--device", "cpu", "--frames", "12", "--warmup", "10", "--azimuth", "360",
         "--set", "lidar.num_lines=16", "--set", "capacity.scan_points=8192", "--set", "odometry.max_outer_iters=4"]


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    lines = out.getvalue().splitlines()
    return rc, lines


@pytest.fixture(scope="module")
def small_run():
    return _run(SMALL)


@pytest.fixture(scope="module")
def stored():
    ref, side = parity.load_reference(REFERENCE)
    gt = bench.ground_truth(synthetic.make_loop_trajectory(bench.PROTOCOL["frames"], speed=bench.PROTOCOL["speed_m_per_frame"]))
    return ref, side, gt


def test_protocol_is_bench_py_protocol():
    """The port's PROTOCOL equals the root ``bench.py``'s, field for field
    (its module level imports no JAX)."""
    spec = importlib.util.spec_from_file_location("reference_bench", ROOT / "bench.py")
    ref_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_bench)
    assert bench.PROTOCOL == ref_bench.PROTOCOL


def test_small_run_prints_one_json_line(small_run):
    rc, lines = small_run
    assert rc == 0
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["failures"] == []
    assert r["protocol_deviation"] is True
    assert r["frames"] == r["frames_requested"] == 12 and r["bpf_frames"] == 12
    assert r["overflow_total"] == 0 and r["bpf_overflow_total"] == 0
    assert r["device"] == "cpu" and r["stopped_by_budget"] == {"es": False, "bpf": False}
    assert r["knn_launches"] == {"es": 0, "bpf": 0}  # the CPU runs the plain kNN
    none = {"knn_tiled": 0, "pca_radius": 0, "work_list": 0}
    assert r["kernel_launches"] == {"es": none, "bpf": none}
    assert np.isfinite(r["ate_rmse_m"]) and np.isfinite(r["bpf_ate_rmse_m"])


def test_json_keys_cover_bench_r05(small_run):
    parsed = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
    r = json.loads(small_run[1][0])
    assert set(parsed) <= set(r), sorted(set(parsed) - set(r))
    assert r["bench_protocol"] == parsed["bench_protocol"]


def test_budget_stops_the_steady_loop_and_says_so():
    rc, lines = _run(SMALL + ["--budget-s", "0.001"])
    assert rc == 0 and len(lines) == 1
    r = json.loads(lines[0])
    assert r["stopped_by_budget"]["es"] is True
    assert r["frames"] == 11 < r["frames_requested"]  # the first steady frame, then the stop
    assert r["protocol_deviation"] is True
    assert r["bpf_skipped"].startswith("budget")


def test_default_device_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--frames", "12"])


@pytest.mark.parametrize("path,protocol,want", [("es", "v1", 0.30998), ("es", "full", 0.52858), ("bpf", "v1", 0.3439)])
def test_scorer_gives_the_sidecars_drift(stored, path, protocol, want):
    ref, side, gt = stored
    s = bench.score_protocol(gt, ref[path]["q"], ref[path]["t"])
    stored_drift = side["paths"][path]["scores"][protocol]["drift_t_pct"]
    assert abs(s[protocol]["t_err_pct"] - stored_drift) <= 1e-6
    assert round(s[protocol]["t_err_pct"], len(str(want).split(".")[1])) == want


@pytest.mark.parametrize("path", ["es", "bpf"])
def test_long_run_check_passes_the_stored_run_itself(stored, path):
    ref, side, gt = stored
    res = bench.hold_to_reference(ref[path], ref[path], side["paths"][path]["scores"], gt)
    assert res["failures"] == []
    assert res["frames"] == len(ref[path]["t"]) and res["max_gap_t_m"] == 0.0
    assert set(res["drift"]) == {"v1", "full"}
    assert set(res["gap_at"]) == {f for f in parity.LONG_REPORT_FRAMES if f <= res["frames"]}


def test_long_run_gates_are_the_stated_ones():
    """Every frame within 0.30 m / 5e-3 rad, map sizes within 5 %, drift
    within 0.02 points at v1 and 0.04 at full."""
    assert (parity.LONG_TOL_M, parity.LONG_TOL_RAD, parity.LONG_MAP_SIZE_TOL) == (0.30, 5e-3, 0.05)
    assert parity.LONG_DRIFT_TOL_POINTS == {"v1": 0.02, "full": 0.04}


@pytest.mark.parametrize("fault", ["shift", "overflow"])
def test_long_run_check_catches_a_late_fault(stored, fault):
    """Frames 400 on shifted by 0.31 m, or one overflow lane changed on
    frame 500: frames 0-99 still hold, the long run does not."""
    ref, side, gt = stored
    run = {k: np.array(v) for k, v in ref["es"].items()}
    if fault == "shift":
        run["t"][400:, 0] += 0.31
    else:
        run["overflow"][500, 3] += 1
    res = bench.hold_to_reference(run, ref["es"], side["paths"]["es"]["scores"], gt)
    assert res["head"]["failures"] == []
    if fault == "shift":
        assert res["max_gap_t_m"] == pytest.approx(0.31, abs=1e-4)  # float32 positions
        assert res["max_gap_t_frame"] >= 400 and res["gap_t_m"][399] == 0.0
        assert set(res["missed"]) == {"pose"} and f"over {parity.LONG_TOL_M} m" in res["missed"]["pose"]
    else:
        assert res["overflow_frames_differing"] == [500]
        assert set(res["missed"]) == {"overflow"}
    assert res["failures"] == list(res["missed"].values())


def test_long_run_check_holds_the_v1_window(stored):
    """Frames 150 on shifted by 0.31 m: inside the v1 window (frames
    0-299) the pose gate sees it."""
    ref, side, gt = stored
    run = {k: np.array(v) for k, v in ref["es"].items()}
    run["t"][150:, 1] -= 0.31
    res = bench.hold_to_reference(run, ref["es"], side["paths"]["es"]["scores"], gt)
    assert res["max_gap_t_m"] == pytest.approx(0.31, abs=1e-4) and res["max_gap_t_frame"] >= 150
    assert "pose" in res["missed"] and res["gap_t_m"][149] == 0.0


@pytest.mark.parametrize("path,factor,missed", [("es", 1.06, True), ("es", 1.04, False), ("bpf", 1.06, True), ("bpf", 0.96, False)])
def test_long_run_check_holds_map_sizes(stored, path, factor, missed):
    """Every map's size scaled from frame 200 on: more than 5 % off is a
    miss."""
    ref, side, gt = stored
    run = {k: np.array(v) for k, v in ref[path].items()}
    run["map_sizes"][200:] = np.round(run["map_sizes"][200:] * factor)
    res = parity.compare_long(run, ref[path], {}, {})
    assert ("map_size" in res["missed"]) is missed
    assert set(res["missed"]) <= {"map_size"}


@pytest.mark.parametrize("protocol,gap,missed", [("full", 0.05, True), ("full", 0.03, False), ("v1", 0.03, True), ("v1", 0.01, False)])
def test_long_run_check_holds_the_drift(stored, protocol, gap, missed):
    ref, side, gt = stored
    r = side["paths"]["es"]["scores"][protocol]["drift_t_pct"]
    res = parity.compare_long(ref["es"], ref["es"], {protocol: r + gap}, {protocol: r})
    assert res["drift_gap_points"][protocol] == pytest.approx(gap)
    assert set(res["missed"]) == ({f"drift_{protocol}"} if missed else set())


def _ab_tool():
    """``tools/torch_knn_packed_keys_ab.py``, imported by path."""
    spec = importlib.util.spec_from_file_location("torch_knn_packed_keys_ab", ROOT / "tools" / "torch_knn_packed_keys_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["nudge_x+", "nudge_x-", "nudge_y+", "nudge_y-", "nudge_z+", "nudge_z-"])
def test_ab_tool_nudge_moves_one_coordinate_one_ulp(variant):
    from pfilter_tpu_torch.config import kitti_config
    from pfilter_tpu_torch.models.es_odometry import init_state

    ab = _ab_tool()
    assert variant in ab.NUDGES
    st = init_state(kitti_config(), device=torch.device("cpu"))
    st = st._replace(pose=st.pose._replace(t=torch.tensor([7.5, -3.25, 0.125])))
    out = ab.nudge_pose(st, variant).pose.t
    axis = "xyz".index(variant[-2])
    changed = (out != st.pose.t).nonzero().flatten().tolist()
    assert changed == [axis]
    up = torch.nextafter(st.pose.t[axis], torch.tensor(float("inf")))
    down = torch.nextafter(st.pose.t[axis], torch.tensor(float("-inf")))
    assert out[axis] == (up if variant.endswith("+") else down)
    assert torch.equal(st.pose.q, ab.nudge_pose(st, variant).pose.q)


def test_ab_tool_spread_leaves_the_reference_out(stored):
    """The port's spread is taken over its own runs only; the reference
    stands inside it when its gaps to the kernel run are no larger."""
    ref, side, gt = stored
    ab = _ab_tool()
    base = {k: np.array(v) for k, v in ref["es"].items()}
    far = {k: np.array(v) for k, v in ref["es"].items()}
    far["t"][400:, 0] += 0.5
    near = {k: np.array(v) for k, v in ref["es"].items()}
    near["t"][400:, 0] += 0.2
    sp = ab.spread({"kernel": base, "nudge_x+": far}, near, gt, side["paths"]["es"]["scores"])
    assert sp["members"] == ["kernel", "nudge_x+"] and list(sp["pairs"]) == ["kernel | nudge_x+"]
    assert sp["largest"]["gap_m"] == pytest.approx(0.5, abs=1e-4)
    assert sp["to_reference"]["kernel"]["gap_m"] == pytest.approx(0.2, abs=1e-4)
    assert sp["inside"]["gap_m"] is True
    sp = ab.spread({"kernel": base, "nudge_x+": near}, far, gt, side["paths"]["es"]["scores"])
    assert sp["inside"]["gap_m"] is False
