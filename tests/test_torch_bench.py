"""The port's run of the bench protocol (``pfilter_tpu_torch/bench.py``):
its protocol and JSON line against the reference's ``bench.py`` and
``BENCH_r05.json``, its scorer against the stored reference runs' sidecar,
the long-run parity check (``utils/parity.compare_long``), and the runner end
to end on the CPU at a small config (16 beams, 360 azimuth, 8192-point
scans, 4 outer iterations), where every frame is eager and the kNN is its
plain version."""

import argparse
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
    res = bench.hold_to_reference(ref[path], ref[path], side["paths"][path]["scores"], gt, path)
    assert res["failures"] == []
    assert res["frames"] == len(ref[path]["t"]) and res["max_gap_t_m"] == 0.0
    assert set(res["drift"]) == {"v1", "full"}
    assert set(res["gap_at"]) == {f for f in parity.LONG_REPORT_FRAMES if f <= res["frames"]}
    assert res["map_mean_gap"] == [0.0] * (2 if path == "es" else 3)


def test_long_run_gates_are_the_stated_ones():
    """The free run's gates: frames 0-99 as ``compare``; finite poses and
    equal overflow lanes on every frame; the drift and each map's mean size
    over frames 100 on within 3 sqrt(2) s of the port's own spread; no
    per-frame pose or map-size gate past frame 99 (the windows hold those)."""
    assert parity.SCORE_AT == 100 and parity.BAND_SIGMAS == 3.0
    assert not any(hasattr(parity, k) for k in ("LONG_TOL_M", "LONG_TOL_RAD", "LONG_MAP_SIZE_TOL", "LONG_DRIFT_TOL_POINTS"))
    assert {p: set(b) for p, b in parity.LONG_DRIFT_BAND.items()} == {"es": {"v1", "full"}, "bpf": {"v1", "full"}}
    assert [len(parity.LONG_MAP_MEAN_BAND[p]) for p in ("es", "bpf")] == [2, 3]
    assert all(b > 0 for p in ("es", "bpf") for b in list(parity.LONG_DRIFT_BAND[p].values()) + list(parity.LONG_MAP_MEAN_BAND[p]))
    assert parity.band([1.0, 2.0, 3.0]) == pytest.approx(3.0 * np.sqrt(2.0))


@pytest.mark.parametrize("fault", ["shift", "overflow", "nonfinite"])
def test_long_run_check_catches_a_late_fault(stored, fault):
    """Frames 400 on with every map's size moved so that its mean over
    frames 100 on leaves its band, one overflow lane changed on frame 500,
    or a non-finite pose on frame 600: frames 0-99 still hold, the long run
    does not."""
    ref, side, gt = stored
    run = {k: np.array(v, np.float64 if k == "map_sizes" else None) for k, v in ref["es"].items()}
    k = len(run["t"])
    if fault == "shift":
        run["map_sizes"][400:] += np.array(parity.LONG_MAP_MEAN_BAND["es"]) * 1.01 * (k - parity.SCORE_AT) / (k - 400)
    elif fault == "overflow":
        run["overflow"][500, 3] += 1
    else:
        run["t"][600, 2] = np.nan
    res = parity.compare_long(run, ref["es"], {}, {}, "es")
    assert res["head"]["failures"] == []
    want = {"shift": {"map_mean"}, "overflow": {"overflow"}, "nonfinite": {"finite"}}[fault]
    assert set(res["missed"]) == want
    if fault == "overflow":
        assert res["overflow_frames_differing"] == [500]
    assert res["failures"] == list(res["missed"].values())


def test_long_run_check_holds_the_head(stored):
    """Frames 50 on shifted by 6 cm: frames 0-99 are held frame by frame
    with ``compare``'s gates (5 cm), so the head misses and nothing else."""
    ref, side, gt = stored
    run = {k: np.array(v) for k, v in ref["es"].items()}
    run["t"][50:, 1] -= 0.06
    res = parity.compare_long(run, ref["es"], {}, {}, "es")
    assert set(res["missed"]) == {"head"} and "over 0.05 m" in res["missed"]["head"]
    assert res["head"]["max_gap_t_frame"] >= 50 and res["gap_t_m"][49] == 0.0


def test_long_run_check_passes_a_late_pose_shift(stored):
    """The decision this gate set states: past frame 99 the free run holds
    no per-frame pose gate (two of the port's own runs one float32 ulp apart
    part by metres past the loop's corners; the windows hold poses at
    depth).  Frames 400 on shifted by 5 m, drift and map sizes as the
    reference's: every gate holds."""
    ref, side, gt = stored
    run = {k: np.array(v) for k, v in ref["es"].items()}
    run["t"][400:, 0] += 5.0
    drift = {p: side["paths"]["es"]["scores"][p]["drift_t_pct"] for p in ("v1", "full")}
    res = parity.compare_long(run, ref["es"], drift, drift, "es")
    assert res["failures"] == []
    assert res["max_gap_t_m"] == pytest.approx(5.0, abs=1e-3) and res["max_gap_t_frame"] >= 400


@pytest.mark.parametrize("path,factor,missed", [("es", 1.01, True), ("es", 0.99, False), ("bpf", -1.01, True), ("bpf", -0.99, False)])
def test_long_run_check_holds_map_sizes(stored, path, factor, missed):
    """Every map's size moved from frame 100 on by ``factor`` times its
    band: its mean over frames 100 on leaves the band past 1, not below."""
    ref, side, gt = stored
    run = {k: np.array(v, np.float64 if k == "map_sizes" else None) for k, v in ref[path].items()}
    run["map_sizes"][parity.SCORE_AT:] += factor * np.array(parity.LONG_MAP_MEAN_BAND[path])
    res = parity.compare_long(run, ref[path], {}, {}, path)
    assert ("map_mean" in res["missed"]) is missed
    assert set(res["missed"]) <= {"map_mean"}
    assert res["map_mean_gap"] == pytest.approx(abs(factor) * np.array(parity.LONG_MAP_MEAN_BAND[path]))


@pytest.mark.parametrize("protocol,factor,missed", [("full", 1.01, True), ("full", 0.99, False), ("v1", 1.01, True), ("v1", 0.99, False)])
def test_long_run_check_holds_the_drift(stored, protocol, factor, missed):
    ref, side, gt = stored
    r = side["paths"]["es"]["scores"][protocol]["drift_t_pct"]
    gap = factor * parity.LONG_DRIFT_BAND["es"][protocol]
    res = parity.compare_long(ref["es"], ref["es"], {protocol: r + gap}, {protocol: r}, "es")
    assert res["drift_gap_points"][protocol] == pytest.approx(gap)
    assert set(res["missed"]) == ({f"drift_{protocol}"} if missed else set())


def _ab_tool():
    """``tools/torch_knn_packed_keys_ab.py``, imported by path."""
    spec = importlib.util.spec_from_file_location("torch_knn_packed_keys_ab", ROOT / "tools" / "torch_knn_packed_keys_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ab_tool_ensemble_counts_a_repeated_run_once(monkeypatch):
    """The ensemble's runs are distinct: a run equal bit for bit to an
    earlier one is dropped (named with the run it repeats), and the
    reserve's nudges (after frame 7) are run in order until ENSEMBLE_RUNS
    distinct runs stand."""
    ab = _ab_tool()
    assert len(ab.ENSEMBLE) == ab.ENSEMBLE_RUNS == 25 and len(ab.RESERVE) == 12
    assert ab.nudge_of("nudge_qx-@7") == ("nudge_qx-", ab.RESERVE_NUDGE_FRAME) and ab.nudge_of("kernel") == (None, None)
    repeats = {"nudge_qx-": "kernel", "nudge_qy-": "kernel", "nudge_qx-@8": "nudge_qx+@8", "nudge_x-@7": "kernel"}
    calls = []

    def run_set(variants, jobs, common):
        calls.append(list(variants))
        return {v: {"t": np.full((3, 3), float(ab.VARIANTS.index(repeats.get(v, v)))), "seconds": np.float64(1.0)} for v in variants}

    monkeypatch.setattr(ab, "run_set", run_set)
    runs, dropped = ab.ensemble(argparse.Namespace(mode="es", jobs=3), [])
    assert calls == [list(ab.ENSEMBLE), ["nudge_x+@7", "nudge_x-@7", "nudge_y+@7"], ["nudge_y-@7"]]
    assert dropped == repeats and len(runs) == ab.ENSEMBLE_RUNS
    assert list(runs)[-2:] == ["nudge_y+@7", "nudge_y-@7"] and not set(runs) & set(repeats)
