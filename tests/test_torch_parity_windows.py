"""The bench protocol's long-run parity (``pfilter_tpu_torch/utils/parity.py``):
the free run's bands derived from the port's measured spread
(``tests/data/torch_port_spread_v1.json``), the reference's stored states at
depth (``tests/data/torch_reference_states_v1``) restoring in the port at
``kitti_config()``, the window length rule, the pose nudges, and
``compare_window`` on a reference state made by the reference on the CPU at
``tests/test_es_odometry.py::small_config`` widths and stored
(``tests/data/torch_reference_small_state_v1``, ``tools/
torch_reference_trajectories.py --small-state``): the port resumed from it
holds the window's gates (those of ``parity.compare``: frames 0-9 within
1 cm / 2e-3 rad), and the same state with its pose moved 10 cm misses the
cold-frame gate.  The pose is moved with its maps (a rigid shift of the
whole state): moved alone, scan-to-map registration pulls it back to within
2.5 mm in the first frame."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pfilter_tpu_torch.config import kitti_config
from pfilter_tpu_torch.models import bpf_odometry, es_odometry
from pfilter_tpu_torch.utils import checkpoint, parity
from tests.test_es_odometry import small_config
from torch_parity import torch_config

ROOT = Path(__file__).resolve().parent.parent
SPREAD = ROOT / "tests" / "data" / "torch_port_spread_v1.json"
STATES = ROOT / "tests" / "data" / "torch_reference_states_v1"
SMALL = ROOT / "tests" / "data" / "torch_reference_small_state_v1"
REFERENCE = ROOT / "tests" / "data" / "torch_reference_v1.npz"


@pytest.fixture(scope="module")
def spread():
    return json.loads(SPREAD.read_text())


@pytest.fixture(scope="module")
def reference():
    return parity.load_reference(REFERENCE)[0]


def _measures(path):
    return [f"drift_{p}" for p in ("v1", "full")] + [f"map_mean_{m}" for m in range(2 if path == "es" else 3)]


@pytest.mark.parametrize("path,measure", [(p, m) for p in ("es", "bpf") for m in _measures(p)])
def test_bands_are_derived_from_the_measured_spread(spread, path, measure):
    """Each band in ``parity.py`` is 3 sqrt(2) s of the port's ensemble on
    the card, s with n - 1, over at least 25 distinct runs (the kernel run
    and 24 nudged ones; the runs dropped as repeats named with the run they
    repeat), taken on the H100."""
    rec = spread["paths"][path]
    runs = rec["runs"]
    assert len(runs) >= 25 and "kernel" in runs
    assert len({json.dumps(r, sort_keys=True) for r in runs.values()}) == len(runs)
    assert all(v not in runs and u in runs for v, u in rec["dropped"].items())
    assert rec["device"].startswith("NVIDIA H100")
    kind, key = ("drift", measure[6:]) if measure.startswith("drift_") else ("map_mean", int(measure[-1]))
    values = [r[kind][key] for r in runs.values()]
    have = (parity.LONG_DRIFT_BAND if kind == "drift" else parity.LONG_MAP_MEAN_BAND)[path][key]
    want = 3.0 * np.sqrt(2.0) * np.std(np.asarray(values, np.float64), ddof=1)
    assert abs(have - want) <= 1e-12
    assert abs(parity.band(values) - want) <= 1e-12
    assert abs(parity.spread_bands(spread)[path][kind][key] - want) <= 1e-12
    assert abs(rec["bands"][kind][key] - want) <= 1e-12


@pytest.mark.parametrize("name", sorted(parity.WINDOW_LENGTHS))
def test_stored_state_restores_at_kitti_config(reference, name):
    """Every stored reference state restores into the port's state at
    ``kitti_config()`` with no leaf from the template, its step the frame
    after which it was saved plus one; the run that saved it equals the
    stored run, so its window is the stored run's next 50 frames."""
    side = json.loads((STATES / "states.json").read_text())
    win = side["windows"][name]
    cfg = kitti_config().replace(mode=win["path"])
    template = (es_odometry if win["path"] == "es" else bpf_odometry).init_state(cfg, device="cpu")
    state, meta = checkpoint.restore_state(STATES / name, template)
    assert meta["restored_from_template"] == []
    assert meta["step"] == win["step"] == meta["extra"]["frame"] + 1 == int(name.rsplit("_", 1)[1])
    assert torch.isfinite(state.pose.t).all() and state.opt_count == cfg.odometry.min_outer_iters
    assert side["paths"][win["path"]]["equal_to_stored"] and not (STATES / name / "window.npz").exists()
    ref = parity.load_window(STATES / name, reference)
    assert len(ref["t"]) == parity.WINDOW_FRAMES and np.isfinite(ref["t"]).all()
    assert np.array_equal(ref["q"], reference[win["path"]]["q"][win["step"] : win["step"] + parity.WINDOW_FRAMES])
    assert parity.COLD_FRAMES <= parity.WINDOW_LENGTHS[name] <= parity.WINDOW_FRAMES


@pytest.mark.parametrize("nudge", parity.NUDGES)
def test_nudge_moves_one_coordinate_one_ulp(nudge):
    st = es_odometry.init_state(kitti_config(), device="cpu")
    st = st._replace(pose=st.pose._replace(q=torch.tensor([0.96, 0.02, -0.01, 0.28]), t=torch.tensor([7.5, -3.25, 0.125])))
    out = parity.nudge_pose(st, nudge).pose
    rot = nudge[-3] == "q"
    i = "xyz".index(nudge[-2]) + (1 if rot else 0)
    moved, kept = (out.q, st.pose.q) if rot else (out.t, st.pose.t)
    assert (moved != kept).nonzero().flatten().tolist() == [i]
    assert moved[i] == torch.nextafter(kept[i], torch.tensor(float("inf") if nudge.endswith("+") else float("-inf")))
    assert torch.equal(out.t if rot else out.q, st.pose.t if rot else st.pose.q)


def test_window_length_is_where_the_nudged_runs_part():
    """W: the frames before the first on which a nudged run leaves half of
    any per-frame gate, and at least the cold frames."""
    n = parity.WINDOW_FRAMES
    base = {"q": np.tile([1.0, 0, 0, 0], (n, 1)), "t": np.zeros((n, 3)), "map_sizes": np.full((n, 2), 1000)}
    far = {k: v.copy() for k, v in base.items()}
    far["t"][30:, 0] = 0.026
    sizes = {k: v.copy() for k, v in base.items()}
    sizes["map_sizes"][20:, 1] = 1026
    assert parity.window_length(base, [base, base]) == (n, n)
    assert parity.window_length(base, [base, far]) == (30, 30)
    assert parity.window_length(base, [far, sizes]) == (20, 20)
    early = {k: v.copy() for k, v in base.items()}
    early["t"][4:, 1] = -0.03
    assert parity.window_length(base, [early]) == (parity.COLD_FRAMES, 4)


def _reference_tool():
    """``tools/torch_reference_trajectories.py``, imported by path (JAX is
    imported only inside its run functions)."""
    spec = importlib.util.spec_from_file_location("torch_reference_trajectories", ROOT / "tools" / "torch_reference_trajectories.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_state(tmp_path_factory):
    """The reference's stored ES state of the small run (``small.json``'s
    recipe), a copy with the pose, the pose-graph window and the maps moved
    10 cm along x, the port's config and the run's scans."""
    side = json.loads((SMALL / "small.json").read_text())
    recipe, name = side["recipe"], side["state"]
    cfg = torch_config(small_config())
    xyz, valid = _reference_tool().small_scans(cfg.lidar, recipe)
    moved = tmp_path_factory.mktemp("states") / f"{name}_moved"
    moved.mkdir()
    for f in ("meta.json", "window.npz"):
        (moved / f).write_bytes((SMALL / name / f).read_bytes())
    with np.load(SMALL / name / "state.npz") as z:
        leaves = {k: z[k] for k in z.files}
    shift = np.float32([0.1, 0.0, 0.0])
    for k in ("pose.t", "last_pose.t", "pg_t", "edge_map.origin", "surf_map.origin"):
        leaves[k] = leaves[k] + shift[: leaves[k].shape[-1]]
    for m in ("edge_map", "surf_map"):
        ok = leaves[f"{m}.valid"]
        leaves[f"{m}.xyz"] = np.where(ok[:, None], leaves[f"{m}.xyz"] + shift, leaves[f"{m}.xyz"])
        xyz_t = leaves[f"{m}.xyz_t"].copy()
        xyz_t[:3, : ok.shape[0]] = np.where(ok[None, :], xyz_t[:3, : ok.shape[0]] + shift[:, None], xyz_t[:3, : ok.shape[0]])
        leaves[f"{m}.xyz_t"] = xyz_t
    np.savez(moved / "state.npz", **leaves)
    return cfg, recipe, SMALL / name, moved, [(xyz[i], valid[i]) for i in range(recipe["frames"])]


def test_window_from_a_reference_state_holds(small_state):
    cfg, recipe, state_dir, _, scans = small_state
    w = recipe["frames"] - recipe["step"]
    res = parity.compare_window(state_dir, cfg, scans, {}, w=w, device="cpu")
    assert res["failures"] == [], res["failures"]
    assert res["step"] == recipe["step"] and res["frames"] == res["length"] == w
    assert res["captures"] == 0 and res["cold_gap_t_m"] < parity.COLD_TOL_M
    assert f"gated over the first {w}" in parity.summary_window(state_dir.name, res)


def test_window_catches_a_moved_pose(small_state):
    cfg, recipe, _, moved, scans = small_state
    res = parity.compare_window(moved, cfg, scans, {}, w=recipe["frames"] - recipe["step"], device="cpu")
    assert res["cold_gap_t_m"] > parity.COLD_TOL_M
    assert any(f.startswith("frames 0-") for f in res["failures"])
