"""The port at full width against the reference package's stored
trajectories (``tests/data/torch_reference_v1.npz``, written by
``tools/torch_reference_trajectories.py``): the file's schema, the one
definition of the range noise both packages' scans share, the port's ES
(frames 0-3) and BPF (frames 0-2) at ``kitti_config()`` on the CPU, and the
ES seed truncation at frame 0 of the v1 city.

The scans are the port's ``synthetic.render_shared_sequence`` on the CPU:
bit for bit the generator's (the reference's renderer, run eagerly, plus
``synthetic.shared_range_noise``), as ``test_port_renders_the_shared_scans``
checks on frame 0.  The gates are
``utils/parity.py``'s cold-start ones (1 cm / 2e-3 rad, overflow lanes
equal, map sizes within 5 %), the tolerance ``chip_smoke.py`` phase 26 holds
the card's first ten frames to."""

import ast
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfilter_tpu.config import kitti_config
from pfilter_tpu.ops import features as jfeat
from pfilter_tpu.utils import synthetic as jsyn
from pfilter_tpu_torch.models import es_odometry as tes
from pfilter_tpu_torch.ops import features as tfeat
from pfilter_tpu_torch.parallel import es_sharded as tes_sharded
from pfilter_tpu_torch.pipeline import FrameRecord, make_pipeline
from pfilter_tpu_torch.run_distributed import hold_to_poses, hold_to_reference
from pfilter_tpu_torch.utils import parity
from pfilter_tpu_torch.utils import synthetic as tsyn
from torch_parity import torch_config

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("torch_reference_trajectories", ROOT / "tools" / "torch_reference_trajectories.py")
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

ES_FRAMES = 4  # a few frames keep the file's CPU time near 25 s; the card holds all 100 (chip_smoke.py phase 26)
BPF_FRAMES = 3
REFERENCE = ROOT / "tests" / "data" / "torch_reference_v1.npz"
RENDER_THREADS = 4


@pytest.fixture(scope="module")
def reference():
    return parity.load_reference(REFERENCE)


@pytest.fixture(scope="module")
def scans():
    """Frames 0..ES_FRAMES-1 of the v1 city with the shared noise, rendered
    by the port on the CPU and padded to ``scan_points`` (as the pipelines
    pad a scan)."""
    cfg = kitti_config()
    poses = tsyn.make_loop_trajectory(ES_FRAMES, speed=gen.SPEED)
    threads = torch.get_num_threads()
    torch.set_num_threads(RENDER_THREADS)  # the ray caster's result does not depend on it
    try:
        xyz, valid = tsyn.render_shared_sequence(tsyn.make_city_world(seed=gen.WORLD_SEED), poses, torch_config(cfg).lidar, gen.AZIMUTH, device="cpu")
    finally:
        torch.set_num_threads(threads)
    cap = cfg.capacity.scan_points
    out = []
    for x, v in zip(xyz.numpy(), valid.numpy()):
        px, pv = np.zeros((cap, 3), np.float32), np.zeros(cap, bool)
        px[: len(v)], pv[: len(v)] = x, v
        out.append((px, pv))
    return cfg, out


def test_reference_file_holds_every_path(reference):
    runs, side = reference
    assert gen.OUT == REFERENCE and REFERENCE.stat().st_size < 1 << 20
    assert set(side["paths"]) == set(gen.PATHS) and set(runs) == set(gen.PATHS) | {"seed"}
    for name, (mode, overrides, n_frames, n_map) in gen.PATHS.items():
        rec, run = side["paths"][name], runs[name]
        assert (rec["mode"], tuple(rec["overrides"]), rec["frames"], rec["n_map"]) == (mode, overrides, n_frames, n_map), name
        lanes, maps = (8, 2) if mode == "es" else (12, 3)
        shapes = dict(q=(n_frames, 4), t=(n_frames, 3), overflow=(n_frames, lanes), map_sizes=(n_frames, maps), n_corr=(n_frames, maps))
        if mode == "bpf" and n_map is None:
            shapes["trunc"] = (n_frames,)
        assert {k: v.shape for k, v in run.items()} == shapes, name
        assert np.isfinite(run["q"]).all() and np.isfinite(run["t"]).all() and rec["seconds"] > 0
        assert rec["overflow_total"] == 0, name
        scores = rec["scores"][str(parity.SCORE_AT)]
        if n_frames >= parity.SCORE_AT:
            assert scores["segments"] > 0 and 0 < scores["drift_t_pct"] < 0.783, (name, scores)
        if n_frames > parity.SCORE_AT:  # bench.py's protocols, for its port
            assert rec["scores"]["full"]["frames"] == n_frames and rec["scores"]["v1"]["frames"] == min(n_frames, 300)
    assert side["jax"] and side["commit"]["head"] and side["noise"] == gen.noise_recipe()
    assert {"edge_features", "surf_features", "edge_owned_m4", "surf_owned_m4"} <= set(runs["seed"])


def test_noise_has_one_definition():
    """The generator, ``chip_smoke.py`` and ``run_distributed`` add the
    port's ``shared_range_noise``; no other file draws from the noise seed."""
    assert gen.shared_range_noise is tsyn.shared_range_noise
    for path in (ROOT / "chip_smoke.py", ROOT / "pfilter_tpu_torch" / "run_distributed.py"):
        assert "render_shared_sequence" in path.read_text(), path.name
    draws = []  # program files' default_rng calls seeded from the noise seed
    for path in [ROOT / "chip_smoke.py", *ROOT.glob("tools/*.py"), *ROOT.glob("pfilter_tpu*/**/*.py")]:
        tree = ast.parse(path.read_text())
        for fn in (f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)):
            for call in (c for c in ast.walk(fn) if isinstance(c, ast.Call) and ast.unparse(c.func).endswith("default_rng")):
                if any(w in ast.unparse(call) for w in ("SHARED_NOISE_SEED", "1000")):
                    draws.append(f"{path.relative_to(ROOT)}:{fn.name}")
    assert draws == ["pfilter_tpu_torch/utils/synthetic.py:shared_range_noise"], draws
    g = np.random.default_rng(0)
    xyz = g.normal(0.0, 20.0, (500, 3)).astype(np.float32)
    valid = g.uniform(size=500) > 0.2
    a = tsyn.shared_range_noise(xyz, valid, 7)
    assert a.dtype == np.float32 and np.array_equal(a, tsyn.shared_range_noise(xyz, valid, 7))
    assert np.array_equal(a[~valid], xyz[~valid]) and not np.array_equal(a, tsyn.shared_range_noise(xyz, valid, 8))
    n = np.random.default_rng(tsyn.SHARED_NOISE_SEED + 7).normal(0.0, tsyn.SHARED_NOISE_SIGMA, 500)
    r = np.linalg.norm(xyz.astype(np.float64), axis=1)
    np.testing.assert_allclose(np.linalg.norm(a.astype(np.float64), axis=1)[valid], (r + n)[valid], atol=1e-4)  # along each ray
    np.testing.assert_allclose(np.cross(a, xyz)[valid] / r[valid, None] ** 2, 0.0, atol=1e-6)


def test_generator_imports_jax_only_in_main(monkeypatch):
    """The generator's module loads where ``jax`` and ``pfilter_tpu`` cannot
    be imported (the port's own modules are ``test_torch_isolation.py``'s)."""
    for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "pfilter_tpu")]:
        monkeypatch.setitem(sys.modules, name, None)
    spec = importlib.util.spec_from_file_location("torch_reference_trajectories_nojax", ROOT / "tools" / "torch_reference_trajectories.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.PATHS == gen.PATHS
    with pytest.raises(ImportError):
        import jax  # noqa: F401  (the block holds)


def test_port_renders_the_shared_scans(scans):
    """Frame 0 as the generator makes it (the reference's renderer, eagerly,
    plus the shared noise) equals the port's CPU render bit for bit."""
    cfg, frames = scans
    poses = jsyn.make_loop_trajectory(1, speed=gen.SPEED)
    x, v = jsyn.render_scan(jsyn.se3.Pose(q=poses.q[0], t=poses.t[0]), jsyn.make_city_world(seed=gen.WORLD_SEED), cfg.lidar, gen.AZIMUTH, noise=0.0, t_time=0.0)
    v = np.asarray(v)
    xyz, valid = frames[0]
    assert v.sum() > 100_000
    np.testing.assert_array_equal(valid[: len(v)], v)
    np.testing.assert_array_equal(xyz[: len(v)], tsyn.shared_range_noise(np.asarray(x), v, 0))


def _run_port(cfg, frames, n):
    pipe = make_pipeline(torch_config(cfg), sync=True, device="cpu")
    for xyz, valid in frames[:n]:
        pipe.process_frame(torch.from_numpy(xyz), torch.from_numpy(valid))
    return parity.records_arrays(pipe.records)


@pytest.mark.parametrize("mode,n", [("es", ES_FRAMES), ("bpf", BPF_FRAMES)])
def test_port_matches_reference_at_full_width(scans, reference, mode, n, record_property):
    cfg, frames = scans
    runs, _ = reference
    res = parity.compare(_run_port(cfg.replace(mode=mode), frames, n), {k: v[:n] for k, v in runs[mode].items()})
    record_property("max_gap_m", res["max_gap_t_m"])
    record_property("max_gap_rad", res["max_gap_rad"])
    assert res["frames"] == n and not res["failures"], parity.summary(mode, res)


def test_seed_truncation_matches_reference(scans, reference):
    """Frame 0 seeds the single-device surf map with the first 32768 surf
    features and each of four shards with the first 8192 it owns; both drop
    the rest uncounted.  On the reference's own frame-0 features the port's
    single-device and ``n_map = 4`` seeds keep and drop what the
    reference's did (map sizes at frame 0 of its runs ``es`` and
    ``es_sharded_m4``), and each shard owns what the reference's does."""
    cfg, frames = scans
    runs, _ = reference
    seed = runs["seed"]
    xyz, valid = frames[0]
    jf = jax.jit(lambda a, b: jfeat.extract_features(a, b, cfg.lidar, cfg.features, cfg.capacity))(jnp.asarray(xyz), jnp.asarray(valid))
    assert int(jf.surf_mask.sum()) == int(seed["surf_features"]) and int(jf.edge_mask.sum()) == int(seed["edge_features"])
    tcfg = torch_config(cfg)
    feat = tfeat.FeatureResult(*(torch.from_numpy(np.array(a)) for a in jf))  # the reference's features
    single = tes.first_frame(tes.init_state(tcfg, device="cpu"), feat, tcfg)
    dropped = {}
    for kind in ("edge", "surf"):
        n_feat = int(seed[f"{kind}_features"])
        kept = int(getattr(single, f"{kind}_map").valid.sum())
        assert kept == runs["es"]["map_sizes"][0]["edge surf".split().index(kind)]
        owned, kept4 = [], 0
        leaf = tcfg.odometry.map_resolution * (2.0 if kind == "surf" else 1.0)
        mask = feat.surf_mask if kind == "surf" else feat.edge_mask
        for k in range(4):
            mesh = _Shard(n_map=4, map_index=k)
            index, own = tes_sharded.seed_shard(mesh, feat.xyz, mask, single.pose.t, leaf, tcfg, kind)
            owned.append(int(own))
            kept4 += int(index.valid.sum())
        assert owned == seed[f"{kind}_owned_m4"].tolist(), kind
        assert kept4 == runs["es_sharded_m4"]["map_sizes"][0]["edge surf".split().index(kind)]
        dropped[kind] = (n_feat - kept, n_feat - kept4)
    assert dropped["edge"] == (0, 0)
    # The quirk: both seeds drop tens of thousands of surf features, the
    # same number here (every shard owns more than its 8192 slots) but not
    # the same features.
    assert dropped["surf"][0] == dropped["surf"][1] > 70_000, dropped


def test_run_distributed_holds_row_zero_to_the_stored_reference(reference, tmp_path):
    """``run_distributed --reference`` (the stored file) holds row 0 to the
    reference's sharded run at the run's ``n_map``, per frame;
    ``--poses-ref`` (a ``--poses-out`` file) every row to the same row."""
    runs, _ = reference
    ref = runs["es_sharded_m2"]
    n = len(ref["t"])
    moved = ref["t"].copy()
    moved[7] += np.float32([0.003, 0.0, 0.0])
    records = [
        FrameRecord(pose_q=ref["q"][i], pose_t=moved[i], n_edge_corr=int(ref["n_corr"][i, 0]), n_surf_corr=int(ref["n_corr"][i, 1]),
                    edge_map_size=int(ref["map_sizes"][i, 0]), surf_map_size=int(ref["map_sizes"][i, 1]), ms=0.0, overflow=ref["overflow"][i])
        for i in range(n)
    ]
    rq, rt = np.stack([ref["q"], ref["q"]]), np.stack([moved, moved])
    poses = tsyn.make_loop_trajectory(n, speed=gen.SPEED)
    out = hold_to_reference(REFERENCE, "es", 2, rq, rt, records, gen.ground_truth(poses.q, poses.t))
    assert out["reference_path"] == "es_sharded_m2" and len(out["reference_gap_t_m_per_frame"]) == n
    np.testing.assert_allclose(out["reference_gap_t_m_per_frame"][7], 0.003, rtol=1e-3)
    assert out["parity"]["max_gap_t_frame"] == 7 and out["parity"]["failures"] == [] and out["parity"]["drift_gap_points"] < 1e-3
    np.savez(tmp_path / "rows.npz", q=rq, t=np.stack([ref["t"], moved]))
    rows = hold_to_poses(tmp_path / "rows.npz", rq, rt)
    assert rows["gap_t_frame"][1] == 0 and rows["gap_t_m"][1] == 0.0 and rows["gap_t_frame"][0] == 7 and len(rows["gap_t_m_per_frame"]) == 2


class _Shard:
    """The two fields of a ``parallel.mesh.Mesh`` that ``seed_shard`` reads."""

    def __init__(self, n_map, map_index):
        self.n_map, self.map_index = n_map, map_index
