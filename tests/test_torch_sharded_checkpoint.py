"""Checkpoints of map-sharded states (``utils/checkpoint.py``:
``save_sharded_state`` / ``restore_sharded_state``), the counterparts of the
reference's ``save_state`` / ``restore_state`` on its sharded state, at
``n_seq = 1, n_map = 2`` and ``n_seq = 2, n_map = 1``:

(a) the port saves after frame SAVE_AFTER (every rank's block gathered to
    rank 0, which writes), fresh worker processes restore it, and their
    next frames equal the uninterrupted run's bit for bit (one intra-op
    thread per worker: the CPU run is deterministic);
(b) the reference's ``restore_state``, against its own sharded template,
    accepts the port's directory, and its leaves equal the ranks' blocks
    assembled with ``convert.sharded_state_to_jax_numpy``;
(c) a directory written by the reference's ``save_state`` of its sharded
    state restores in the port, and the next step is within the sharded
    slice's tolerance of the reference's, 1 cm / 2e-3 rad
    (``tests/test_torch_es_sharded.py``);
(d) a checkpoint of another capacity or another grid raises.

The port runs as gloo workers of ``run_distributed --jobs``
(``tests/torch_dist.py``), so no worker imports JAX; the reference runs in
this process on the suite's virtual CPU devices."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pfilter_tpu.parallel import es_sharded as jes_sharded
from pfilter_tpu.utils import checkpoint as jckpt
from pfilter_tpu.utils import synthetic
from pfilter_tpu_torch import convert
from pfilter_tpu_torch.parallel.mesh import Mesh
from pfilter_tpu_torch.utils import checkpoint
from torch_dist import Workers, job, leaves, rank_output, run_reference, write_scans
from torch_parity import rotation_angle, tiny_config, torch_config

N_FRAMES = 4
SAVE_AFTER = 1  # frames 0-1 before the checkpoint, 2-3 after it
POS_TOL_M = 1e-2
ROT_TOL_RAD = 2e-3
GRIDS = [(1, 2), (2, 1)]


def _render(jcfg, seed, corridor_len, speed):
    world = synthetic.make_world(seed=seed, corridor_len=corridor_len)
    poses = synthetic.make_trajectory(N_FRAMES, speed=speed)
    xyz, valid = synthetic.render_sequence(world, poses, jcfg.lidar, n_azimuth=512, noise=0.0)
    return np.asarray(xyz), np.asarray(valid)


def _name(grid):
    return f"g{grid[0]}x{grid[1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_checkpoint")
    jcfg, _ = tiny_config()
    worlds = [_render(jcfg, 3, 80.0, 0.8), _render(jcfg, 11, 45.0, 0.6)]
    xyz = np.stack([w[0] for w in worlds])
    valid = np.stack([w[1] for w in worlds])
    scans = {n: write_scans(tmp / f"scans{n}.npz", xyz[:n], valid[:n]) for n in (1, 2)}
    dirs = {_name(g): tmp / _name(g) for g in GRIDS}
    first = [
        Workers(
            tmp, _name(g) + "_first", g[0] * g[1],
            [job(jcfg, g[0], g[1], scans[g[0]], dirs[_name(g)] / "full", save_states=[SAVE_AFTER],
                 checkpoint={"frame": SAVE_AFTER, "dir": str(dirs[_name(g)] / "port_ckpt")})],
        )
        for g in GRIDS
    ]
    ref = {}
    for g in GRIDS:
        r = run_reference(jes_sharded, jcfg, xyz[: g[0]], valid[: g[0]], g[0], g[1], N_FRAMES, keep=(SAVE_AFTER,))
        jckpt.save_state(dirs[_name(g)] / "ref_ckpt", r["states"][SAVE_AFTER], step=SAVE_AFTER + 1)
        ref[_name(g)] = r
    for w in first:
        w.wait()
    # Fresh processes resume from each checkpoint.
    second = [
        Workers(
            tmp, _name(g) + "_second", g[0] * g[1],
            [
                job(jcfg, g[0], g[1], scans[g[0]], dirs[_name(g)] / "resumed",
                    restore={"frame": SAVE_AFTER + 1, "dir": str(dirs[_name(g)] / "port_ckpt")}),
                job(jcfg, g[0], g[1], scans[g[0]], dirs[_name(g)] / "from_ref", frames=SAVE_AFTER + 2,
                    restore={"frame": SAVE_AFTER + 1, "dir": str(dirs[_name(g)] / "ref_ckpt")}),
            ],
        )
        for g in GRIDS
    ]
    for w in second:
        w.wait()
    return dict(jcfg=jcfg, dirs=dirs, ref=ref)


@pytest.mark.parametrize("grid", GRIDS, ids=_name)
def test_resumed_run_equals_uninterrupted_run(runs, grid):
    """(a) Every rank's frames after the checkpoint, and its final block,
    bit for bit the uninterrupted run's."""
    d = runs["dirs"][_name(grid)]
    for rank in range(grid[0] * grid[1]):
        full, resumed = rank_output(d / "full", rank), rank_output(d / "resumed", rank)
        after = slice(SAVE_AFTER + 1, N_FRAMES)
        for key in ("pose_q", "pose_t", "overflow", "n_corr", "map_sizes"):
            np.testing.assert_array_equal(resumed[key], full[key][after], err_msg=f"rank {rank} {key}")
        finals = [k for k in full if k.startswith("state.")]
        assert finals
        for k in finals:
            np.testing.assert_array_equal(resumed[k], full[k], err_msg=f"rank {rank} {k}")
    meta = json.loads((d / "port_ckpt" / "meta.json").read_text())
    assert meta["step"] == SAVE_AFTER + 1 and meta["extra"] == {"mode": "es"}


@pytest.mark.parametrize("grid", GRIDS, ids=_name)
def test_reference_restores_port_checkpoint(runs, grid):
    """(b) The reference's ``restore_state`` takes the port's directory into
    its own sharded template with no fallback, and every leaf equals the
    ranks' blocks after frame SAVE_AFTER, assembled."""
    d = runs["dirs"][_name(grid)]
    template = jes_sharded.init_sharded_state(runs["jcfg"], grid[0], grid[1])
    restored, meta = jckpt.restore_state(d / "port_ckpt", template)
    assert meta["restored_from_template"] == []
    got = leaves(restored)
    blocks = []
    for rank in range(grid[0] * grid[1]):
        out = rank_output(d / "full", rank)
        prefix = f"state{SAVE_AFTER}."
        blocks.append(convert.nest_leaves({k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}))
    want = convert.flatten_leaves(convert.sharded_state_to_jax_numpy(blocks, grid[0], grid[1]))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # The port writes the reference's dtypes (its restore would convert others).
    dtypes = {k: v.dtype for k, v in leaves(template).items()}
    with np.load(d / "port_ckpt" / "state.npz") as z:
        assert {k: z[k].dtype for k in z.files} == dtypes


@pytest.mark.parametrize("grid", GRIDS, ids=_name)
def test_port_resumes_reference_checkpoint(runs, grid):
    """(c) The port restores the reference's checkpoint of its sharded state
    on every rank, and its next step is within 1 cm / 2e-3 rad of the
    reference's; every rank of a row holds the same pose."""
    d = runs["dirs"][_name(grid)]
    ref = runs["ref"][_name(grid)]
    n_seq, n_map = grid
    nxt = SAVE_AFTER + 1
    for s in range(n_seq):
        row = [rank_output(d / "from_ref", s * n_map + m) for m in range(n_map)]
        for other in row[1:]:
            np.testing.assert_array_equal(other["pose_t"], row[0]["pose_t"])
        got = row[0]
        assert got["pose_t"].shape == (1, 3)
        gap_t = np.linalg.norm(got["pose_t"][0] - ref["t"][s, nxt])
        gap_r = rotation_angle(got["pose_q"][:1], ref["q"][s, nxt][None])[0]
        assert gap_t < POS_TOL_M and gap_r < ROT_TOL_RAD, (s, gap_t, gap_r)


@pytest.mark.parametrize("grid", GRIDS, ids=_name)
@pytest.mark.parametrize("mismatch", ["capacity", "grid"])
def test_restore_mismatch_raises(runs, grid, mismatch):
    """(d) A checkpoint restored for another map capacity, or on another
    grid, raises (each rank holds its cell; no process group is needed)."""
    cfg = torch_config(runs["jcfg"])
    n_seq, n_map = grid
    if mismatch == "capacity":
        cfg = cfg.replace(capacity=dataclasses.replace(cfg.capacity, edge_map_points=2 * cfg.capacity.edge_map_points))
    else:
        n_seq, n_map = n_map, n_seq
    mesh = Mesh(n_seq, n_map, n_seq - 1, n_map - 1, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="config mismatch"):
        checkpoint.restore_sharded_state(runs["dirs"][_name(grid)] / "port_ckpt", cfg, mesh)
    # The same directory restores on its own grid and config.
    mesh = Mesh(grid[0], grid[1], grid[0] - 1, grid[1] - 1, None, torch.device("cpu"))
    block, meta = checkpoint.restore_sharded_state(runs["dirs"][_name(grid)] / "port_ckpt", torch_config(runs["jcfg"]), mesh)
    assert meta["restored_from_template"] == [] and block.opt_count == runs["jcfg"].odometry.max_outer_iters - 1
