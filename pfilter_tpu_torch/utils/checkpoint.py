"""Checkpoint / resume of the odometry state — port of
``pfilter_tpu/utils/checkpoint.py``, with its on-disk format.

A checkpoint is a directory holding ``state.npz``, one array per leaf keyed
by the reference package's dotted pytree path (``edge_map.xyz``, ...,
``opt_count``, ``pg_valid``; ``convert.flatten_leaves``), and ``meta.json``
with ``step``, ``n_leaves``, ``leaf_names``, ``treedef`` and ``extra``.
Either package reads the other's checkpoints.  The port's ``opt_count`` is a
Python int; it is stored as an int32 array of shape ``()``, as the
reference's, and read back as an int.

A map-sharded run (``pfilter_tpu_torch/parallel/``) holds one block of the
state per rank.  :func:`save_sharded_state` gathers every block to rank 0,
which writes the reference's layout of a sharded state (one global pytree:
tiled maps ``[n_seq, n_map, ...]``, grid maps ``[n_seq, CAP, ...]``, the
rest ``[n_seq, ...]``), so the reference's ``restore_state`` reads it into
its own sharded template; :func:`restore_sharded_state` cuts each rank's
block out of such a directory, whichever package wrote it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np

from pfilter_tpu_torch import convert

# Leaves that may be absent from, or shaped unlike the template in, an older
# checkpoint without invalidating it: the pose-graph window refills itself
# within ``window`` frames, so it restores with the template's values.
_OPTIONAL_PREFIXES = ("pg_",)


def _is_optional(name: str) -> bool:
    base = name.rsplit(".", 1)[-1]
    return any(base.startswith(p) for p in _OPTIONAL_PREFIXES)


def _write(path, arrays: dict, treedef: str, step: int, extra: Optional[dict]) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path / "state.npz", **arrays)
    meta = {
        "step": step,
        "n_leaves": len(arrays),
        "leaf_names": list(arrays),
        "treedef": treedef,
        "extra": extra or {},
    }
    (path / "meta.json").write_text(json.dumps(meta))


def save_state(path, state: Any, *, step: int = 0, extra: Optional[dict] = None) -> None:
    """Save an ``ESState`` or ``BPFState`` (the leaves are read back to the
    host once)."""
    _write(path, convert.flatten_leaves(convert.to_numpy(state)), convert.treedef_string(state), step, extra)


def save_sharded_state(path, state: Any, mesh, *, step: int = 0, extra: Optional[dict] = None) -> None:
    """Save a map-sharded run's state: every rank of the ``n_seq x n_map``
    grid calls this with its block (``mesh`` its ``parallel.mesh.Mesh``).
    The blocks are gathered to rank 0 over the default process group (the
    whole grid), assembled with ``convert.sharded_state_to_jax_numpy`` and
    written by rank 0 alone, in the layout of :func:`save_state`; every rank
    returns once the files are complete."""
    import torch.distributed as dist

    rank = dist.get_rank()
    blocks = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(convert.to_numpy(state), blocks, dst=0)
    if rank == 0:
        tree = convert.sharded_state_to_jax_numpy(blocks, mesh.n_seq, mesh.n_map)
        _write(path, convert.flatten_leaves(tree), convert.treedef_string(state), step, extra)
    dist.barrier()


def _read(path):
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    with np.load(path / "state.npz") as z:
        stored = {k: z[k] for k in z.files}
    return meta, stored


def _match(meta: dict, stored: dict, want: dict) -> dict:
    """The stored leaves for the template leaves ``want`` (dotted name ->
    array), by the rules of :func:`restore_state`."""
    if "leaf_names" not in meta:  # legacy positional format
        leaves = [stored[f"leaf_{i}"] for i in range(meta["n_leaves"])]
        if len(leaves) != len(want):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, template has {len(want)} (config mismatch?)")
        for i, (a, b) in enumerate(zip(leaves, want.values())):
            if np.shape(a) != np.shape(b):
                raise ValueError(f"leaf {i}: checkpoint shape {np.shape(a)} != template {np.shape(b)}")
        return dict(zip(want, leaves))

    out, fallbacks = {}, []
    for name, t_leaf in want.items():
        a = stored.get(name)
        if a is not None and np.shape(a) == np.shape(t_leaf):
            out[name] = a
        elif _is_optional(name):
            out[name] = t_leaf
            fallbacks.append(name)
        elif a is None:
            raise ValueError(f"checkpoint is missing required leaf {name!r}")
        else:
            raise ValueError(f"leaf {name!r}: checkpoint shape {np.shape(a)} != template {np.shape(t_leaf)} (config mismatch?)")
    bad = [k for k in sorted(set(stored) - set(want)) if not _is_optional(k)]
    if bad:
        raise ValueError(f"checkpoint has leaves unknown to the template: {bad}")
    meta["restored_from_template"] = fallbacks
    return out


def restore_state(path, template: Any) -> tuple[Any, dict]:
    """Restore into the structure, and onto the device, of ``template`` (an
    initialised state of the same config).  Returns ``(state, meta)``.

    Leaves are matched by name.  A leaf missing from the checkpoint, or
    shaped unlike the template's, falls back to the template's value only if
    it is optional (``pg_*``); those fallbacks are listed in
    ``meta["restored_from_template"]``.  Any other mismatch, and any leaf the
    template lacks, raises.  Legacy positional checkpoints (``leaf_{i}``
    keys) restore strictly by position, in the reference's leaf order."""
    meta, stored = _read(path)
    out = _match(meta, stored, convert.flatten_leaves(convert.to_numpy(template)))
    return convert.from_numpy_like(convert.nest_leaves(out), template), meta


def restore_sharded_state(path, cfg, mesh) -> tuple[Any, dict]:
    """This rank's block of a sharded state saved by :func:`save_sharded_state`
    or by the reference's ``save_state`` of its sharded state, for the
    sharded step of ``cfg`` (``mode`` "es" or "bpf") on ``mesh``, on the
    mesh's device.  Returns ``(block, meta)``.  The stored leaves are held
    to the global layout of an empty sharded state of ``cfg`` on this grid by
    the rules of :func:`restore_state`: the optional ``pg_*`` leaves fall
    back to it, any other mismatch (a config or grid that differs) raises."""
    from pfilter_tpu_torch.parallel import bpf_sharded, es_sharded

    if cfg.mode not in ("es", "bpf"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    template = (es_sharded if cfg.mode == "es" else bpf_sharded).init_sharded_state(cfg, mesh)
    block = convert.to_numpy(template)
    want = convert.flatten_leaves(convert.sharded_state_to_jax_numpy([block] * (mesh.n_seq * mesh.n_map), mesh.n_seq, mesh.n_map))
    meta, stored = _read(path)
    tree = convert.nest_leaves(_match(meta, stored, want))
    return convert.sharded_state_from_jax_numpy(tree, cfg, mesh.seq_index, mesh.map_index, mesh.n_map, mesh.device), meta


def save_trajectory(path, records: list) -> None:
    """Per-frame records as JSON lines (the structured twin of the
    reference's ROS_INFO timing prints, ref: include/odomEstimationClass.h:96-109)."""
    with open(path, "w") as f:
        for r in records:
            d = dataclasses.asdict(r) if dataclasses.is_dataclass(r) else dict(r)
            d = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in d.items()}
            f.write(json.dumps(d) + "\n")
