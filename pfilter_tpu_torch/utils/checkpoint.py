"""Checkpoint / resume of the odometry state — port of
``pfilter_tpu/utils/checkpoint.py``, with its on-disk format.

A checkpoint is a directory holding ``state.npz``, one array per leaf keyed
by the reference package's dotted pytree path (``edge_map.xyz``, ...,
``opt_count``, ``pg_valid``; ``convert.flatten_leaves``), and ``meta.json``
with ``step``, ``n_leaves``, ``leaf_names``, ``treedef`` and ``extra``.
Either package reads the other's checkpoints.  The port's ``opt_count`` is a
Python int; it is stored as an int32 array of shape ``()``, as the
reference's, and read back as an int.
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


def save_state(path, state: Any, *, step: int = 0, extra: Optional[dict] = None) -> None:
    """Save an ``ESState`` or ``BPFState`` (the leaves are read back to the
    host once)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays = convert.flatten_leaves(convert.to_numpy(state))
    np.savez_compressed(path / "state.npz", **arrays)
    meta = {
        "step": step,
        "n_leaves": len(arrays),
        "leaf_names": list(arrays),
        "treedef": convert.treedef_string(state),
        "extra": extra or {},
    }
    (path / "meta.json").write_text(json.dumps(meta))


def restore_state(path, template: Any) -> tuple[Any, dict]:
    """Restore into the structure, and onto the device, of ``template`` (an
    initialised state of the same config).  Returns ``(state, meta)``.

    Leaves are matched by name.  A leaf missing from the checkpoint, or
    shaped unlike the template's, falls back to the template's value only if
    it is optional (``pg_*``); those fallbacks are listed in
    ``meta["restored_from_template"]``.  Any other mismatch, and any leaf the
    template lacks, raises.  Legacy positional checkpoints (``leaf_{i}``
    keys) restore strictly by position, in the reference's leaf order."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    want = convert.flatten_leaves(convert.to_numpy(template))
    with np.load(path / "state.npz") as z:
        stored = {k: z[k] for k in z.files}

    if "leaf_names" not in meta:  # legacy positional format
        leaves = [stored[f"leaf_{i}"] for i in range(meta["n_leaves"])]
        if len(leaves) != len(want):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, template has {len(want)} (config mismatch?)")
        for i, (a, b) in enumerate(zip(leaves, want.values())):
            if np.shape(a) != np.shape(b):
                raise ValueError(f"leaf {i}: checkpoint shape {np.shape(a)} != template {np.shape(b)}")
        out = dict(zip(want, leaves))
        return convert.from_numpy_like(convert.nest_leaves(out), template), meta

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
    return convert.from_numpy_like(convert.nest_leaves(out), template), meta


def save_trajectory(path, records: list) -> None:
    """Per-frame records as JSON lines (the structured twin of the
    reference's ROS_INFO timing prints, ref: include/odomEstimationClass.h:96-109)."""
    with open(path, "w") as f:
        for r in records:
            d = dataclasses.asdict(r) if dataclasses.is_dataclass(r) else dict(r)
            d = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in d.items()}
            f.write(json.dumps(d) + "\n")
