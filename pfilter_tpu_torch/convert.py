"""Carry odometry state between the reference package and the port.

``state_from_jax_numpy`` turns the reference package's ``ESState`` — given as
nested numpy arrays, for example ``jax.device_get(state)`` — into the port's
:class:`~pfilter_tpu_torch.models.es_odometry.ESState` on a device: the
edge/surf ``TiledMap`` fields, pose, last pose, ``opt_count`` and the
pose-graph window.  This is the system's counterpart of carrying weights
across.  :func:`state_to_numpy` goes the other way (nested dicts of numpy
arrays, which :func:`state_from_jax_numpy` also accepts).  Nothing here
imports the reference package: its state is read by field name.
"""

from __future__ import annotations

import numpy as np
import torch

from pfilter_tpu_torch import resolve_device
from pfilter_tpu_torch.models.es_odometry import ESState
from pfilter_tpu_torch.ops import knn_tiled, se3

_MAP_FIELDS = knn_tiled.TiledMap._fields
_DTYPES = {"valid": torch.bool, "tile_start": torch.int32}


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(x, device, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def _map(m, device) -> knn_tiled.TiledMap:
    return knn_tiled.TiledMap(**{f: _tensor(_get(m, f), device, _DTYPES.get(f, torch.float32)) for f in _MAP_FIELDS})


def _pose(p, device) -> se3.Pose:
    return se3.Pose(q=_tensor(_get(p, "q"), device), t=_tensor(_get(p, "t"), device))


def state_from_jax_numpy(tree, device=None) -> ESState:
    """The port's ESState from the reference package's (numpy leaves)."""
    device = resolve_device(device)
    return ESState(
        edge_map=_map(_get(tree, "edge_map"), device),
        surf_map=_map(_get(tree, "surf_map"), device),
        pose=_pose(_get(tree, "pose"), device),
        last_pose=_pose(_get(tree, "last_pose"), device),
        opt_count=int(np.asarray(_get(tree, "opt_count"))),
        pg_q=_tensor(_get(tree, "pg_q"), device),
        pg_t=_tensor(_get(tree, "pg_t"), device),
        pg_h=_tensor(_get(tree, "pg_h"), device),
        pg_valid=_tensor(_get(tree, "pg_valid"), device, torch.bool),
    )


def state_to_numpy(state: ESState) -> dict:
    """Nested dicts of numpy arrays with the reference package's field names."""

    def np_(x):
        return x.detach().cpu().numpy()

    return {
        "edge_map": {f: np_(getattr(state.edge_map, f)) for f in _MAP_FIELDS},
        "surf_map": {f: np_(getattr(state.surf_map, f)) for f in _MAP_FIELDS},
        "pose": {"q": np_(state.pose.q), "t": np_(state.pose.t)},
        "last_pose": {"q": np_(state.last_pose.q), "t": np_(state.last_pose.t)},
        "opt_count": np.int32(state.opt_count),
        "pg_q": np_(state.pg_q),
        "pg_t": np_(state.pg_t),
        "pg_h": np_(state.pg_h),
        "pg_valid": np_(state.pg_valid),
    }
