"""Carry odometry state between the reference package and the port.

``state_from_jax_numpy`` turns the reference package's ``ESState`` — given as
nested numpy arrays, for example ``jax.device_get(state)`` — into the port's
:class:`~pfilter_tpu_torch.models.es_odometry.ESState` on a device: the
edge/surf ``TiledMap`` fields, pose, last pose, ``opt_count`` and the
pose-graph window.  This is the system's counterpart of carrying weights
across.  :func:`state_to_numpy` goes the other way (nested dicts of numpy
arrays, which :func:`state_from_jax_numpy` also accepts).
:func:`bpf_state_from_jax_numpy` and :func:`bpf_state_to_numpy` do the same
for a ``BPFState`` (beam, pillar and facade maps).  Nothing here imports the
reference package: its state is read by field name.
"""

from __future__ import annotations

import numpy as np
import torch

from pfilter_tpu_torch import resolve_device
from pfilter_tpu_torch.models.bpf_odometry import BPFState
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


def _from(cls, tree, map_names, device):
    device = resolve_device(device)
    return cls(
        **{m: _map(_get(tree, m), device) for m in map_names},
        pose=_pose(_get(tree, "pose"), device),
        last_pose=_pose(_get(tree, "last_pose"), device),
        opt_count=int(np.asarray(_get(tree, "opt_count"))),
        pg_q=_tensor(_get(tree, "pg_q"), device),
        pg_t=_tensor(_get(tree, "pg_t"), device),
        pg_h=_tensor(_get(tree, "pg_h"), device),
        pg_valid=_tensor(_get(tree, "pg_valid"), device, torch.bool),
    )


def _to_numpy(state, map_names) -> dict:
    def np_(x):
        return x.detach().cpu().numpy()

    out = {m: {f: np_(getattr(getattr(state, m), f)) for f in _MAP_FIELDS} for m in map_names}
    out.update(
        pose={"q": np_(state.pose.q), "t": np_(state.pose.t)},
        last_pose={"q": np_(state.last_pose.q), "t": np_(state.last_pose.t)},
        opt_count=np.int32(state.opt_count),
        pg_q=np_(state.pg_q),
        pg_t=np_(state.pg_t),
        pg_h=np_(state.pg_h),
        pg_valid=np_(state.pg_valid),
    )
    return out


_ES_MAPS = ("edge_map", "surf_map")
_BPF_MAPS = ("beam_map", "pillar_map", "facade_map")


def state_from_jax_numpy(tree, device=None) -> ESState:
    """The port's ESState from the reference package's (numpy leaves)."""
    return _from(ESState, tree, _ES_MAPS, device)


def state_to_numpy(state: ESState) -> dict:
    """Nested dicts of numpy arrays with the reference package's field names."""
    return _to_numpy(state, _ES_MAPS)


def bpf_state_from_jax_numpy(tree, device=None) -> BPFState:
    """The port's BPFState from the reference package's (numpy leaves)."""
    return _from(BPFState, tree, _BPF_MAPS, device)


def bpf_state_to_numpy(state: BPFState) -> dict:
    """Nested dicts of numpy arrays with the reference package's field names."""
    return _to_numpy(state, _BPF_MAPS)
