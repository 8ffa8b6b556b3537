"""Carry odometry state between the reference package and the port.

``state_from_jax_numpy`` turns the reference package's ``ESState`` — given as
nested numpy arrays, for example ``jax.device_get(state)`` — into the port's
:class:`~pfilter_tpu_torch.models.es_odometry.ESState` on a device: the
edge/surf maps, pose, last pose, ``opt_count`` and the pose-graph window.
A map is a ``TiledMap`` (``xyz, rg, valid, xyz_t, tile_start, origin``) or,
for ``knn_impl="grid"``, a ``HashGrid`` (``xyz, rg, valid, cell_ids, origin,
cell_size``), told apart by its fields.  This is the system's counterpart of carrying weights
across.  :func:`state_to_numpy` goes the other way (nested dicts of numpy
arrays, which :func:`state_from_jax_numpy` also accepts).
:func:`sharded_state_from_jax_numpy` cuts one rank's block out of the
reference's map-sharded state, ES or BPF, and
:func:`sharded_state_to_jax_numpy` assembles that global state from every
rank's block.
:func:`bpf_state_from_jax_numpy` and :func:`bpf_state_to_numpy` do the same
for a ``BPFState`` (beam, pillar and facade maps).  Nothing here imports the
reference package: its state is read by field name.

:func:`flatten_leaves` and :func:`nest_leaves` go between that nested form
and the reference's flat form, one array per dotted pytree path
(``edge_map.xyz``, ``pose.q``, ``opt_count``, ``pg_valid``, ...) in the
reference's leaf order; ``utils/checkpoint.py`` stores states in it, so a
checkpoint is a second way to carry a state between the packages.
"""

from __future__ import annotations

import numpy as np
import torch

from pfilter_tpu_torch import resolve_device
from pfilter_tpu_torch.models.bpf_odometry import BPFState
from pfilter_tpu_torch.models.es_odometry import ESState
from pfilter_tpu_torch.ops import knn, knn_tiled, se3

_DTYPES = {"valid": torch.bool, "tile_start": torch.int32, "cell_ids": torch.int32}


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(x, device, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def _map_type(m):
    """``HashGrid`` if the map has grid cell ids, else ``TiledMap``."""
    has_ids = "cell_ids" in m if isinstance(m, dict) else hasattr(m, "cell_ids")
    return knn.HashGrid if has_ids else knn_tiled.TiledMap


def _map(m, device):
    cls = _map_type(m)
    return cls(**{f: _tensor(_get(m, f), device, _DTYPES.get(f, torch.float32)) for f in cls._fields})


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

    out = {m: {f: np_(x) for f, x in getattr(state, m)._asdict().items()} for m in map_names}
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


def to_numpy(state) -> dict:
    """:func:`state_to_numpy` or :func:`bpf_state_to_numpy`, by the state's type."""
    return _to_numpy(state, _ES_MAPS if isinstance(state, ESState) else _BPF_MAPS)


def from_numpy_like(tree, template):
    """A state of ``template``'s type on its device, from nested numpy leaves."""
    if isinstance(template, ESState):
        return _from(ESState, tree, _ES_MAPS, template.pose.q.device)
    return _from(BPFState, tree, _BPF_MAPS, template.pose.q.device)


_REPLICATED_GRID_FIELDS = ("origin", "cell_size")


def _map_names(tree):
    has_edge = "edge_map" in tree if isinstance(tree, dict) else hasattr(tree, "edge_map")
    return (ESState, _ES_MAPS) if has_edge else (BPFState, _BPF_MAPS)


def _check_map_layout(cfg, m, n_map: int, name: str) -> None:
    tiled = _map_type(m) is knn_tiled.TiledMap
    if tiled != (cfg.capacity.knn_impl == "tiled"):
        raise ValueError(f"{name}: a {'tiled' if tiled else 'grid'} map, but cfg.capacity.knn_impl={cfg.capacity.knn_impl!r}")
    if not tiled and np.shape(_get(m, "valid"))[-1] % n_map:
        raise ValueError(f"{name}: grid capacity {np.shape(_get(m, 'valid'))[-1]} is not divisible by n_map={n_map}")


def sharded_state_from_jax_numpy(tree, cfg, seq: int, shard: int, n_map: int, device=None):
    """One rank's block of the reference package's global sharded state
    (``pfilter_tpu.parallel`` ``ESState`` or ``BPFState``, numpy leaves) as the
    port's state on ``device``: sequence row ``seq``, map shard ``shard``.  A
    tiled map's leaves carry an explicit ``[n_seq, n_map, ...]`` prefix; a
    grid map's are ``[n_seq, CAP, ...]`` arrays whose capacity axis holds
    ``n_map`` contiguous blocks (its origin and cell size are replicated);
    every other leaf is ``[n_seq, ...]``."""
    cls, map_names = _map_names(tree)
    local = {}
    for name in map_names:
        m = _get(tree, name)
        _check_map_layout(cfg, m, n_map, name)
        if _map_type(m) is knn_tiled.TiledMap:
            local[name] = {f: np.asarray(_get(m, f))[seq, shard] for f in knn_tiled.TiledMap._fields}
            continue
        block = {}
        for f in knn.HashGrid._fields:
            x = np.asarray(_get(m, f))[seq]
            if f not in _REPLICATED_GRID_FIELDS:
                c = x.shape[0] // n_map
                x = x[shard * c : (shard + 1) * c]
            block[f] = x
        local[name] = block
    for name in ("pose", "last_pose"):
        p = _get(tree, name)
        local[name] = {"q": np.asarray(_get(p, "q"))[seq], "t": np.asarray(_get(p, "t"))[seq]}
    for name in ("opt_count", "pg_q", "pg_t", "pg_h", "pg_valid"):
        local[name] = np.asarray(_get(tree, name))[seq]
    return _from(cls, local, map_names, device)


def sharded_state_to_jax_numpy(blocks: list, n_seq: int, n_map: int) -> dict:
    """The inverse of :func:`sharded_state_from_jax_numpy`: the reference's
    global sharded state (nested dicts of numpy arrays) from every rank's
    block (``to_numpy`` of each, in rank order: row-major over seq x map).
    The replicated leaves are taken from each row's shard 0."""
    if len(blocks) != n_seq * n_map:
        raise ValueError(f"{len(blocks)} blocks for a {n_seq} x {n_map} grid")
    rows = [blocks[s * n_map : (s + 1) * n_map] for s in range(n_seq)]
    _, map_names = _map_names(blocks[0])
    out = {}
    for name in map_names:
        fields = blocks[0][name]
        tiled = "cell_ids" not in fields
        out[name] = {}
        for f in fields:
            if tiled:
                out[name][f] = np.stack([np.stack([b[name][f] for b in row]) for row in rows])
            elif f in _REPLICATED_GRID_FIELDS:
                out[name][f] = np.stack([row[0][name][f] for row in rows])
            else:
                out[name][f] = np.stack([np.concatenate([b[name][f] for b in row]) for row in rows])
    for name in ("pose", "last_pose"):
        out[name] = {f: np.stack([row[0][name][f] for row in rows]) for f in ("q", "t")}
    for name in ("opt_count", "pg_q", "pg_t", "pg_h", "pg_valid"):
        out[name] = np.stack([np.asarray(row[0][name]) for row in rows])
    return out


def flatten_leaves(tree: dict, prefix: str = "") -> dict:
    """Nested dicts of arrays -> ``{dotted name: array}``, in the reference
    package's pytree leaf order (the order of :func:`state_to_numpy`)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten_leaves(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def nest_leaves(flat: dict) -> dict:
    """``{dotted name: array}`` -> nested dicts (inverse of :func:`flatten_leaves`)."""
    out: dict = {}
    for name, value in flat.items():
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = value
    return out


def treedef_string(state) -> str:
    """The reference package's ``str`` of the state's pytree structure
    (informational; restoring reads leaf names, not this)."""

    def node(x):
        if hasattr(x, "_fields"):
            return f"CustomNode(namedtuple[{type(x).__name__}], [{', '.join(node(v) for v in x)}])"
        return "*"

    return f"PyTreeDef({node(state)})"
