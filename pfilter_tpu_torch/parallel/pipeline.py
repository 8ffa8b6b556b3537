"""Host loops of the map-sharded step: :class:`ShardedESPipeline` and
:class:`ShardedBPFPipeline` run one rank's part of a sequence row as
``pipeline.ESPipeline`` and ``pipeline.BPFPipeline`` run a whole sequence:
the same scan padding and upload, the same lagged non-blocking fetch of one
packed row per frame, the same records.  Every rank of a row feeds the
row's scans and gets the row's poses.  On a CUDA device both run their
steady frames from a CUDA graph as the single-device pipelines do, the
NCCL collectives inside it, as the reference ``jax.jit``s its
``shard_map``: the first frame and the frames whose outer iterations still
decay run eagerly (and make the group's communicator), the first frame at
the floor is captured, every later frame replays it.  Every rank decides
alike, from the frame index alone.  ``graphs=False`` runs every frame
eagerly; on the CPU (gloo) there is no graph."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from pfilter_tpu_torch.graphs import Counters, LAUNCH_COUNTERS
from pfilter_tpu_torch.parallel import bpf_sharded, es_sharded
from pfilter_tpu_torch.parallel.mesh import Mesh
from pfilter_tpu_torch.pipeline import BPFPipeline, ESPipeline, _pack


class _OnMesh:
    """What both sharded pipelines add to their single-device host loop: the
    mesh's device, and the frame graph's extra counters and capture mode."""

    def _mesh_device(self) -> None:
        if self.mesh is None:
            raise ValueError(f"{type(self).__name__} needs a mesh (parallel.mesh.make_mesh)")
        if self.device is None:
            self.device = self.mesh.device
        elif torch.device(self.device) != self.mesh.device:
            raise ValueError(f"device {self.device} is not the mesh's {self.mesh.device}")

    def _graph_options(self) -> dict:
        """The graph carries the mesh's collective counts through replays,
        and captures beside the process group's watchdog thread
        (``graphs.py``)."""
        return dict(counters=Counters(LAUNCH_COUNTERS + tuple(self.mesh.counters())), capture_error_mode="thread_local")


@dataclass
class ShardedESPipeline(_OnMesh, ESPipeline):
    """ES odometry of this rank's map shard of its sequence row
    (``es_sharded``).  ``state``, when given, is this rank's block."""

    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self._mesh_device()
        if self.provenance:
            raise ValueError("the map-sharded step has no provenance channel")
        super().__post_init__()
        self._first = es_sharded.make_sharded_step(self.cfg, self.mesh, first=True)
        self._step = es_sharded.make_sharded_step(self.cfg, self.mesh, first=False)

    def _seed(self, xyz, mask, mover):
        """The first frame: seeds this rank's map shards."""
        state, diag = self._first(es_sharded.init_sharded_state(self.cfg, self.mesh), xyz, mask)
        return state, _pack(state.pose, diag)

    def _frame(self, state, xyz, mask, mover):
        """The device work of a frame after the first (what its CUDA graph
        holds): pre-filter, features, the sharded step with its collectives,
        the packed row.  ``mover`` is always None (no provenance)."""
        state, diag = self._step(state, xyz, mask)
        return state, _pack(state.pose, diag)


@dataclass
class ShardedBPFPipeline(_OnMesh, BPFPipeline):
    """BPF odometry of this rank's map shard of its sequence row
    (``bpf_sharded``); the front-end runs on every rank of the row."""

    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self._mesh_device()
        super().__post_init__()

    def _register(self, state, xyz, masks):
        first = state is None
        state = bpf_sharded.init_sharded_state(self.cfg, self.mesh) if first else state
        return bpf_sharded.sharded_frame(self.mesh, self.cfg, state, xyz, masks, first)


def make_sharded_pipeline(cfg, mesh: Mesh, **kwargs):
    """The sharded pipeline for ``cfg.mode`` ("es" | "bpf")."""
    if cfg.mode == "bpf":
        return ShardedBPFPipeline(cfg=cfg, mesh=mesh, **kwargs)
    if cfg.mode != "es":
        raise ValueError(f"unknown mode {cfg.mode!r}")
    return ShardedESPipeline(cfg=cfg, mesh=mesh, **kwargs)
