"""Host loops of the map-sharded step: :class:`ShardedESPipeline` and
:class:`ShardedBPFPipeline` run one rank's part of a sequence row as
``pipeline.ESPipeline`` and ``pipeline.BPFPipeline`` run a whole sequence:
the same scan padding and upload, the same lagged non-blocking fetch of one
packed row per frame, the same records.  Every rank of a row feeds the
row's scans and gets the row's poses.  Both run every frame eagerly (no CUDA
graph): ``graphs=True`` raises."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from pfilter_tpu_torch.parallel import bpf_sharded, es_sharded
from pfilter_tpu_torch.parallel.mesh import Mesh
from pfilter_tpu_torch.pipeline import BPFPipeline, ESPipeline, _pack


def _mesh_device(pipe) -> None:
    """The mesh's device, and no CUDA graph: the sharded step's collectives
    run eagerly."""
    if pipe.graphs:
        raise ValueError(f"{type(pipe).__name__} runs eagerly: a CUDA graph of the sharded step (NCCL inside the graph) is not built")
    pipe.graphs = False
    if pipe.mesh is None:
        raise ValueError(f"{type(pipe).__name__} needs a mesh (parallel.mesh.make_mesh)")
    if pipe.device is None:
        pipe.device = pipe.mesh.device
    elif torch.device(pipe.device) != pipe.mesh.device:
        raise ValueError(f"device {pipe.device} is not the mesh's {pipe.mesh.device}")


@dataclass
class ShardedESPipeline(ESPipeline):
    """ES odometry of this rank's map shard of its sequence row
    (``es_sharded``).  ``state``, when given, is this rank's block."""

    mesh: Optional[Mesh] = None

    def __post_init__(self):
        _mesh_device(self)
        if self.provenance:
            raise ValueError("the map-sharded step has no provenance channel")
        super().__post_init__()
        self._first = es_sharded.make_sharded_step(self.cfg, self.mesh, first=True)
        self._step = es_sharded.make_sharded_step(self.cfg, self.mesh, first=False)

    def process_frame(self, xyz, valid=None):
        """Feed this row's next scan; returns as ``ESPipeline.process_frame``."""
        t0 = time.perf_counter()
        xyz_d, mask_d = self._device_scan(xyz, valid)
        if self.state is None:
            self.state, diag = self._first(es_sharded.init_sharded_state(self.cfg, self.mesh), xyz_d, mask_d)
        else:
            self.state, diag = self._step(self.state, xyz_d, mask_d)
        self._enqueue(t0, _pack(self.state.pose, diag))
        return self._collect()


@dataclass
class ShardedBPFPipeline(BPFPipeline):
    """BPF odometry of this rank's map shard of its sequence row
    (``bpf_sharded``); the front-end runs on every rank of the row."""

    mesh: Optional[Mesh] = None

    def __post_init__(self):
        _mesh_device(self)
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
