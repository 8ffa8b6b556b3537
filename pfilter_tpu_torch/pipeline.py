"""Host-side pipeline driver (the reference's ROS node graph,
src/laserProcessingNode.cpp + src/odomEstimationNode.cpp).

Port of ``ESPipeline`` and ``BPFPipeline`` from ``pfilter_tpu/pipeline.py``.
An ES frame is the optional ground/DCVC pre-filter, feature extraction, then
one odometry step; a BPF frame is the front-end (ground, DCVC, PCA classes)
then one three-channel odometry step.  Tensors stay on the device; the host
loop only feeds raw scans and collects poses.  A numpy scan is padded in
pinned host memory and copied up without blocking, so feeding it does not
wait for the frames before it.  With ``sync=False``
the per-frame results (pose and diagnostics, a few dozen numbers) are copied
to pinned host memory without blocking and read ``fetch_lag`` frames later,
after a CUDA event says they are there — the loop never waits on the frame
it has just dispatched.

On a CUDA device each pipeline runs its steady frames from a CUDA graph, as
the reference package runs its frame as one ``jax.jit`` program
(``graphs.py``): the first frame and the frames whose outer iterations still
decay (``opt_count`` above ``min_outer_iters``) run eagerly, the first frame
at the floor is captured, and every later frame with the same scan shape
replays it.  ``graphs=False`` runs every frame eagerly; on the CPU there is
no graph.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np
import torch

from pfilter_tpu_torch import host_buffer, resolve_device, upload
from pfilter_tpu_torch.config import PipelineConfig
from pfilter_tpu_torch.graphs import FrameGraphs
from pfilter_tpu_torch.models import bpf_frontend, bpf_odometry, es_odometry
from pfilter_tpu_torch.ops import dcvc, features, ground


def es_prefilter(xyz, mask, cfg: PipelineConfig):
    """Optional ES front-end (cfg.es_ground_filter / es_curved_filter): the
    reference's curvedVoxel_node preprocessing feeding the ES node
    (src/additionNode.cpp:12-54 with featurePreExtract=0)."""
    if cfg.es_ground_filter:
        mask = ground.segment_ground_dispatch(xyz, mask, cfg).nonground_mask
    if cfg.es_curved_filter:
        mask = dcvc.cluster(xyz, mask, cfg.dcvc, cfg.lidar).keep
    return mask


@dataclass
class FrameRecord:
    pose_q: np.ndarray
    pose_t: np.ndarray
    n_edge_corr: int
    n_surf_corr: int
    edge_map_size: int
    surf_map_size: int
    ms: float
    # Capacity-overflow counters (es_odometry.OVERFLOW_LANES) + host-side
    # raw-scan truncation count; all zero in a correctly-capacitied run.
    overflow: np.ndarray = None
    n_scan_trunc: int = 0
    # [2] (edge, surf) mover-contaminated map points (provenance mode only).
    contam: np.ndarray = None


_N_LANES = len(es_odometry.OVERFLOW_LANES)


def _pack(pose, diag) -> torch.Tensor:
    """One float32 row per frame: q(4), t(3), n_edge_corr, n_surf_corr,
    edge_map_size, surf_map_size, dropped, overflow(8), contam(2)."""
    f32 = torch.float32
    return torch.cat(
        [
            pose.q.to(f32),
            pose.t.to(f32),
            torch.stack([diag.n_edge_corr, diag.n_surf_corr, diag.edge_map_size, diag.surf_map_size]).to(f32),
            diag.dropped.to(f32).reshape(1),
            diag.overflow.to(f32),
            diag.contam.to(f32).reshape(-1).expand(2),
        ]
    )


class _HostLoop:
    """What both pipelines share: scan padding, the steady frame's CUDA
    graph, the lagged non-blocking fetch of one packed float32 row per frame,
    and draining."""

    def _setup(self):
        self.device = resolve_device(self.device)
        self._pending: list = []
        self._last_scan_trunc = 0
        if self.graphs is None:
            self.graphs = self.device.type == "cuda"
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, not {self.device}: a CUDA graph runs only on the card")
        self._graphs = FrameGraphs(type(self).__name__, self.device, **self._graph_options()) if self.graphs else None

    def _graph_options(self) -> dict:
        """``FrameGraphs``' options beyond the defaults (the sharded
        pipelines add their mesh's counters)."""
        return {}

    def _run_step(self, step, state, *inputs):
        """``step(state, *inputs)``, one frame after the first: from the
        frame's CUDA graph once the outer iterations have decayed to their
        floor (captured at the first such frame of each scan shape), else
        eagerly.  A frame runs ``max(floor, state.opt_count - 1)`` outer
        iterations, so every state whose count is at most one above the
        floor runs the same frame: it enters the graph with the floor."""
        o = self.cfg.odometry
        if self._graphs is None or max(o.min_outer_iters, state.opt_count - 1) != o.min_outer_iters:
            return step(state, *inputs)
        return self._graphs(step, state._replace(opt_count=o.min_outer_iters), *inputs)

    @property
    def captures(self) -> list:
        """The CUDA graphs captured so far (``graphs.FrameGraphs.captures``)."""
        return [] if self._graphs is None else self._graphs.captures

    @property
    def replays(self) -> int:
        """Frames run by replaying a CUDA graph so far."""
        return 0 if self._graphs is None else self._graphs.replays

    def _device_scan(self, xyz, valid):
        """A numpy scan padded to ``scan_points`` (truncation counted), or a
        tensor scan moved to the device as it is."""
        self._last_scan_trunc = 0
        if not isinstance(xyz, np.ndarray):
            if valid is None:
                return upload(xyz, self.device), torch.ones(xyz.shape[0], dtype=torch.bool, device=self.device)
            return upload(xyz, self.device), upload(valid, self.device)
        cap = self.cfg.capacity.scan_points
        n = min(len(xyz), cap)
        self._last_scan_trunc = max(len(xyz) - cap, 0)
        out = host_buffer((cap, 3), torch.float32, self.device)
        mask = host_buffer((cap,), torch.bool, self.device)
        out.numpy()[:n] = xyz[:n]
        mask.numpy()[:n] = True if valid is None else valid[:n]
        return upload(out, self.device), upload(mask, self.device)

    def _enqueue(self, t0: float, row: torch.Tensor):
        """Start the device->host copy of this frame's packed results."""
        if self.device.type == "cuda":
            host = torch.empty(row.shape, dtype=row.dtype, pin_memory=True)
            host.copy_(row, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        else:
            host, event = row, None
        self._pending.append((t0, self._last_scan_trunc, host, event))

    def _pop(self):
        """Complete the oldest pending fetch: (t0, scan truncation, row as float64)."""
        t0, n_trunc, host, event = self._pending.pop(0)
        if event is not None:
            event.synchronize()
        return t0, n_trunc, host.numpy().astype(np.float64)

    def _collect(self):
        rec = None
        lag = 0 if self.sync else max(self.fetch_lag, 0)
        while len(self._pending) > lag:
            rec = self._drain_one()
        return rec

    @property
    def overflow_total(self) -> int:
        """Sum of all capacity-overflow counters over completed frames —
        nonzero means points were silently dropped somewhere."""
        return int(sum(int(np.sum(r.overflow)) + r.n_scan_trunc for r in self.records))

    def flush(self) -> list:
        """Drain all pending fetches (call after the last frame in async mode)."""
        while self._pending:
            self._drain_one()
        return self.records

    def run(self, scans: Iterable) -> list:
        for item in scans:
            if isinstance(item, tuple):
                self.process_frame(*item)
            else:
                self.process_frame(item)
        return self.flush()

    @property
    def trajectory(self):
        self.flush()
        q = np.stack([r.pose_q for r in self.records])
        t = np.stack([r.pose_t for r in self.records])
        return q, t


@dataclass
class ESPipeline(_HostLoop):
    """End-to-end ES odometry over a scan stream, on ``device`` (CUDA unless
    ``"cpu"`` is passed).

    A frame whose optimized pose is non-finite or jumps implausibly far is
    dropped by the device itself (``es_step`` rolls the pose back), so the
    host loop needs no per-frame synchronization to stay safe.  With
    ``sync=True`` every frame's record is fetched before returning; with
    ``sync=False`` fetches lag ``fetch_lag`` frames behind dispatch — call
    :meth:`flush` (or read :attr:`trajectory`) to drain the tail."""

    cfg: PipelineConfig
    device: Optional[str] = None
    state: Optional[es_odometry.ESState] = None
    records: list = field(default_factory=list)
    max_jump_m: Optional[float] = None  # None keeps cfg.odometry.max_jump_m
    sync: bool = True
    fetch_lag: int = 4
    n_dropped: int = 0
    # Ground-truth provenance mode: scans carry a per-point mover-origin mask;
    # the map's rg gains a third channel whose census lands in FrameRecord.contam.
    provenance: bool = False
    # Steady frames from a CUDA graph: None means yes on a CUDA device.
    graphs: Optional[bool] = None

    def __post_init__(self):
        if self.cfg.mode != "es":
            raise ValueError(f"ESPipeline needs cfg.mode='es', got {self.cfg.mode!r}")
        self._setup()
        if self.max_jump_m is not None:
            self.cfg = self.cfg.replace(odometry=dataclasses.replace(self.cfg.odometry, max_jump_m=self.max_jump_m))

    def _prefilter(self, xyz, mask):
        return es_prefilter(xyz, mask, self.cfg)

    def _drain_one(self) -> FrameRecord:
        """Complete the oldest pending frame's fetch into a FrameRecord."""
        t0, n_trunc, v = self._pop()
        o = 12  # first overflow lane in the packed row
        dropped = bool(v[11] > 0.5)
        if dropped:
            self.n_dropped += 1
        rec = FrameRecord(
            pose_q=v[0:4].astype(np.float32),
            pose_t=v[4:7].astype(np.float32),
            n_edge_corr=int(v[7]),
            n_surf_corr=int(v[8]),
            edge_map_size=int(v[9]),
            surf_map_size=int(v[10]),
            ms=(time.perf_counter() - t0) * 1e3,
            overflow=v[o : o + _N_LANES].astype(np.int64),
            n_scan_trunc=n_trunc,
            contam=v[o + _N_LANES : o + _N_LANES + 2].astype(np.int64),
        )
        self.records.append(rec)
        return rec

    def process_frame(self, xyz, valid=None, mover=None) -> Optional[FrameRecord]:
        """Feed one sensor-frame scan ([N,3] float32 numpy array or tensor, plus
        optional validity; ``mover`` [N] bool required iff ``provenance=True``).

        Returns the completed FrameRecord in sync mode; in async mode the
        record of the frame ``fetch_lag`` frames ago (or None while filling)."""
        t0 = time.perf_counter()
        xyz_d, mask_d = self._device_scan(xyz, valid)
        mover_d = self._mover(mover, xyz_d.shape[0]) if self.provenance else None
        if self.state is None:
            self.state, row = self._seed(xyz_d, mask_d, mover_d)
        else:
            self.state, row = self._run_step(self._frame, self.state, xyz_d, mask_d, mover_d)
        self._enqueue(t0, row)
        return self._collect()

    def _mover(self, mover, n: int) -> torch.Tensor:
        """The provenance mask on the device, padded like the scan."""
        if mover is None:
            raise ValueError("provenance=True needs a mover mask per scan")
        if isinstance(mover, torch.Tensor) and mover.device.type != "cpu":
            mover_d = torch.zeros(n, dtype=torch.bool, device=self.device)
            m = mover.to(self.device, torch.bool)[:n]
            mover_d[: m.shape[0]] = m
            return mover_d
        m = np.asarray(mover, bool)[:n]
        host = host_buffer((n,), torch.bool, self.device)
        host.numpy()[: m.shape[0]] = m
        return upload(host, self.device)

    def _features(self, xyz, mask, mover):
        """The pre-filter, feature extraction and, in provenance mode, the
        mover mask binned as the features are."""
        cfg = self.cfg
        mask = self._prefilter(xyz, mask)
        feat = features.extract_features(xyz, mask, cfg.lidar, cfg.features, cfg.capacity)
        mgrid = None if mover is None else features.bin_extra(xyz, mask, mover, cfg.lidar, cfg.capacity)
        return feat, mgrid

    def _seed(self, xyz, mask, mover):
        """The first frame: seeds the maps; ``(state, packed row)``."""
        feat, mgrid = self._features(xyz, mask, mover)
        state = es_odometry.init_state(self.cfg, rg_width=3 if self.provenance else 2, device=self.device)
        state = es_odometry.first_frame(state, feat, self.cfg, mover=mgrid)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        diag = es_odometry.FrameDiag(
            n_edge_corr=zero,
            n_surf_corr=zero,
            edge_map_size=state.edge_map.valid.sum(),
            surf_map_size=state.surf_map.valid.sum(),
            dropped=torch.zeros((), dtype=torch.bool, device=self.device),
            overflow=es_odometry.zero_overflow(self.device),
            contam=es_odometry._contam(state.edge_map, state.surf_map) if self.provenance else zero,
        )
        return state, _pack(state.pose, diag)

    def _frame(self, state, xyz, mask, mover):
        """The device work of a frame after the first (what its CUDA graph
        holds): pre-filter, features, ``es_step``, the packed row."""
        feat, mgrid = self._features(xyz, mask, mover)
        state, diag = es_odometry.es_step(state, feat, self.cfg, mover=mgrid)
        return state, _pack(state.pose, diag)


@dataclass
class BPFFrameRecord:
    pose_q: np.ndarray
    pose_t: np.ndarray
    n_corr: np.ndarray  # [3] beam/pillar/facade correspondences
    map_sizes: np.ndarray  # [3]
    ms: float
    overflow: np.ndarray = None  # [3,4] per-channel counters (BPFDiag.overflow)
    # Raw-scan truncation + the front-end's dropped halo slots / voxels.
    n_scan_trunc: int = 0


def _pack_bpf(pose, n_corr, map_sizes, dropped, overflow, fe_trunc) -> torch.Tensor:
    """One float32 row per frame: q(4), t(3), n_corr(3), map_sizes(3),
    dropped, overflow(12), front-end truncation."""
    f32 = torch.float32
    return torch.cat(
        [
            pose.q.to(f32),
            pose.t.to(f32),
            n_corr.to(f32),
            map_sizes.to(f32),
            dropped.to(f32).reshape(1),
            overflow.to(f32).reshape(-1),
            fe_trunc.to(f32).reshape(1),
        ]
    )


@dataclass
class BPFPipeline(_HostLoop):
    """End-to-end BPF odometry on ``device`` (CUDA unless ``"cpu"`` is
    passed): ground seg -> DCVC -> PCA classify -> beam/pillar/facade
    scan-to-map GN (the reference's default launch path, curvedVoxel_node +
    odom_multi_estimation; ref: src/additionNode.cpp:12-54,
    src/odomEstimationNode.cpp:191-331).  Fetching works as in
    :class:`ESPipeline`."""

    cfg: PipelineConfig
    use_ground_filter: bool = True
    use_curved_filter: bool = True
    device: Optional[str] = None
    state: Optional[bpf_odometry.BPFState] = None
    records: list = field(default_factory=list)
    sync: bool = True
    fetch_lag: int = 4
    n_dropped: int = 0
    # Steady frames from a CUDA graph: None means yes on a CUDA device.
    graphs: Optional[bool] = None

    def __post_init__(self):
        if self.cfg.mode != "bpf":
            raise ValueError(f"BPFPipeline needs cfg.mode='bpf', got {self.cfg.mode!r}")
        self._setup()

    def _drain_one(self) -> BPFFrameRecord:
        t0, n_trunc, v = self._pop()
        if v[13] > 0.5:
            self.n_dropped += 1
        rec = BPFFrameRecord(
            pose_q=v[0:4].astype(np.float32),
            pose_t=v[4:7].astype(np.float32),
            n_corr=v[7:10].astype(np.int64),
            map_sizes=v[10:13].astype(np.int64),
            ms=(time.perf_counter() - t0) * 1e3,
            overflow=v[14:26].reshape(3, 4).astype(np.int64),
            n_scan_trunc=n_trunc + int(v[26]),
        )
        self.records.append(rec)
        return rec

    def process_frame(self, xyz, valid=None) -> Optional[BPFFrameRecord]:
        """Feed one sensor-frame scan; returns as :meth:`ESPipeline.process_frame`."""
        t0 = time.perf_counter()
        xyz_d, mask_d = self._device_scan(xyz, valid)
        if self.state is None:
            self.state, row = self._frame(None, xyz_d, mask_d)
        else:
            self.state, row = self._run_step(self._frame, self.state, xyz_d, mask_d)
        self._enqueue(t0, row)
        return self._collect()

    def _frame(self, state, xyz, mask):
        """The device work of one frame (what a steady frame's CUDA graph
        holds): front-end, odometry, the packed row; ``(state, row)``."""
        fr = bpf_frontend.run_frontend(xyz, mask, self.cfg, self.use_ground_filter, self.use_curved_filter)
        masks = {"beam": fr.beam_mask, "pillar": fr.pillar_mask, "facade": fr.facade_mask}
        state, diag = self._register(state, xyz, masks)
        return state, _pack_bpf(state.pose, diag.n_corr, diag.map_sizes, diag.dropped, diag.overflow, fr.n_halo_truncated)

    def _register(self, state, xyz, masks):
        """The odometry of one frame on the front-end's channel masks:
        ``(state, BPFDiag)``; the first frame (``state`` None) seeds the maps."""
        if state is not None:
            return bpf_odometry.bpf_step(state, xyz, masks, self.cfg)
        state = bpf_odometry.first_frame(bpf_odometry.init_state(self.cfg, device=self.device), xyz, masks, self.cfg)
        zeros = torch.zeros((3, 4), dtype=torch.int32, device=self.device)
        sizes = torch.stack([m.valid.sum() for m in (state.beam_map, state.pillar_map, state.facade_map)])
        return state, bpf_odometry.BPFDiag(n_corr=zeros[:, 0], map_sizes=sizes, dropped=torch.zeros((), dtype=torch.bool, device=self.device), overflow=zeros)


def make_pipeline(cfg: PipelineConfig, **kwargs):
    """Pipeline for ``cfg.mode`` ("es" | "bpf"); kwargs go to its constructor."""
    if cfg.mode == "bpf":
        return BPFPipeline(cfg=cfg, **kwargs)
    if cfg.mode != "es":
        raise ValueError(f"unknown mode {cfg.mode!r}")
    return ESPipeline(cfg=cfg, **kwargs)
