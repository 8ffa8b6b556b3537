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
from pfilter_tpu_torch.models import bpf_frontend, bpf_odometry, es_odometry
from pfilter_tpu_torch.ops import dcvc, features, ground


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
    """What both pipelines share: scan padding, the lagged non-blocking fetch
    of one packed float32 row per frame, and draining."""

    def _setup(self):
        self.device = resolve_device(self.device)
        self._pending: list = []
        self._last_scan_trunc = 0

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

    def __post_init__(self):
        if self.cfg.mode != "es":
            raise ValueError(f"ESPipeline needs cfg.mode='es', got {self.cfg.mode!r}")
        self._setup()
        if self.max_jump_m is not None:
            self.cfg = self.cfg.replace(odometry=dataclasses.replace(self.cfg.odometry, max_jump_m=self.max_jump_m))

    def _prefilter(self, xyz, mask):
        """Optional ES front-end (cfg.es_ground_filter / es_curved_filter):
        the reference's curvedVoxel_node preprocessing feeding the ES node
        (src/additionNode.cpp:12-54 with featurePreExtract=0)."""
        cfg = self.cfg
        if cfg.es_ground_filter:
            mask = ground.segment_ground_dispatch(xyz, mask, cfg).nonground_mask
        if cfg.es_curved_filter:
            mask = dcvc.cluster(xyz, mask, cfg.dcvc, cfg.lidar).keep
        return mask

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
        cfg = self.cfg
        xyz_d, mask_d = self._device_scan(xyz, valid)
        mask_d = self._prefilter(xyz_d, mask_d)
        feat = features.extract_features(xyz_d, mask_d, cfg.lidar, cfg.features, cfg.capacity)
        mgrid = None
        if self.provenance:
            if mover is None:
                raise ValueError("provenance=True needs a mover mask per scan")
            n = xyz_d.shape[0]
            if isinstance(mover, torch.Tensor) and mover.device.type != "cpu":
                mover_d = torch.zeros(n, dtype=torch.bool, device=self.device)
                m = mover.to(self.device, torch.bool)[:n]
                mover_d[: m.shape[0]] = m  # padded like the scan
            else:
                m = np.asarray(mover, bool)[:n]
                host = host_buffer((n,), torch.bool, self.device)
                host.numpy()[: m.shape[0]] = m  # padded like the scan
                mover_d = upload(host, self.device)
            mgrid = features.bin_extra(xyz_d, mask_d, mover_d, self.cfg.lidar, self.cfg.capacity)
        if self.state is None:
            state = es_odometry.init_state(self.cfg, rg_width=3 if self.provenance else 2, device=self.device)
            self.state = es_odometry.first_frame(state, feat, self.cfg, mover=mgrid)
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            diag = es_odometry.FrameDiag(
                n_edge_corr=zero,
                n_surf_corr=zero,
                edge_map_size=self.state.edge_map.valid.sum(),
                surf_map_size=self.state.surf_map.valid.sum(),
                dropped=torch.zeros((), dtype=torch.bool, device=self.device),
                overflow=es_odometry.zero_overflow(self.device),
                contam=es_odometry._contam(self.state.edge_map, self.state.surf_map) if self.provenance else zero,
            )
        else:
            self.state, diag = es_odometry.es_step(self.state, feat, self.cfg, mover=mgrid)
        self._enqueue(t0, _pack(self.state.pose, diag))
        return self._collect()


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
        cfg = self.cfg
        xyz_d, mask_d = self._device_scan(xyz, valid)
        fr = bpf_frontend.run_frontend(xyz_d, mask_d, cfg, self.use_ground_filter, self.use_curved_filter)
        masks = {"beam": fr.beam_mask, "pillar": fr.pillar_mask, "facade": fr.facade_mask}
        if self.state is None:
            state = bpf_odometry.init_state(cfg, device=self.device)
            self.state = bpf_odometry.first_frame(state, xyz_d, masks, cfg)
            sizes = torch.stack([m.valid.sum() for m in (self.state.beam_map, self.state.pillar_map, self.state.facade_map)])
            row = _pack_bpf(
                self.state.pose,
                torch.zeros(3, dtype=torch.int32, device=self.device),
                sizes,
                torch.zeros((), dtype=torch.bool, device=self.device),
                torch.zeros((3, 4), dtype=torch.int32, device=self.device),
                fr.n_halo_truncated,
            )
        else:
            self.state, diag = bpf_odometry.bpf_step(self.state, xyz_d, masks, cfg)
            row = _pack_bpf(self.state.pose, diag.n_corr, diag.map_sizes, diag.dropped, diag.overflow, fr.n_halo_truncated)
        self._enqueue(t0, row)
        return self._collect()


def make_pipeline(cfg: PipelineConfig, **kwargs):
    """Pipeline for ``cfg.mode`` ("es" | "bpf"); kwargs go to its constructor."""
    if cfg.mode == "bpf":
        return BPFPipeline(cfg=cfg, **kwargs)
    if cfg.mode != "es":
        raise ValueError(f"unknown mode {cfg.mode!r}")
    return ESPipeline(cfg=cfg, **kwargs)
