"""Host-side pipeline driver (the reference's ROS node graph,
src/laserProcessingNode.cpp + src/odomEstimationNode.cpp).

Port of ``ESPipeline`` from ``pfilter_tpu/pipeline.py``.  Each frame is
feature extraction then one odometry step, tensors staying on the device;
the host loop only feeds raw scans and collects poses.  With ``sync=False``
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

from pfilter_tpu_torch import resolve_device
from pfilter_tpu_torch.config import PipelineConfig
from pfilter_tpu_torch.models import es_odometry
from pfilter_tpu_torch.ops import features


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


@dataclass
class ESPipeline:
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
        if self.cfg.es_ground_filter or self.cfg.es_curved_filter:
            raise NotImplementedError(
                "es_ground_filter/es_curved_filter need the ground and DCVC front-ends, "
                "which are not ported yet (ROADMAP.md)"
            )
        self.device = resolve_device(self.device)
        if self.max_jump_m is not None:
            self.cfg = self.cfg.replace(odometry=dataclasses.replace(self.cfg.odometry, max_jump_m=self.max_jump_m))
        self._pending: list = []
        self._last_scan_trunc = 0

    def _pad_scan(self, xyz: np.ndarray, valid: Optional[np.ndarray]):
        cap = self.cfg.capacity.scan_points
        n = min(len(xyz), cap)
        self._last_scan_trunc = max(len(xyz) - cap, 0)
        out = np.zeros((cap, 3), np.float32)
        out[:n] = xyz[:n]
        mask = np.zeros(cap, bool)
        if valid is None:
            mask[:n] = True
        else:
            mask[:n] = valid[:n]
        return torch.from_numpy(out).to(self.device), torch.from_numpy(mask).to(self.device)

    def _extract(self, xyz, mask):
        cfg = self.cfg
        return features.extract_features(xyz, mask, cfg.lidar, cfg.features, cfg.capacity)

    def _enqueue(self, t0: float, n_trunc: int, pose, diag):
        """Start the device->host copy of this frame's packed results."""
        row = _pack(pose, diag)
        if self.device.type == "cuda":
            host = torch.empty(row.shape, dtype=row.dtype, pin_memory=True)
            host.copy_(row, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        else:
            host, event = row, None
        self._pending.append((t0, n_trunc, host, event))

    def _drain_one(self) -> FrameRecord:
        """Complete the oldest pending frame's fetch into a FrameRecord."""
        t0, n_trunc, host, event = self._pending.pop(0)
        if event is not None:
            event.synchronize()
        v = host.numpy().astype(np.float64)
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

    def process_frame(self, xyz, valid=None, mover=None) -> Optional[FrameRecord]:
        """Feed one sensor-frame scan ([N,3] float32 numpy array or tensor, plus
        optional validity; ``mover`` [N] bool required iff ``provenance=True``).

        Returns the completed FrameRecord in sync mode; in async mode the
        record of the frame ``fetch_lag`` frames ago (or None while filling)."""
        t0 = time.perf_counter()
        self._last_scan_trunc = 0
        if isinstance(xyz, np.ndarray):
            xyz_d, mask_d = self._pad_scan(xyz, valid)
        else:
            xyz_d = xyz.to(self.device)
            mask_d = (
                valid.to(self.device)
                if valid is not None
                else torch.ones(xyz.shape[0], dtype=torch.bool, device=self.device)
            )
        feat = self._extract(xyz_d, mask_d)
        mgrid = None
        if self.provenance:
            if mover is None:
                raise ValueError("provenance=True needs a mover mask per scan")
            mover_d = torch.zeros(xyz_d.shape[0], dtype=torch.bool, device=self.device)
            m = torch.as_tensor(mover, device=self.device).to(torch.bool)[: xyz_d.shape[0]]
            mover_d[: m.shape[0]] = m  # padded like the scan
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
        self._enqueue(t0, self._last_scan_trunc, self.state.pose, diag)
        rec = None
        lag = 0 if self.sync else max(self.fetch_lag, 0)
        while len(self._pending) > lag:
            rec = self._drain_one()
        return rec

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


def make_pipeline(cfg: PipelineConfig, **kwargs):
    """Pipeline for ``cfg.mode``: ES here; BPF is not ported yet."""
    if cfg.mode == "bpf":
        raise NotImplementedError("the BPF pipeline is not ported yet; see ROADMAP.md (Queue 1, BPF slice)")
    if cfg.mode != "es":
        raise ValueError(f"unknown mode {cfg.mode!r}")
    return ESPipeline(cfg=cfg, **kwargs)
