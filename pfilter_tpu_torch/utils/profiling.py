"""Tracing and profiling helpers — port of ``pfilter_tpu/utils/profiling.py``
(the structured replacement for the reference's ``std::chrono`` +
``ROS_INFO`` per-stage prints, ref: src/laserProcessingNode.cpp:71-79,
src/odomEstimationNode.cpp:133-141).

- :class:`StageTimer` — wall-clock per named stage, JSONL emission and
  summary statistics.  With ``sync=True`` a stage whose result holds CUDA
  tensors ends with ``torch.cuda.synchronize``, so the device work it
  launched is charged to it.
- :func:`device_trace` — ``torch.profiler`` around a block, written as a
  Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def _holds_cuda(x) -> bool:
    """Whether ``x`` (a tensor, or a list, tuple, dict or NamedTuple of them)
    holds a CUDA tensor."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_holds_cuda(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_holds_cuda(v) for v in x)
    return False


class StageTimer:
    """Accumulates per-stage wall times; ``sync=True`` waits for the device
    at the end of a stage whose result holds CUDA tensors."""

    def __init__(self, sync: bool = True, jsonl_path: Optional[str] = None):
        self.sync = sync
        self.times = defaultdict(list)
        self._fh = open(jsonl_path, "w") if jsonl_path else None

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        out = {}
        yield out
        if self.sync and _holds_cuda(out.get("result", result)):
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        self.times[name].append(ms)
        if self._fh:
            self._fh.write(json.dumps({"stage": name, "ms": round(ms, 3)}) + "\n")
            self._fh.flush()

    def summary(self) -> dict:
        out = {}
        for name, ts in self.times.items():
            a = np.asarray(ts)
            out[name] = {
                "n": len(a),
                "mean_ms": round(float(a.mean()), 3),
                "p50_ms": round(float(np.percentile(a, 50)), 3),
                "p95_ms": round(float(np.percentile(a, 95)), 3),
                "total_ms": round(float(a.sum()), 3),
            }
        return out

    def report(self) -> str:
        rows = sorted(self.summary().items(), key=lambda kv: -kv[1]["total_ms"])
        lines = [f"{'stage':<28}{'n':>6}{'mean':>10}{'p50':>10}{'p95':>10}{'total':>12}"]
        for name, s in rows:
            lines.append(f"{name:<28}{s['n']:>6}{s['mean_ms']:>10.2f}{s['p50_ms']:>10.2f}{s['p95_ms']:>10.2f}{s['total_ms']:>12.1f}")
        return "\n".join(lines)

    def close(self):
        if self._fh:
            self._fh.close()


@contextlib.contextmanager
def device_trace(log_dir, name: str = "trace.json"):
    """Profile everything run inside the block (the host, and the CUDA device
    where there is one) and write a Chrome trace to ``log_dir/name``:
    ``with device_trace('traces'): pipe.process_frame(...)``."""
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / name))
