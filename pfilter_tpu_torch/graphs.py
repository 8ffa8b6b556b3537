"""The compiled frame: a pipeline's steady frame captured once as a CUDA
graph and replayed for every later frame.

The reference package compiles each pipeline's frame once with ``jax.jit``
and replays the compiled program (``pfilter_tpu/pipeline.py:121-124,292-295``).
Run eagerly, the port dispatches some 17,500 small kernels per frame from
Python, one at a time, and the card idles between them.  A CUDA graph
(``torch.cuda.CUDAGraph``) records the frame's kernels once and launches
them all with one call.

:class:`FrameGraphs` keeps one graph per key, as ``jax.jit`` keeps one
program per signature: the pytree structure of the frame's arguments, each
tensor leaf's shape and dtype, and every other leaf's value (the Python int
``opt_count`` of a state, a ``None`` where no mover mask is given).  On a
miss it synchronises the card, runs the frame eagerly on the graph's own
stream (the warm-up, whose result is the frame's result) and captures it;
on a hit it copies the arguments into the graph's static inputs, replays,
and clones the outputs, so that what a caller holds behaves as the immutable
arrays of the reference: a state kept, checkpointed or set between frames
is never written by a later replay.

Nothing falls back to eager execution: a frame that cannot be captured
(an operation that synchronises the host or reads host memory) raises
:class:`CaptureError` naming the operation.  The kernels' wrappers count
their launches in Python (``knn_tiled.KERNEL_LAUNCHES``, ...), as the
map-sharded step's mesh counts its collectives (``Mesh.counts``); a replay
calls no Python, so each graph takes the counts its capture made
(:class:`Counters`) and adds them to the same counters at every replay.

A frame of the map-sharded step holds NCCL collectives, which the graph
captures with the frame's kernels: every rank of a row captures at the same
frame (the key depends on shapes and on ``opt_count``, never on the rank)
and replays the same frames in the same order, so the captured collectives
meet their peers.  Such a frame is captured with
``capture_error_mode="thread_local"``: the process group's watchdog thread
queries the events of earlier collectives while this thread captures, and
under the default ``"global"`` mode such a query can invalidate the
capture.
"""

from __future__ import annotations

import logging
import time
import traceback
from pathlib import Path

import torch
from torch.utils import _pytree as pytree

from pfilter_tpu_torch.ops import knn_tiled, pca_radius

log = logging.getLogger(__name__)

# The kernels' launch counters: (module, attribute).
LAUNCH_COUNTERS = ((knn_tiled, "KERNEL_LAUNCHES"), (knn_tiled, "WORK_LIST_LAUNCHES"), (pca_radius, "KERNEL_LAUNCHES"))
_PACKAGE = Path(__file__).resolve().parent


class CaptureError(RuntimeError):
    """A frame could not be captured as a CUDA graph."""


class Counters:
    """Counters that Python code adds to as it launches work: ``(holder,
    name)`` pairs, the holder a module (the kernels' launch counters) or a
    dict (``Mesh.counts``).  A capture runs no work, so what it counted is
    taken back (:meth:`take_back`) and added again at every replay
    (:meth:`add`)."""

    def __init__(self, pairs=LAUNCH_COUNTERS):
        self.pairs = tuple(pairs)

    def labels(self) -> list:
        return [f"{h.__name__.rsplit('.', 1)[-1]}.{n}" if not isinstance(h, dict) else n for h, n in self.pairs]

    def read(self) -> list:
        return [h[n] if isinstance(h, dict) else getattr(h, n) for h, n in self.pairs]

    def add(self, delta) -> None:
        for (h, n), d in zip(self.pairs, delta):
            if isinstance(h, dict):
                h[n] += d
            else:
                setattr(h, n, getattr(h, n) + d)

    def take_back(self, before: list) -> list:
        """Undo what was counted since ``before`` (a :meth:`read`); returns it."""
        delta = [a - b for a, b in zip(self.read(), before)]
        self.add([-d for d in delta])
        return delta


def signature(args) -> tuple:
    """The key of a frame's arguments, as ``jax.jit``'s: the pytree
    structure, each tensor leaf's shape and dtype, every other leaf's value."""
    leaves, spec = pytree.tree_flatten(args)
    return (spec,) + tuple((x.shape, x.dtype) if isinstance(x, torch.Tensor) else x for x in leaves)


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _where(exc: BaseException) -> str:
    """The operation that broke a capture: the innermost frame of the
    package (outside this module) in the traceback of ``exc`` or of the
    error it was raised while handling, as ``file:line (function): source:
    message``."""
    chain = []
    while exc is not None and exc not in chain:
        chain.append(exc)
        exc = exc.__context__
    for e in reversed(chain):
        frames = [
            f for f in traceback.extract_tb(e.__traceback__)
            if Path(f.filename).resolve().is_relative_to(_PACKAGE) and Path(f.filename).resolve() != Path(__file__).resolve()
        ]
        if frames:
            f = frames[-1]
            return f"{Path(f.filename).resolve().relative_to(_PACKAGE.parent)}:{f.lineno} ({f.name}): {f.line}: {e}"
    return f"outside the package: {chain[0]}"


class _Graph:
    """One captured frame: its static inputs and outputs, and what its
    capture counted (added to ``counters`` at every replay)."""

    def __init__(self, graph, static_in: list, static_out, counters: Counters, counted: list):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.counters, self.counted = counters, counted

    def replay(self, leaves: list):
        for dst, src in zip(self.static_in, leaves):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        self.graph.replay()
        self.counters.add(self.counted)
        return pytree.tree_map(_clone, self.static_out)


class FrameGraphs:
    """The CUDA graphs of one pipeline's frame function, keyed by signature;
    all share one memory pool.  ``captures`` lists every capture made: its
    signature, seconds (warm-up and capture) and what one replay counts.
    ``counters`` are the kernels' launch counters and, for a sharded frame,
    its mesh's collective counts; ``capture_error_mode`` is
    ``torch.cuda.graph``'s (``"thread_local"`` where the frame holds
    collectives: see the module docstring)."""

    def __init__(self, name: str, device: torch.device, counters: Counters = None, capture_error_mode: str = "global"):
        self.name = name
        self.device = device
        self.counters = Counters() if counters is None else counters
        self.capture_error_mode = capture_error_mode
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.captures: list = []
        self.replays = 0
        self._graphs: dict = {}

    def __call__(self, fn, *args):
        """``fn(*args)``: replayed from its graph when one was captured for
        this signature, else run once eagerly and captured."""
        key = signature(args)
        graph = self._graphs.get(key)
        if graph is None:
            out, self._graphs[key] = self._capture(fn, args, key)
            return out
        self.replays += 1
        return graph.replay(pytree.tree_leaves(args))

    def _capture(self, fn, args, key):
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        torch.cuda.synchronize(self.device)
        static_args = pytree.tree_map(_clone, args)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            # The warm-up: this frame's result, and the first use of every
            # library handle, workspace and communicator on the capture stream.
            out = pytree.tree_map(_clone, fn(*static_args))
        before = self.counters.read()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream, capture_error_mode=self.capture_error_mode):
                static_out = fn(*static_args)
        except Exception as exc:
            raise CaptureError(f"{self.name}: the frame cannot be captured as a CUDA graph: {_where(exc)}") from exc
        finally:
            counted = self.counters.take_back(before)  # a capture runs nothing
        current.wait_stream(self.stream)
        torch.cuda.synchronize(self.device)
        record = dict(
            seconds=time.perf_counter() - t0,
            static=[x for x in key[1:] if not isinstance(x, tuple)],
            inputs=[tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args if not isinstance(a, tuple)],
            counted=dict(zip(self.counters.labels(), counted)),
        )
        self.captures.append(record)
        log.info("%s: captured a frame as a CUDA graph (%s)", self.name, record)
        return out, _Graph(graph, pytree.tree_leaves(static_args), static_out, self.counters, counted)
