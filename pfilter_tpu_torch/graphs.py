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
their launches in Python (``knn_tiled.KERNEL_LAUNCHES``, ...); a replay
calls no Python, so each graph counts the launches of its capture and adds
them to the same counters at every replay.
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


def _counts() -> list:
    return [getattr(mod, name) for mod, name in LAUNCH_COUNTERS]


def _add_counts(delta) -> None:
    for (mod, name), d in zip(LAUNCH_COUNTERS, delta):
        setattr(mod, name, getattr(mod, name) + d)


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
    """One captured frame: its static inputs and outputs and the kernel
    launches of one replay."""

    def __init__(self, graph, static_in: list, static_out, launches: list):
        self.graph, self.static_in, self.static_out, self.launches = graph, static_in, static_out, launches

    def replay(self, leaves: list):
        for dst, src in zip(self.static_in, leaves):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        self.graph.replay()
        _add_counts(self.launches)
        return pytree.tree_map(_clone, self.static_out)


class FrameGraphs:
    """The CUDA graphs of one pipeline's frame function, keyed by signature;
    all share one memory pool.  ``captures`` lists every capture made: its
    signature, seconds (warm-up and capture) and kernel launches per replay."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.captures: list = []
        self.replays = 0
        self._graphs: dict = {}

    def __call__(self, fn, *args):
        """``fn(*args)``: replayed from its graph when one was captured for
        this signature, else run once eagerly and captured."""
        leaves, spec = pytree.tree_flatten(args)
        key = (spec,) + tuple((x.shape, x.dtype) if isinstance(x, torch.Tensor) else x for x in leaves)
        graph = self._graphs.get(key)
        if graph is None:
            out, self._graphs[key] = self._capture(fn, args, key)
            return out
        self.replays += 1
        return graph.replay(leaves)

    def _capture(self, fn, args, key):
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        torch.cuda.synchronize(self.device)
        static_args = pytree.tree_map(_clone, args)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            # The warm-up: this frame's result, and the first use of every
            # library handle and workspace on the capture stream.
            out = pytree.tree_map(_clone, fn(*static_args))
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                static_out = fn(*static_args)
        except Exception as exc:
            raise CaptureError(f"{self.name}: the frame cannot be captured as a CUDA graph: {_where(exc)}") from exc
        finally:
            launches = [a - b for a, b in zip(_counts(), before)]
            _add_counts([-d for d in launches])  # a capture launches nothing
        current.wait_stream(self.stream)
        torch.cuda.synchronize(self.device)
        record = dict(
            seconds=time.perf_counter() - t0,
            static=[x for x in key[1:] if not isinstance(x, tuple)],
            inputs=[tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args if not isinstance(a, tuple)],
            launches={f"{mod.__name__.rsplit('.', 1)[-1]}.{name}": d for (mod, name), d in zip(LAUNCH_COUNTERS, launches)},
        )
        self.captures.append(record)
        log.info("%s: captured a frame as a CUDA graph (%s)", self.name, record)
        return out, _Graph(graph, pytree.tree_leaves(static_args), static_out, launches)
