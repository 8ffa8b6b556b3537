"""The seq x map grid of the map-sharded step, one process per cell.

Port of ``pfilter_tpu/parallel/mesh.py``.  The reference runs the whole grid
in one program (``jax.shard_map`` over ``Mesh(devices, ("seq", "map"))``);
here every cell is a process of the default ``torch.distributed`` group:

- rank ``r`` holds sequence row ``r // n_map`` and map shard ``r % n_map``;
- each sequence row has one map group (its ``n_map`` ranks, in rank order),
  over which the step's collectives run; the seq axis carries no
  communication;
- NCCL on CUDA devices, gloo on the CPU.

:class:`Mesh` runs the four collectives of the step (``all_gather``,
``psum``, ``pmin``, ``pmax``, named as the reference's ``lax`` ones) over
its map group and counts them.  A group of one rank still calls the
backend: no collective is skipped at ``n_map == 1``.  On a card the
pipelines capture the step's collectives in their frame's CUDA graph
(``graphs.py``), which adds the counts of its capture at every replay.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from pfilter_tpu_torch import resolve_device


def factor_devices(n: int, max_map: int = 4):
    """Split n devices into (n_seq, n_map) with n_map a power-of-two <= max_map."""
    n_map = 1
    while n_map * 2 <= max_map and n % (n_map * 2) == 0:
        n_map *= 2
    return n // n_map, n_map


class Mesh:
    """This rank's cell of the seq x map grid: its indices, its map group, its
    device, and the collectives over that group.  ``counts`` holds the
    collectives run so far, by kind (``all_gather``, ``all_reduce``)."""

    def __init__(self, n_seq: int, n_map: int, seq_index: int, map_index: int, group, device: torch.device):
        self.n_seq, self.n_map = n_seq, n_map
        self.seq_index, self.map_index = seq_index, map_index
        self.group = group
        self.device = device
        self.counts = {"all_gather": 0, "all_reduce": 0}
        self._communicating = False  # a collective of this mesh has run eagerly

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def reset_counts(self) -> None:
        for kind in self.counts:
            self.counts[kind] = 0

    def query_slice(self, q: int) -> slice:
        """This shard's contiguous block of ``q`` queries (``q // n_map`` of
        them).  Raises unless ``n_map`` divides ``q`` (a downsample capacity),
        as the reference's shapes would fail."""
        if q % self.n_map:
            raise ValueError(f"{q} queries do not split into n_map={self.n_map} equal slices")
        qs = q // self.n_map
        return slice(self.map_index * qs, (self.map_index + 1) * qs)

    def counters(self) -> list:
        """``counts`` as the ``(holder, name)`` pairs of ``graphs.Counters``."""
        return [(self.counts, kind) for kind in self.counts]

    def _run(self, kind: str, collective, *args, **kwargs) -> None:
        """Run and count one collective.  Inside a CUDA graph capture the
        group's communicator must exist already: NCCL makes it at a group's
        first collective, which cannot be captured, so a capture before any
        eager collective of this mesh raises instead of hanging."""
        capturing = self.device.type == "cuda" and torch.cuda.is_current_stream_capturing()
        if capturing and not self._communicating:
            raise RuntimeError(f"{kind}: no collective of this mesh has run eagerly, so its communicator may not exist; run a frame eagerly before capturing one")
        collective(*args, group=self.group, **kwargs)
        self._communicating = self._communicating or not capturing
        self.counts[kind] += 1

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of every rank of the map group, stacked on a new leading axis
        in map-rank order (the layout of ``lax.all_gather``), gathered into
        one tensor (NCCL captures this form in a CUDA graph; gloo takes it
        too).  The step packs what it gathers into float32 (gloo has no bool
        collectives)."""
        x = x.contiguous()
        out = torch.empty((self.n_map * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        self._run("all_gather", dist.all_gather_into_tensor, out, x)
        return out.view((self.n_map,) + tuple(x.shape))

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.clone(memory_format=torch.contiguous_format)
        self._run("all_reduce", dist.all_reduce, y, op=op)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)


def local_rank() -> int:
    """The rank's index among the processes of its host: ``LOCAL_RANK`` as
    ``torchrun`` sets it, else the global rank modulo the host's CUDA cards
    (0 on a host without any)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return dist.get_rank() % n if n else 0


def make_mesh(n_seq: int, n_map: int, device=None) -> Mesh:
    """This rank's :class:`Mesh` over the initialised default process group,
    whose size must be ``n_seq * n_map``.  Every rank creates every row's map
    group, in the same order.  The device is ``cuda:<local rank>`` unless the
    caller names one (``"cpu"`` for a gloo group)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed default group")
    world = dist.get_world_size()
    if world != n_seq * n_map:
        raise ValueError(f"world size {world} != n_seq * n_map = {n_seq} * {n_map}")
    rank = dist.get_rank()
    groups = [dist.new_group(list(range(s * n_map, (s + 1) * n_map))) for s in range(n_seq)]
    dev = resolve_device(f"cuda:{local_rank()}" if device is None else device)
    return Mesh(n_seq, n_map, rank // n_map, rank % n_map, groups[rank // n_map], dev)
