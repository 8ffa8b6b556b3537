"""PyTorch/CUDA port of the PFilter LiDAR odometry engine.

The package mirrors ``pfilter_tpu``'s layout (``ops/``, ``models/``,
``utils/``, ``pipeline.py``, ``config.py``) so every module has its
counterpart under the same name.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``; on a CUDA tensor each hand-written kernel
launches (``csrc/``), on a CPU tensor its plain PyTorch version runs.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU only when
    asked for by name.  Raises when CUDA is wanted and absent — an entry
    point never falls back to the CPU on its own."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pfilter_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


def host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A zeroed host tensor that stages data for ``device``: in pinned memory
    when ``device`` is a CUDA device, so that :func:`upload` need not wait."""
    return torch.zeros(shape, dtype=dtype, pin_memory=device.type == "cuda")


def upload(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``, without a host wait where ``x`` is in host memory
    and ``device`` a CUDA device.  A copy from pageable memory synchronises the
    stream, so ``x`` is first staged in pinned memory (unless it is pinned
    already) and copied up with ``non_blocking=True``.  PyTorch's pinned-memory
    cache records that copy on the stream and hands the buffer out again only
    once the copy is done, so no buffer in flight is ever reused."""
    if device.type != "cuda" or x.device.type != "cpu":
        return x.to(device)
    if not x.is_pinned():
        x = torch.empty_like(x, pin_memory=True).copy_(x)
    return x.to(device, non_blocking=True)
