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
