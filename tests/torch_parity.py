"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``):
the same numpy inputs go through a ``pfilter_tpu`` function and its
``pfilter_tpu_torch`` counterpart, on the CPU."""

import dataclasses

import numpy as np
import torch

from pfilter_tpu_torch import config as tconfig

# The suite runs several worker processes at once; one intra-op thread per
# worker keeps torch from oversubscribing the cores the JAX tests share, and
# makes the CPU segment sums (index_put_ with accumulate) run serially.
torch.set_num_threads(1)


def torch_config(cfg):
    """The port's PipelineConfig with every field of a reference-package one."""
    kwargs = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kwargs[f.name] = torch_config(v) if dataclasses.is_dataclass(v) else v
    return getattr(tconfig, type(cfg).__name__)(**kwargs)


def tiny_config():
    """(reference config, port config) at the widths of
    ``__graft_entry__._tiny_config``: 16 beams, 512 azimuth, small maps."""
    import __graft_entry__

    cfg = __graft_entry__._tiny_config()
    return cfg, torch_config(cfg)


def t(x):
    """numpy (or jax) array -> CPU tensor."""
    return torch.from_numpy(np.array(x))


def n(x):
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rotation_angle(q1, q2):
    """Angle (rad) of the relative rotation between wxyz quaternions, per row."""
    a, b = np.asarray(q1, np.float64), np.asarray(q2, np.float64)
    w = np.sum(a * b, axis=-1)  # real part of conj(a) * b
    v = a[..., :1] * b[..., 1:] - b[..., :1] * a[..., 1:] - np.cross(a[..., 1:], b[..., 1:])
    return 2.0 * np.arctan2(np.linalg.norm(v, axis=-1), np.abs(w))
