"""PCA feature classification into beam/pillar/facade (ref
``nongroundExtract::featureExtract``, include/preProcess.hpp:646-736).

Port of ``pfilter_tpu/ops/pca_classify.py``.  Per point: eigendecompose the
neighbourhood covariance (closed form, ``ops/eig3.eigh3``), take linearity
``(l1-l2)/l1`` and planarity ``(l2-l3)/l1`` with eigenvalues descending (PCL
convention, ref :300-320), then threshold (ref :658-689, :709-721):

- linear > 0.65 and |principal_z| > 0.94          -> pillar
- linear > 0.65 and |principal_z| < 0.17, z > 0.5 -> beam
- elif planar > 0.65 and |normal_z| < 0.34        -> facade

Points need more than ``neigh_k_min`` (8) neighbours to be classified.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pfilter_tpu_torch.config import PCAClassifyConfig
from pfilter_tpu_torch.ops import eig3
from pfilter_tpu_torch.ops.pca_radius import PCAMoments


class ClassifyResult(NamedTuple):
    beam_mask: torch.Tensor  # [N] bool
    pillar_mask: torch.Tensor
    facade_mask: torch.Tensor
    linearity: torch.Tensor  # [N] (diagnostics)
    planarity: torch.Tensor


def classify(xyz, valid, moments: PCAMoments, cfg: PCAClassifyConfig, neigh_k_min: int = 8) -> ClassifyResult:
    evals, evecs = eig3.eigh3(moments.cov)  # ascending
    l1 = torch.clamp(evals[..., 2], min=1e-12)  # largest
    l2 = evals[..., 1]
    l3 = evals[..., 0]
    principal = evecs[..., 2]  # largest-eigenvalue direction
    normal = evecs[..., 0]  # smallest-eigenvalue direction

    linear = (l1 - l2) / l1
    planar = (l2 - l3) / l1

    enough = valid & (moments.count > neigh_k_min)
    pz = torch.abs(principal[..., 2])
    nz = torch.abs(normal[..., 2])
    z = xyz[:, 2]

    is_linear = enough & (linear > cfg.linear_vertical)
    pillar = is_linear & (pz > cfg.dir_z_pillar)
    beam = is_linear & ~pillar & (pz < cfg.dir_z_beam) & (z > cfg.beam_min_z)
    facade = enough & ~is_linear & (planar > cfg.planar_threshold) & (nz < cfg.norm_z_facade)
    zero = torch.zeros_like(linear)
    return ClassifyResult(
        beam_mask=beam,
        pillar_mask=pillar,
        facade_mask=facade,
        linearity=torch.where(enough, linear, zero),
        planarity=torch.where(enough, planar, zero),
    )
