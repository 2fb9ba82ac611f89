"""Decoder upsampling: nearest-neighbor and inverse-distance 3-NN
interpolation (``closerlook3d_tpu/ops/interpolate.py``).

Both reach ``ops/neighbors.py::knn`` (k = 1 and k = 3), and so its CUDA
kernel on CUDA tensors. The segmentation decoder does not call them on
its served path: the backbone's geometry already holds each stage's 1-NN
upsample indices (``compute_geometry(need_up=True)``), and the decoder
gathers by them.
"""

from __future__ import annotations

from typing import Optional

import torch

from closerlook3d_tpu_torch.ops.grouping import group_features
from closerlook3d_tpu_torch.ops.neighbors import knn

_BIG = 1e9  # below knn's invalid-support bias (1e10)


def three_interpolate(query_xyz: torch.Tensor, support_xyz: torch.Tensor,
                      support_features: torch.Tensor,
                      support_mask: Optional[torch.Tensor] = None,
                      k: int = 3) -> torch.Tensor:
    """Inverse-distance-weighted k-NN feature propagation: [B, Nq, C] from
    support features [B, Ns, C]. Slots backed by masked supports get
    weight 0; weights are normalized over the valid ones."""
    idx, d2 = knn(query_xyz, support_xyz, k, support_mask=support_mask)
    valid = d2 < _BIG
    w = 1.0 / torch.clamp(d2, min=1e-10)
    w = torch.where(valid, w, torch.zeros_like(w))
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-10)
    neigh = group_features(support_features, idx)  # [B, Nq, k, C]
    return (neigh * w[..., None].to(neigh.dtype)).sum(dim=-2)


def nearest_upsample(query_xyz: torch.Tensor, support_xyz: torch.Tensor,
                     support_features: torch.Tensor,
                     support_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Each query point takes its nearest (masked 1-NN) support's
    features: [B, Nq, C]."""
    idx, _ = knn(query_xyz, support_xyz, 1, support_mask=support_mask)
    return group_features(support_features, idx)[:, :, 0, :]
