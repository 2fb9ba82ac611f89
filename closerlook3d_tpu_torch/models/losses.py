"""Losses (``closerlook3d_tpu/models/losses.py``): classification.

The segmentation losses (masked and multi-shape cross-entropy) are not
ported yet (ROADMAP A, segmentation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE with label smoothing, in f32. logits [B, C], labels [B] int."""
    logits = logits.float()
    nclass = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), nclass).float()
    if smoothing > 0.0:
        onehot = onehot * (1.0 - smoothing) + smoothing / nclass
    return -(onehot * logp).sum(dim=-1).mean()
