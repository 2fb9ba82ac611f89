"""Classification head (``closerlook3d_tpu/models/heads.py``).

Masked global average pool over the last stage -> ConvBN/dropout tower
-> f32 Linear to num_classes logits. The segmentation heads are not
ported yet (ROADMAP A).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from closerlook3d_tpu_torch.models.backbone import StageOutput
from closerlook3d_tpu_torch.models.nn_utils import ConvBN, compute_dtype


def masked_global_avg_pool(features: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None].to(features.dtype)
    total = (features * m).sum(dim=1)
    count = torch.clamp(m.sum(dim=1), min=1.0)
    return total / count


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout`` in train mode: keep each value with probability
    1 - rate and scale it by 1 / (1 - rate). The keep mask is drawn from
    ``generator`` (on x's device), never from the global RNG; rate 0
    returns x unchanged."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit "
                         "torch.Generator")
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


class ClassifierHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, config):
        super().__init__()
        dt = compute_dtype(config)
        convs = []
        for width in config.cls_head_dims:
            convs.append(ConvBN(in_channels, width,
                                config.batchnorm_momentum, dtype=dt))
            in_channels = width
        self.convs = nn.ModuleList(convs)
        self.dropout_rate = float(config.dropout_rate)
        self.fc = nn.Linear(in_channels, num_classes)

    def forward(self, stages: List[StageOutput],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in train mode."""
        x = masked_global_avg_pool(stages[-1].features, stages[-1].mask)
        for conv in self.convs:
            x = conv(x)
            if self.training:
                x = dropout(x, self.dropout_rate, generator)
        return self.fc(x.float())
