"""Task heads (``closerlook3d_tpu/models/heads.py``).

  * ``ClassifierHead``: masked global average pool over the last stage ->
    ConvBN/dropout tower -> f32 Linear to num_classes logits [B, C];
  * ``SceneSegHead``: the U-Net decoder (``_Decoder``: per stage, nearest
    upsample by the backbone's 1-NN indices, skip concatenation, 1x1
    ConvBN, masked), then ConvBN(width), dropout and an f32 Linear to
    per-point logits [B, N, num_classes];
  * ``MultiPartSegHead``: the same, to one [B, N, sum(num_parts)] logit
    tensor over every category's parts (the category selects its slice
    in the loss and metric).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from closerlook3d_tpu_torch.models.backbone import StageOutput
from closerlook3d_tpu_torch.models.nn_utils import ConvBN, compute_dtype
from closerlook3d_tpu_torch.ops.interpolate import nearest_upsample
from closerlook3d_tpu_torch.parallel.collectives import rows_of_rank, world
from closerlook3d_tpu_torch.utils.config import stage_plan


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
    returns x unchanged.

    In a process group of W processes, where x holds rank r's B rows of a
    global batch of W B, the mask is drawn over the global shape [W B,
    ...] from the generator, which every rank seeds alike, and rank r
    keeps rows [r B, (r + 1) B): the mask of a single process stepping
    the concatenated batch, as the JAX step draws one mask over its
    global array."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit "
                         "torch.Generator")
    keep = 1.0 - rate
    ranks, _ = world()
    n = x.shape[0]
    draw = torch.rand((ranks * n, *x.shape[1:]), generator=generator,
                      device=x.device)[rows_of_rank(n)]
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


class _Decoder(nn.Module):
    """Shared U-Net decoder: coarse-to-fine nearest upsample + skip + 1x1.

    ``convs`` are flax's ``ConvBN_0`` .. in creation order: the first
    decodes into stage nstage-2, the last into stage 0.
    """

    def __init__(self, config):
        super().__init__()
        dt = compute_dtype(config)
        widths = stage_plan(config)["widths"]
        convs = []
        width = widths[-1]
        for s in range(len(widths) - 2, -1, -1):
            convs.append(ConvBN(width + widths[s], widths[s],
                                config.batchnorm_momentum, dtype=dt))
            width = widths[s]
        self.convs = nn.ModuleList(convs)

    def forward(self, stages: List[StageOutput]) -> torch.Tensor:
        x = stages[-1].features
        convs = iter(self.convs)
        for s in range(len(stages) - 2, -1, -1):
            fine = stages[s]
            if fine.up_idx is not None:  # precomputed 1-NN (backbone geometry)
                up = torch.gather(x, 1, fine.up_idx.long()[..., None].expand(
                    -1, -1, x.shape[-1]))
            else:
                up = nearest_upsample(fine.xyz, stages[s + 1].xyz, x,
                                      support_mask=stages[s + 1].mask)
            x = torch.cat([up, fine.features], dim=-1)
            x = next(convs)(x)
            x = x * fine.mask[..., None].to(x.dtype)
        return x  # [B, N0, width]


class _SegHead(nn.Module):
    """Decoder -> ConvBN(width) -> dropout -> f32 Linear to ``outputs``
    per-point logits."""

    def __init__(self, outputs: int, config):
        super().__init__()
        self.decoder = _Decoder(config)
        self.conv = ConvBN(config.width, config.width,
                           config.batchnorm_momentum,
                           dtype=compute_dtype(config))
        self.dropout_rate = float(config.dropout_rate)
        self.fc = nn.Linear(config.width, outputs)

    def forward(self, stages: List[StageOutput],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout mask in train mode."""
        x = self.conv(self.decoder(stages))
        if self.training:
            x = dropout(x, self.dropout_rate, generator)
        return self.fc(x.float())


class SceneSegHead(_SegHead):
    """Per-point class logits [B, N0, num_classes]: ``SceneSegHead(
    num_classes, config)``."""


class MultiPartSegHead(_SegHead):
    """Per-point part logits over the union of all categories' parts,
    [B, N0, sum(num_parts)]; channels are the categories' part ranges in
    order."""

    def __init__(self, num_parts: Sequence[int], config):
        super().__init__(int(sum(num_parts)), config)
        self.num_parts = tuple(int(n) for n in num_parts)
