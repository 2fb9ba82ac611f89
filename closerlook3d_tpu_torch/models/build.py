"""Model factories (``closerlook3d_tpu/models/build.py``), classification.

``spatial_sort="host"`` (the default) means the data pipeline already
Morton-sorted each batch (``data/spatial_host.py``), so the model does not
sort on the device; the device sort of the other modes is not ported yet.
Train or eval mode is the module's own (``model.train()`` /
``model.eval()``): BatchNorm reads it, and so does the head's dropout,
which draws from the generator given to ``forward``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from closerlook3d_tpu_torch.models.backbone import ResNetBackbone
from closerlook3d_tpu_torch.models.heads import ClassifierHead
from closerlook3d_tpu_torch.models.losses import (
    label_smoothing_cross_entropy)
from closerlook3d_tpu_torch.models.nn_utils import BatchNorm


class ClassificationModel(nn.Module):
    """forward(xyz [B,N,3] f32, mask [B,N] bool, features [B,N,D] f32,
    geometry=None, generator=None) -> logits [B, num_classes] f32.

    ``geometry`` is a precomputed ``compute_geometry`` dict; ``generator``
    draws the dropout masks in train mode."""

    def __init__(self, config):
        super().__init__()
        if config.spatial_sort not in ("host", "never"):
            raise NotImplementedError(
                f"spatial_sort={config.spatial_sort!r}: the on-device sort "
                f"(ops/spatial) is not ported yet (ROADMAP A, segmentation)")
        self.backbone = ResNetBackbone(config)
        self.head = ClassifierHead(self.backbone.out_channels,
                                   config.num_classes, config)

    def forward(self, xyz, mask, features, geometry=None, generator=None):
        return self.head(self.backbone(xyz, mask, features,
                                       geometry=geometry),
                         generator=generator)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in flax's defaults: Linear weights lecun-normal
    (std 1/sqrt(fan_in)), Linear biases 0, BN scale 1, bias 0, running
    mean 0, var 1."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            w = torch.randn(mod.weight.shape, generator=generator)
            mod.weight.copy_(w / math.sqrt(mod.in_features))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)


def build_model(cfg, generator: Optional[torch.Generator] = None
                ) -> nn.Module:
    """Build the model for ``cfg.task`` on the CPU, in eval mode, with
    weights drawn from ``generator`` (default: seeded by cfg.rng_seed)."""
    if cfg.task != "classification":
        raise NotImplementedError(
            f"task={cfg.task!r} is not ported yet (ROADMAP A, segmentation)")
    model = ClassificationModel(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.rng_seed))
    init_weights_(model, generator)
    return model.eval()


def build_classification(cfg) -> Tuple[nn.Module, Callable]:
    """(model, loss_fn), as the JAX package's ``build_classification``.

    The model is ``build_model(cfg)``'s: on the CPU, weights seeded by
    ``cfg.rng_seed`` (the JAX package draws them in
    ``create_train_state``); ``train.state.create_train_state`` moves it
    to the card. loss_fn(logits, labels) is label-smoothing CE.
    """
    loss_fn = functools.partial(label_smoothing_cross_entropy,
                                smoothing=cfg.label_smoothing)
    return build_model(cfg), loss_fn
