"""Model factories (``closerlook3d_tpu/models/build.py``): classification,
scene segmentation and part segmentation.

``spatial_sort`` as the JAX package's ``_maybe_sort`` reads it: "host"
(the default) means the data pipeline already Morton-sorted each batch
(``data/spatial_host.py``) and "never" that nothing sorts, so the model
does not; "always", and "auto" above 2048 points a cloud, sort each cloud
on the inputs' device (``ops/spatial.py::morton_sort``), and the
segmentation models return their per-point logits in the caller's order.
Precomputed geometry binds indices to the caller's order: with it the
model never sorts. Train or eval mode is
the module's own (``model.train()`` / ``model.eval()``): BatchNorm reads
it, and so does the head's dropout, which draws from the generator given
to ``forward``. Each task's factory returns (model, loss_fn) as the JAX
package's does; ``build_model`` gives the model alone, for serving.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from closerlook3d_tpu_torch.data.shapenetpart import NUM_PARTS
from closerlook3d_tpu_torch.models.backbone import ResNetBackbone
from closerlook3d_tpu_torch.models.heads import (
    ClassifierHead, MultiPartSegHead, SceneSegHead)
from closerlook3d_tpu_torch.models.losses import (
    label_smoothing_cross_entropy, masked_cross_entropy,
    multi_shape_cross_entropy)
from closerlook3d_tpu_torch.models.nn_utils import BatchNorm
from closerlook3d_tpu_torch.ops.spatial import apply_permutation, morton_sort
from closerlook3d_tpu_torch.utils.config import stage_plan


def sorts_on_device(mode: str, n_points: int) -> bool:
    """Whether ``spatial_sort`` = ``mode`` sorts ``n_points``-point clouds
    in the model: "host" and "never" never, "auto" above 2048 points,
    "always" always."""
    if mode not in ("host", "never", "auto", "always"):
        raise ValueError(f"unknown spatial_sort {mode!r}")
    return mode == "always" or (mode == "auto" and n_points > 2048)


class _Model(nn.Module):
    """forward(xyz [B,N,3] f32, mask [B,N] bool, features [B,N,D] f32,
    geometry=None, generator=None) -> the head's f32 logits.

    ``geometry`` is a precomputed ``compute_geometry`` dict (with the
    upsample indices for segmentation); ``generator`` draws the dropout
    masks in train mode. Where ``spatial_sort`` sorts (and no geometry is
    given), the clouds are Morton-sorted first; per-point logits go back
    through the inverse permutation."""

    per_point = False  # logits [B, N, ...] follow the points' order

    def __init__(self, config, head: nn.Module):
        super().__init__()
        self.spatial_sort = config.spatial_sort
        self.backbone = ResNetBackbone(config)
        self.head = head

    def forward(self, xyz, mask, features, geometry=None, generator=None):
        inv = None
        if geometry is None and sorts_on_device(self.spatial_sort,
                                                xyz.shape[1]):
            perm, inv = morton_sort(xyz, mask)
            xyz, mask, features = (apply_permutation(t, perm)
                                   for t in (xyz, mask, features))
        logits = self.head(self.backbone(xyz, mask, features,
                                         geometry=geometry),
                           generator=generator)
        if inv is not None and self.per_point:
            logits = apply_permutation(logits, inv)
        return logits


class ClassificationModel(_Model):
    """Logits [B, num_classes]."""

    def __init__(self, config):
        super().__init__(config, ClassifierHead(
            stage_plan(config)["widths"][-1], config.num_classes, config))


class SceneSegModel(_Model):
    """Per-point logits [B, N, num_classes]."""

    per_point = True

    def __init__(self, config):
        super().__init__(config, SceneSegHead(config.num_classes, config))


class MultiPartSegModel(_Model):
    """Per-point part logits [B, N, sum(num_parts)] over every category's
    parts (``part_counts``)."""

    per_point = True

    def __init__(self, config):
        super().__init__(config, MultiPartSegHead(part_counts(config),
                                                  config))


def part_counts(config) -> list:
    """Per-category part counts: ``num_parts``, as the dataset factory
    (``data/build.py::build_dataset``) sets it, or ShapeNetPart's table
    for a config that names that dataset without them."""
    if list(config.num_parts):
        return [int(n) for n in config.num_parts]
    if config.datasets == "shapenetpart":
        return list(NUM_PARTS)
    raise ValueError(f"part segmentation on {config.datasets!r} needs "
                     f"num_parts in the config, which "
                     f"data.build.build_dataset(cfg, split) sets")


_MODELS = {"classification": ClassificationModel,
           "scene_segmentation": SceneSegModel,
           "part_segmentation": MultiPartSegModel}


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
    if cfg.task not in _MODELS:
        raise ValueError(f"unknown task: {cfg.task}")
    model = _MODELS[cfg.task](cfg)
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


def build_scene_segmentation(cfg) -> Tuple[nn.Module, Callable]:
    """(model, loss_fn), as the JAX package's: loss_fn(logits [B,N,C],
    labels [B,N], mask [B,N]) is the masked CE with the config's label
    smoothing (labels -1 ignored)."""
    loss_fn = functools.partial(masked_cross_entropy,
                                smoothing=cfg.label_smoothing)
    return build_model(cfg), loss_fn


def build_multi_part_segmentation(cfg) -> Tuple[nn.Module, Callable]:
    """(model, loss_fn), as the JAX package's: loss_fn(logits [B,N,P],
    labels [B,N] global part ids, category [B], mask [B,N]) is the
    multi-shape CE over ``part_counts(cfg)`` with the config's label
    smoothing."""
    loss_fn = functools.partial(multi_shape_cross_entropy,
                                num_parts=tuple(part_counts(cfg)),
                                smoothing=cfg.label_smoothing)
    return build_model(cfg), loss_fn


_BUILDERS = {"classification": build_classification,
             "scene_segmentation": build_scene_segmentation,
             "part_segmentation": build_multi_part_segmentation}


def build_model_and_loss(cfg) -> Tuple[nn.Module, Callable]:
    """(model, loss_fn) for ``cfg.task`` (the JAX package's
    ``build_model``)."""
    if cfg.task not in _BUILDERS:
        raise ValueError(f"unknown task: {cfg.task}")
    return _BUILDERS[cfg.task](cfg)
