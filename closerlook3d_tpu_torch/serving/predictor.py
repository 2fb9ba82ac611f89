"""Serving entry point: ``Predictor(cfg, weights, device)``.

Counterpart of ``closerlook3d_tpu/serving/export.py::Predictor``: answers
``predictor(xyz, mask, features) -> logits`` with the eval-mode forward of
the config's task: classification ([B, num_classes]), scene segmentation
([B, N, num_classes]) or part segmentation ([B, N, sum(num_parts)], every
category's parts; the caller takes its category's slice).
Where the JAX predictor replays an exported StableHLO function
(``forward.bin``), this one rebuilds the model from the config and loads
weights; ``forward.bin`` is not read.

``weights`` is one of
  * a port ``state_dict`` (``backbone.stem.linear.weight``, ...);
  * a path to the ``weights.npz`` that ``export_forward`` writes, or the
    dict it holds ('/'-joined ``params/...`` and ``batch_stats/...``
    keys), or the nested flax ``{"params", "batch_stats"}`` dict.
"""

from __future__ import annotations

import os
from typing import Mapping, Union

import numpy as np
import torch

from closerlook3d_tpu_torch.convert import flax_to_state_dict
from closerlook3d_tpu_torch.models.build import build_model

Weights = Union[str, os.PathLike, Mapping]


def _is_flax(weights: Mapping) -> bool:
    return any(k in ("params", "batch_stats") or k.startswith(
        ("params/", "batch_stats/")) for k in weights)


class Predictor:
    """Loaded model on ``device``: ``predictor(xyz, mask, features)``.

    Inputs are array-likes or tensors: xyz [B,N,3] f32, mask [B,N] bool,
    features [B,N,D] f32, already Morton-sorted per cloud the way the data
    loader sorts them (``data/spatial_host.py::morton_sort_batch``); the
    kernels' tie breaks follow the point order, and per-point logits come
    back in it. Returns f32 logits on ``device``: [B, num_classes] for
    classification, [B, N, classes or parts] for segmentation.
    """

    def __init__(self, cfg, weights: Weights, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        model = build_model(cfg)
        if isinstance(weights, (str, os.PathLike)):
            with np.load(weights) as z:
                weights = {k: z[k] for k in z.files}
        if _is_flax(weights):
            state = flax_to_state_dict(weights, model)
        else:
            state = dict(weights)
        model.load_state_dict(state, strict=True)
        self.model = model.to(self.device).eval()

    def __call__(self, xyz, mask, features) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(
                torch.as_tensor(xyz, dtype=torch.float32, device=self.device),
                torch.as_tensor(mask, dtype=torch.bool, device=self.device),
                torch.as_tensor(features, dtype=torch.float32,
                                device=self.device))
