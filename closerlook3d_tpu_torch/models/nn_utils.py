"""Shared building blocks: 1x1 conv (Linear) + BatchNorm + activation.

Counterparts of ``closerlook3d_tpu/models/nn_utils.py``. Both act on the
last axis of ``[..., C]`` tensors, as flax's ``nn.Dense`` and
``nn.BatchNorm`` do. Parameters are f32; the compute dtype is a
construction argument, as flax's ``dtype=``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the last axis (flax 0.12 numerics).

    ``weight``/``bias`` are flax's ``scale``/``bias`` params,
    ``running_mean``/``running_var`` its ``batch_stats`` mean/var. The
    normalization runs in f32 and the result takes the input's dtype:
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias, as flax computes
    it. ``momentum`` is flax's (0.9 keeps 90% of the running value).

    Train mode (``self.training``) normalizes with the batch statistics,
    taken in f32 over every row of ``[..., C]`` (padding included, as
    flax's unmasked BatchNorm), with flax's fast variance
    max(E[x^2] - E[x]^2, 0), and updates the running statistics with that
    *biased* variance: ra = momentum * ra + (1 - momentum) * stat.
    (``torch.nn.BatchNorm1d`` keeps the unbiased variance instead.)
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            rows = tuple(range(x.ndim - 1))
            mean = x32.mean(dim=rows)
            var = torch.clamp((x32 * x32).mean(dim=rows) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean) * mul + self.bias
        return y.to(x.dtype)


class ConvBN(nn.Module):
    """Linear without bias (1x1 conv) + BatchNorm + optional ReLU."""

    def __init__(self, in_features: int, features: int,
                 bn_momentum: float = 0.9, activation: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = nn.Linear(in_features, features, bias=False)
        self.bn = BatchNorm(features, bn_momentum)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype))
        x = self.bn(x)
        return F.relu(x) if self.activation else x


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.precision == "bf16" else torch.float32
