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

from closerlook3d_tpu_torch.parallel.collectives import (
    all_reduce_sum, distributed)


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

    In a process group of more than one process the statistics are those
    of the global batch, as under the JAX package's data sharding: one
    differentiable all-reduce of [sum x, sum x^2, rows] a layer
    (``parallel/collectives.py::all_reduce_sum``), after which the
    running statistics are equal on every rank.
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
            if distributed():
                c = x.shape[-1]
                sums = all_reduce_sum(torch.cat([
                    x32.sum(dim=rows), (x32 * x32).sum(dim=rows),
                    x32.new_full((1,), x32.numel() // c)]))
                mean = sums[:c] / sums[2 * c]
                ex2 = sums[c:2 * c] / sums[2 * c]
            else:
                mean = x32.mean(dim=rows)
                ex2 = (x32 * x32).mean(dim=rows)
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean) * mul + self.bias
        return y.to(x.dtype)

    @torch.no_grad()
    def update_running(self, mean, var):
        """ra = momentum * ra + (1 - momentum) * stat, for both running
        statistics."""
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


class MaskedBatchNorm(BatchNorm):
    """BatchNorm whose statistics skip masked neighbor slots: the JAX
    package's ``MaskedBatchNorm`` (``_MaskedBNCore``), same parameters and
    running statistics as ``BatchNorm``, in its two modes:

      * ``forward(x, mask)``: x [..., C], mask [...] bool. Train mode takes
        the masked mean and the two-pass masked variance
        sum(m (x - mean)^2) / cnt in f32 (cnt = max(valid count, 1));
        returns x * eff_scale + eff_bias in the module's dtype;
      * ``stats_affine(mean, var)``: (eff_scale, eff_bias) for statistics
        computed elsewhere (the factorized point-wise MLP's analytic ones;
        ignored, and may be None, in eval mode).

    Train mode is ``self.training``; only it updates the running
    statistics, with flax's momentum convention. In a process group of
    more than one process, ``forward``'s statistics are the global
    batch's: one all-reduce of [sum m x, sum m] for the mean, one of
    sum m (x - mean)^2 for the variance. eff_scale = scale *
    rsqrt(var + eps) and eff_bias = bias - mean * eff_scale are computed in
    f32 and cast to ``dtype``.
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__(features, momentum, eps)
        self.dtype = dtype

    def stats_affine(self, mean=None, var=None):
        if self.training:
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        eff_scale = self.weight * torch.rsqrt(var + self.eps)
        eff_bias = self.bias - mean * eff_scale
        return eff_scale.to(self.dtype), eff_bias.to(self.dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        mean = var = None
        if self.training:
            m = mask[..., None].float()
            x32 = x.float()
            rows = tuple(range(x.ndim - 1))
            if distributed():
                c = x.shape[-1]
                sums = all_reduce_sum(torch.cat([
                    (x32 * m).sum(dim=rows), m.sum().reshape(1)]))
                cnt = torch.clamp(sums[c], min=1.0)
                mean = sums[:c] / cnt
                var = all_reduce_sum(
                    (m * (x32 - mean) ** 2).sum(dim=rows)) / cnt
            else:
                cnt = torch.clamp(m.sum(), min=1.0)
                mean = (x32 * m).sum(dim=rows) / cnt
                var = (m * (x32 - mean) ** 2).sum(dim=rows) / cnt
        eff_scale, eff_bias = self.stats_affine(mean, var)
        return x * eff_scale + eff_bias


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
