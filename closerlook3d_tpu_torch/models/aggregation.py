"""Local aggregation: PosPool and adaptive weight.

Counterpart of ``closerlook3d_tpu/models/aggregation.py::LocalAggregation``.
For query i with padded neighborhood N(i), dp_ij = (p_j - p_i) / r and

  * PosPool (parameter-free): the xyz embedding scales channel third d of
    f_j by dp_ij[d]; the sin/cos embedding multiplies f_j by a sinusoidal
    embedding of dp_ij; then a masked avg or sum (``ops/aggregation.py``);
  * adaptive weight: a small MLP on [dp | f_j | f_j - f_i] predicts a
    per-neighbor weight vector (optionally softmax-normalized over the
    neighborhood, optionally shared across channel groups), then a
    weighted masked reduction. The paper's default (one linear FC on dp,
    no softmax, avg|sum) factorizes exactly through the neighborhood
    moments (``ops/moments.py``); every other setting takes the gather
    path in plain PyTorch, as in the JAX package, which has no kernel for
    it.

Point-wise MLP, pseudo-grid and PosPool's max reduction are not ported
yet (ROADMAP A).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from closerlook3d_tpu_torch.models.nn_utils import ConvBN
from closerlook3d_tpu_torch.ops.aggregation import (
    CHANNEL_MULTIPLE, pospool_fused)
from closerlook3d_tpu_torch.ops.grouping import (
    REDUCTIONS, group_features, neighbor_offsets)
from closerlook3d_tpu_torch.ops.moments import neighborhood_moments


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A, "
                               f"remaining operators)")


class LocalAggregation(nn.Module):
    """forward(query_xyz, support_xyz, support_features, neighbor_idx,
    neighbor_mask) -> [B, Nq, out_channels].

    Submodules in flax's creation order (``convert.py`` relies on it):
    ``weight_convs`` (the adaptive gather path's ConvBNs, ``ConvBN_0`` ..
    ``ConvBN_{fc_num-2}``), ``dense`` (its ``Dense_0``), ``output_conv``
    (the next ``ConvBN``).
    """

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kind = config.local_aggregation_type
        self.radius = float(radius)
        self.dtype = dtype
        self.weight_convs = nn.ModuleList()
        self.dense = None
        self.factorized = False
        if self.kind == "pospool":
            p = config.pospool
            if p.position_embedding not in CHANNEL_MULTIPLE:
                raise ValueError(f"unknown PosPool position embedding: "
                                 f"{p.position_embedding!r}")
            multiple = CHANNEL_MULTIPLE[p.position_embedding]
            if in_channels % multiple != 0:
                raise ValueError(f"{p.position_embedding} PosPool needs "
                                 f"channels % {multiple} == 0")
            if p.reduction not in ("avg", "sum"):
                raise _not_ported(f"PosPool reduction={p.reduction!r}")
        elif self.kind == "adaptive_weight":
            p = config.adaptive_weight
            if in_channels % p.shared_channels != 0:
                raise ValueError("adaptive weight needs channels % "
                                 "shared_channels == 0")
            cw = in_channels // p.shared_channels
            self.factorized = (p.local_input_feature == "dp"
                               and p.fc_num == 1 and not p.weight_softmax
                               and p.reduction in ("avg", "sum"))
            fan_in = (3 + in_channels * ("fi" in p.local_input_feature)
                      + in_channels * ("df" in p.local_input_feature))
            for _ in range(max(p.fc_num - 1, 0)):
                self.weight_convs.append(ConvBN(
                    fan_in, cw, config.batchnorm_momentum, dtype=dtype))
                fan_in = cw
            self.dense = nn.Linear(fan_in, cw)
        else:
            raise _not_ported(f"local_aggregation_type={self.kind!r}")
        self.p = p
        # the JAX module's _maybe_output_conv
        self.output_conv = None
        if p.output_conv or in_channels != out_channels:
            self.output_conv = ConvBN(in_channels, out_channels,
                                      config.batchnorm_momentum, dtype=dtype)

    def forward(self, query_xyz, support_xyz, support_features, neighbor_idx,
                neighbor_mask):
        q, s = query_xyz.float(), support_xyz.float()
        if self.kind == "pospool":
            out = pospool_fused(q, s, support_features, neighbor_idx,
                                neighbor_mask, self.radius,
                                self.p.position_embedding, self.p.reduction)
        elif self.factorized:
            out = self._adaptive_factorized(q, s, support_features,
                                            neighbor_idx, neighbor_mask)
        else:
            out = self._adaptive_gather(q, s, support_features, neighbor_idx,
                                        neighbor_mask)
        if self.output_conv is not None:
            out = self.output_conv(out)
        return out

    def _expand(self, v):
        """[.., C/shared] -> [.., C]: channel c uses weight c // shared."""
        shared = self.p.shared_channels
        return v.repeat_interleave(shared, dim=-1) if shared > 1 else v

    def _adaptive_factorized(self, q, s, f, idx, mask):
        """y = R_k((W dp + b) * f) = b * R(f) + sum_d W_d * R(dp_d f).

        The Linear is read as flax reads its Dense through the basis
        [0; I3] in the compute dtype (wb = dense(basis): row 0 is b, row
        1 + d is W_d + b rounded once; then W_d = wb[1 + d] - wb[0]), so a
        bf16 model rounds as flax does.
        """
        dt = self.dtype
        bias = self.dense.bias.to(dt)  # [C/shared]
        wd = (self.dense.weight.to(dt).t() + bias) - bias  # [3, C/shared]
        m0, mx, my, mz = neighborhood_moments(
            q, s, f, idx, mask, self.radius, self.p.reduction).chunk(4, -1)
        return (self._expand(bias) * m0 + self._expand(wd[0]) * mx
                + self._expand(wd[1]) * my + self._expand(wd[2]) * mz)

    def _adaptive_gather(self, q, s, f_support, idx, mask):
        """The JAX package's gather path (``_adaptive_weight``)."""
        lif = self.p.local_input_feature
        f = group_features(f_support, idx)  # [B, Nq, K, C]
        parts = [neighbor_offsets(q, s, idx, self.radius, f.dtype)]
        if "fi" in lif:
            parts.append(f)
        if "df" in lif:
            parts.append(f - f[:, :, :1, :])
        h = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        for conv in self.weight_convs:
            h = conv(h)
        dt = self.dtype
        w = F.linear(h.to(dt), self.dense.weight.to(dt),
                     self.dense.bias.to(dt))
        if self.p.weight_softmax:
            w32 = w.float().masked_fill(~mask[..., None], -1e9)
            w = torch.softmax(w32, dim=2).to(f.dtype)
        return REDUCTIONS[self.p.reduction](self._expand(w) * f, mask)
