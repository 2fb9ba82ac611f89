"""Local aggregation: PosPool, adaptive weight, point-wise MLP and
pseudo-grid.

Counterpart of ``closerlook3d_tpu/models/aggregation.py::LocalAggregation``.
For query i with padded neighborhood N(i), dp_ij = (p_j - p_i) / r and

  * PosPool (parameter-free): the xyz embedding scales channel third d of
    f_j by dp_ij[d]; the sin/cos embedding multiplies f_j by a sinusoidal
    embedding of dp_ij; then a masked avg or sum (``ops/aggregation.py``),
    or a masked max on the gather path (the JAX package has no kernel for
    it);
  * adaptive weight: a small MLP on [dp | f_j | f_j - f_i] predicts a
    per-neighbor weight vector (optionally softmax-normalized over the
    neighborhood, optionally shared across channel groups), then a
    weighted masked reduction. The paper's default (one linear FC on dp,
    no softmax, avg|sum) factorizes exactly through the neighborhood
    moments (``ops/moments.py``); every other setting takes the gather
    path in plain PyTorch, as in the JAX package, which has no kernel for
    it;
  * point-wise MLP: FC -> masked BatchNorm -> ReLU layers on
    [dp | f_j | f_j - f_i] per neighbor, then a masked reduction. The
    paper's best setting (one FC, max) factorizes into per-point
    projections and the neighborhood min/max kernels
    (``ops/gather_reduce.py``); every other setting takes the gather path
    in plain PyTorch;
  * pseudo-grid (KPConv-style): the neighbor features are distributed
    onto Kp fixed kernel points by an influence of |dp - kp| (linear,
    constant or gaussian; ``ops/pseudo_grid.py``, on every setting, as
    the JAX package sends every setting to its kernel), then one
    ``[Kp*C, C_out]`` weight matmul, then sum or avg over the
    neighborhood (``convolution_mode``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from closerlook3d_tpu_torch.models.nn_utils import ConvBN, MaskedBatchNorm
from closerlook3d_tpu_torch.ops.aggregation import (
    CHANNEL_MULTIPLE, pospool_fused, sinusoidal_embedding)
from closerlook3d_tpu_torch.ops.gather_reduce import (
    gather_sub_minmax, pwmlp_minmax_stats)
from closerlook3d_tpu_torch.ops.grouping import (
    REDUCTIONS, group_features, neighbor_offsets)
from closerlook3d_tpu_torch.ops.moments import neighborhood_moments
from closerlook3d_tpu_torch.ops.pseudo_grid import (
    INFLUENCE_MODES, pseudo_grid_fused)
from closerlook3d_tpu_torch.parallel.collectives import (
    all_reduce_sum, distributed, world)


@functools.lru_cache(maxsize=None)
def kernel_point_layout(num_points: int, fixed: str = "center",
                        seed: int = 0) -> np.ndarray:
    """Deterministic kernel-point disposition in the unit ball, [K, 3]
    float32 with max norm 1: a copy of the JAX package's
    ``models/aggregation.py::kernel_point_layout`` (the same seeded
    repulsion in numpy, so the same array), cached per (K, fixed)."""
    rng = np.random.default_rng(seed)
    k = num_points
    pts = rng.normal(size=(k, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True) + 1e-9
    pts *= rng.uniform(0.3, 1.0, size=(k, 1))
    if fixed == "center":
        pts[0] = 0.0
    lr = 0.01
    for _ in range(400):
        diff = pts[:, None, :] - pts[None, :, :]  # [K, K, 3]
        d = np.linalg.norm(diff, axis=-1) + 1e-9
        np.fill_diagonal(d, np.inf)
        force = (diff / d[..., None] ** 3).sum(axis=1)  # repulsion
        pts = pts + lr * force
        if fixed == "center":
            pts[0] = 0.0
        norms = np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-9)
        pts = np.where(norms > 1.0, pts / norms, pts)  # confine to ball
    scale = np.abs(pts).max() if k == 1 else np.linalg.norm(pts, axis=1).max()
    return (pts / max(scale, 1e-9)).astype(np.float32)


def _typical_spacing(kp: np.ndarray) -> float:
    """Mean nearest-neighbor distance among kernel points (the influence
    scale), as the JAX package computes it."""
    if kp.shape[0] < 2:
        return 1.0
    d = np.linalg.norm(kp[:, None] - kp[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    return float(d.min(axis=1).mean())


class LocalAggregation(nn.Module):
    """forward(query_xyz, support_xyz, support_features, neighbor_idx,
    neighbor_mask) -> [B, Nq, out_channels]. Train mode (the point-wise
    MLP's masked BatchNorm) is ``self.training``.

    Submodules in flax's creation order (``convert.py`` relies on it):
    ``weight_convs`` (the adaptive gather path's ConvBNs, ``ConvBN_0`` ..
    ``ConvBN_{fc_num-2}``), ``dense`` (its ``Dense_0``), ``pw_linears`` and
    ``pw_bns`` (the point-wise MLP's ``pw_kernel_i`` and ``pw_bn_i``),
    ``kernel_weights`` (the pseudo-grid's ``[Kp*C, C_out]`` param, as a
    bias-free Linear), ``output_conv`` (the next ``ConvBN``). The
    pseudo-grid's kernel points are a buffer outside the ``state_dict``.
    """

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kind = config.local_aggregation_type
        self.radius = float(radius)
        self.dtype = dtype
        self.weight_convs = nn.ModuleList()
        self.dense = None
        self.pw_linears = nn.ModuleList()
        self.pw_bns = nn.ModuleList()
        self.kernel_weights = None
        self.factorized = False
        out_width = in_channels  # before the output conv
        if self.kind == "pospool":
            p = config.pospool
            if p.position_embedding not in CHANNEL_MULTIPLE:
                raise ValueError(f"unknown PosPool position embedding: "
                                 f"{p.position_embedding!r}")
            multiple = CHANNEL_MULTIPLE[p.position_embedding]
            if in_channels % multiple != 0:
                raise ValueError(f"{p.position_embedding} PosPool needs "
                                 f"channels % {multiple} == 0")
            if p.reduction not in REDUCTIONS:
                raise ValueError(f"unknown reduction {p.reduction!r}")
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
        elif self.kind == "pointwisemlp":
            p = config.pointwisemlp
            if p.reduction not in REDUCTIONS:
                raise ValueError(f"unknown reduction {p.reduction!r}")
            # the JAX gate _use_fused_pointwisemlp, on every device
            self.factorized = p.num_mlps == 1 and p.reduction == "max"
            ft = p.feature_type
            fan_in = (3 * ("dp" in ft) + in_channels * ("fi" in ft)
                      + in_channels * ("df" in ft))
            for _ in range(p.num_mlps):
                self.pw_linears.append(nn.Linear(fan_in, out_channels,
                                                 bias=False))
                # the factorized path's BN is f32, the gather path's takes
                # the model dtype, as in the JAX package
                self.pw_bns.append(MaskedBatchNorm(
                    out_channels, config.batchnorm_momentum,
                    dtype=torch.float32 if self.factorized else dtype))
                fan_in = out_channels
            out_width = out_channels
        elif self.kind == "pseudo_grid":
            p = config.pseudo_grid
            if p.KP_influence not in INFLUENCE_MODES:
                raise ValueError(f"unknown KP_influence {p.KP_influence!r}")
            if p.convolution_mode not in ("sum", "avg"):
                raise ValueError(f"unknown convolution_mode "
                                 f"{p.convolution_mode!r}")
            kp = kernel_point_layout(p.num_kernel_points,
                                     p.fixed_kernel_points)
            self.extent = float(p.KP_extent * _typical_spacing(kp))
            # moves with the module; not a parameter, not in the state_dict
            self.register_buffer("kernel_points", torch.from_numpy(kp),
                                 persistent=False)
            self.kernel_weights = nn.Linear(kp.shape[0] * in_channels,
                                            out_channels, bias=False)
            out_width = out_channels
        else:
            raise ValueError(f"unknown local_aggregation_type: "
                             f"{self.kind!r}")
        self.p = p
        # the JAX module's _maybe_output_conv; the pointwisemlp config has
        # no output_conv key
        self.output_conv = None
        if getattr(p, "output_conv", False) or out_width != out_channels:
            self.output_conv = ConvBN(out_width, out_channels,
                                      config.batchnorm_momentum, dtype=dtype)

    def forward(self, query_xyz, support_xyz, support_features, neighbor_idx,
                neighbor_mask):
        q, s = query_xyz.float(), support_xyz.float()
        args = (q, s, support_features, neighbor_idx, neighbor_mask)
        if self.kind == "pospool":
            if self.p.reduction in ("avg", "sum"):
                out = pospool_fused(*args, self.radius,
                                    self.p.position_embedding,
                                    self.p.reduction)
            else:
                out = self._pospool_gather(*args)
        elif self.kind == "adaptive_weight":
            out = (self._adaptive_factorized(*args) if self.factorized
                   else self._adaptive_gather(*args))
        elif self.kind == "pseudo_grid":
            out = self._pseudo_grid(*args)
        else:
            out = (self._pointwisemlp_factorized(*args) if self.factorized
                   else self._pointwisemlp_gather(*args))
        if self.output_conv is not None:
            out = self.output_conv(out)
        return out

    def _pospool_gather(self, q, s, f_support, idx, mask):
        """The JAX package's gather path (``_pospool``), for the max
        reduction, which no kernel of either package takes: dp rounded to
        the features' dtype, as that path rounds it."""
        f = group_features(f_support, idx)  # [B, Nq, K, C]
        dp = neighbor_offsets(q, s, idx, self.radius, f.dtype)
        c = f.shape[-1]
        if self.p.position_embedding == "xyz":
            g = c // 3
            enc = torch.cat([f[..., :g] * dp[..., 0:1],
                             f[..., g:2 * g] * dp[..., 1:2],
                             f[..., 2 * g:] * dp[..., 2:3]], dim=-1)
        else:
            enc = f * sinusoidal_embedding(dp.float(), c).to(f.dtype)
        return REDUCTIONS[self.p.reduction](enc, mask)

    def _pseudo_grid(self, q, s, f, idx, mask):
        """The JAX ``_pseudo_grid_fused``: kernel-point correlation
        ``[B, Nq, Kp*C]`` in the features' dtype, then ``h @ W`` in that
        dtype, then / max(count, 1) for ``convolution_mode: avg``."""
        p = self.p
        h = pseudo_grid_fused(q, s, f, idx, mask, self.kernel_points,
                              self.radius, self.extent, p.KP_influence)
        out = F.linear(h, self.kernel_weights.weight.to(h.dtype))
        if p.convolution_mode == "avg":
            cnt = mask.sum(dim=-1, keepdim=True).to(out.dtype)
            out = out / torch.clamp(cnt, min=1.0)
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

    def _pointwisemlp_gather(self, q, s, f_support, idx, mask):
        """The JAX package's gather path (``_pointwisemlp``): per neighbor
        [dp | f_j | f_j - f_i] (f_i = slot 0, the query's own point or its
        nearest carrier), then FC -> masked BN -> ReLU layers, then the
        masked reduction."""
        ft = self.p.feature_type
        f = group_features(f_support, idx)  # [B, Nq, K, C]
        parts = []
        if "dp" in ft:
            parts.append(neighbor_offsets(q, s, idx, self.radius, f.dtype))
        if "fi" in ft:
            parts.append(f)
        if "df" in ft:
            parts.append(f - f[:, :, :1, :])
        h = torch.cat(parts, dim=-1)
        for lin, bn in zip(self.pw_linears, self.pw_bns):
            h = torch.relu(bn(F.linear(h, lin.weight.to(h.dtype)), mask))
        return REDUCTIONS[self.p.reduction](h, mask)

    def _pointwisemlp_factorized(self, q, s, fx, idx, mask):
        """One FC then max (the JAX ``_pointwisemlp_factorized``): with W =
        [W_dp; W_fi; W_df], h[i, k] = G[idx[i, k]] - D[i] for the per-point
        projections G = (s / r) W_dp + f W_fi + f W_df and D = (q / r) W_dp
        + f_i W_df (f_i = the features at slot 0, whatever its mask).

        Each projection multiplies operands rounded to the model dtype in
        f32, and G, D and G² stay f32 until one cast, as JAX's
        ``preferred_element_type=f32`` products do. Train mode reduces G
        with the min/max + statistics kernel and forms the masked BN's
        mean and variance from its sums (in a process group of more than
        one process, from their sums over ranks: one all-reduce of
        [sum h, sum h^2, valid slots]); eval mode takes the min/max of
        h with the gather-subtract kernel. BN then ReLU commute with the
        max: relu(s * max h + b) for s >= 0, relu(s * min h + b) for s < 0.
        """
        ft = self.p.feature_type
        dt = self.dtype
        c = fx.shape[-1]
        w = self.pw_linears[0].weight.t()  # [din, C_out] f32
        bn = self.pw_bns[0]

        def dot(x, ws):
            return torch.matmul(x.to(dt).float(), ws.to(dt).float())

        inv_r = torch.full((), 1.0 / self.radius, dtype=torch.float32,
                           device=q.device)
        g = d = None
        off = 0
        if "dp" in ft:
            g = dot(s * inv_r, w[0:3])
            d = dot(q * inv_r, w[0:3])
            off = 3
        if "fi" in ft:
            t = dot(fx, w[off:off + c])
            g = t if g is None else g + t
            off += c
        if "df" in ft:
            wdf = w[off:off + c]
            t = dot(fx, wdf)
            g = t if g is None else g + t
            f0 = torch.gather(fx, 1, idx[:, :, 0].long()[..., None].expand(
                -1, -1, c))
            t = dot(f0, wdf)
            d = t if d is None else d + t
        if d is None:  # feature_type without dp or df: nothing query-side
            d = torch.zeros((*q.shape[:2], g.shape[-1]), dtype=torch.float32,
                            device=g.device)
        if self.training:
            # the route of the global batch (every rank's queries)
            gmax, gmin, s1, s2 = pwmlp_minmax_stats(
                g.to(dt), (g * g).to(dt), idx, mask,
                queries=world()[0] * idx.shape[0] * idx.shape[1])
            hmax, hmin = gmax - d, gmin - d
            cnt = mask.sum(dim=-1, keepdim=True).float()
            sh = (s1 - cnt * d).sum(dim=(0, 1))
            sh2 = (s2 - 2.0 * d * s1 + cnt * d * d).sum(dim=(0, 1))
            n = cnt.sum()
            if distributed():  # the global batch's sums, K6f's per rank
                sums = all_reduce_sum(torch.cat([sh, sh2, n.reshape(1)]))
                co = sh.shape[0]
                sh, sh2, n = sums[:co], sums[co:-1], sums[-1]
            total = torch.clamp(n, min=1.0)
            mean = sh / total
            ex2 = sh2 / total
            var = torch.clamp(ex2 - mean ** 2, min=0.0)
            eff_s, eff_b = bn.stats_affine(mean, var)
        else:
            eff_s, eff_b = bn.stats_affine()
            hmax, hmin = gather_sub_minmax(g.to(dt), d.to(dt), idx, mask)
        eff_s, eff_b = eff_s.float(), eff_b.float()
        h = torch.where(eff_s >= 0, eff_s * hmax, eff_s * hmin) + eff_b
        out = torch.relu(h)
        any_valid = mask.any(dim=-1, keepdim=True)
        return torch.where(any_valid, out, torch.zeros_like(out)).to(dt)
