"""Neighborhood moments, forward and backward.

Counterpart of
``closerlook3d_tpu/ops/pallas/moments.py::neighborhood_moments``: for every
query over its masked padded neighborhood,

    out = [R(f_j), R(dp_x f_j), R(dp_y f_j), R(dp_z f_j)]   [B, Nq, 4C]

with R = masked avg or sum and dp = (p_j - p_i) / r, differentiable in the
features (positions get no gradient, as in the JAX ``_moments_vjp``). The
adaptive-weight operator with one linear FC on dp and no softmax
factorizes through it (``models/aggregation.py``). On CUDA tensors a
``torch.autograd.Function`` runs the kernels of ``csrc/moments.cu``; on CPU
tensors the plain gather version runs under ordinary autograd.
"""

from __future__ import annotations

import torch

from closerlook3d_tpu_torch.ops import kernels
from closerlook3d_tpu_torch.ops.aggregation import (
    check_neighborhood_call, launch_neighborhood_kernel)
from closerlook3d_tpu_torch.ops.dispatch import use_kernel
from closerlook3d_tpu_torch.ops.grouping import (
    REDUCTIONS, group_features, neighbor_offsets, reduction_grad,
    scatter_to_support)


def neighborhood_moments_plain(query_xyz, support_xyz, features, idx, mask,
                               radius: float, reduction: str):
    """Plain PyTorch moments, the gather form (the JAX tests' reference):
    dp in f32 cast to the features' dtype, products and the masked
    reduction in that dtype."""
    f = group_features(features, idx)
    dp = neighbor_offsets(query_xyz, support_xyz, idx, radius, f.dtype)
    red = REDUCTIONS[reduction]
    return torch.cat([red(f, mask)] + [red(f * dp[..., d:d + 1], mask)
                                       for d in range(3)], dim=-1)


def neighborhood_moments_bwd_plain(query_xyz, support_xyz, idx, mask, dy,
                                   radius: float, reduction: str):
    """Plain twin of the backward kernel: d out / d features, [B, Ns, C].

    g = dy (sum) or dy / max(count, 1) rounded to dy's dtype (avg); each
    valid slot adds g_0 + g_1 dp_x + g_2 dp_y + g_3 dp_z (dp rounded to
    dy's dtype; f32 products and sums in that order) to its support row,
    scattered in f32 and rounded once, as the kernel does.
    """
    c = dy.shape[-1] // 4
    g = reduction_grad(dy, mask, reduction)[:, :, None, :]  # [B, Nq, 1, 4C]
    dp = neighbor_offsets(query_xyz, support_xyz, idx, radius,
                          dy.dtype).float()
    contrib = g[..., :c]
    for d in range(3):
        contrib = contrib + g[..., (d + 1) * c:(d + 2) * c] * dp[..., d:d + 1]
    return scatter_to_support(contrib * mask[..., None], idx,
                              support_xyz.shape[1]).to(dy.dtype)


def neighborhood_moments_cuda(query_xyz, support_xyz, features, idx, mask,
                              radius: float, reduction: str):
    """Launch the forward of ``csrc/moments.cu``: [B, Nq, 4C] in the
    features' dtype. Raises on anything it does not take."""
    what = "neighborhood_moments_cuda"
    b, nq, ns, c, k = check_neighborhood_call(
        what, query_xyz, support_xyz, features, idx, mask, reduction)
    kernels.require(features.shape == (b, ns, c),
                    f"{what}: features must be [B, Ns, C]")
    out = torch.empty((b, nq, 4 * c), dtype=features.dtype,
                      device=features.device)
    if b * nq == 0:
        return out
    launch_neighborhood_kernel(
        "moments", "cl3d_moments", what,
        (query_xyz, support_xyz, features, idx, mask), (b, nq, ns, c, k),
        radius, reduction, features.dtype == torch.bfloat16, out)
    neighborhood_moments_cuda.launches += 1
    return out


neighborhood_moments_cuda.launches = 0


def neighborhood_moments_bwd_cuda(query_xyz, support_xyz, idx, mask, dy,
                                  radius: float, reduction: str):
    """Launch the backward of ``csrc/moments.cu``: d out / d features
    [B, Ns, C] from dy [B, Nq, 4C], in dy's dtype. Raises on anything it
    does not take."""
    what = "neighborhood_moments_bwd_cuda"
    b, nq, ns, c4, k = check_neighborhood_call(
        what, query_xyz, support_xyz, dy, idx, mask, reduction, 4)
    kernels.require(dy.shape == (b, nq, c4),
                    f"{what}: dy must be [B, Nq, 4C]")
    c = c4 // 4
    df = torch.zeros((b, ns, c), dtype=torch.float32, device=dy.device)
    if b * nq == 0:
        return df.to(dy.dtype)
    launch_neighborhood_kernel(
        "moments", "cl3d_moments_bwd", what,
        (query_xyz, support_xyz, idx, mask, dy), (b, nq, ns, c, k), radius,
        reduction, dy.dtype == torch.bfloat16, df)
    neighborhood_moments_bwd_cuda.launches += 1
    return df.to(dy.dtype)


neighborhood_moments_bwd_cuda.launches = 0


class _Moments(torch.autograd.Function):
    """The kernels as one differentiable op (the JAX ``_moments_vjp``)."""

    @staticmethod
    def forward(ctx, query_xyz, support_xyz, features, idx, mask,
                radius: float, reduction: str):
        ctx.save_for_backward(query_xyz, support_xyz, idx, mask)
        ctx.radius, ctx.reduction = radius, reduction
        return neighborhood_moments_cuda(query_xyz, support_xyz, features,
                                         idx, mask, radius, reduction)

    @staticmethod
    def backward(ctx, dy):
        df = None
        if ctx.needs_input_grad[2]:
            query_xyz, support_xyz, idx, mask = ctx.saved_tensors
            df = neighborhood_moments_bwd_cuda(
                query_xyz, support_xyz, idx, mask, dy.contiguous(),
                ctx.radius, ctx.reduction)
        return None, None, df, None, None, None, None


def neighborhood_moments(query_xyz, support_xyz, features, idx, mask,
                         radius: float, reduction: str):
    """[B, Nq, 4C] = [R f, R dp_x f, R dp_y f, R dp_z f] in the features'
    dtype; R = masked avg|sum. query_xyz [B,Nq,3] f32, support_xyz
    [B,Ns,3] f32, features [B,Ns,C] (bf16 or f32), idx [B,Nq,K] int32,
    mask [B,Nq,K] bool. Differentiable in ``features``."""
    if reduction not in ("avg", "sum"):
        raise ValueError(f"moments reduction must be avg|sum, got "
                         f"{reduction!r}")
    if use_kernel(features):
        return _Moments.apply(query_xyz, support_xyz, features, idx, mask,
                              float(radius), reduction)
    return neighborhood_moments_plain(query_xyz, support_xyz, features, idx,
                                      mask, radius, reduction)
