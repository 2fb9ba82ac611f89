"""Fused PosPool (xyz position embedding, avg|sum), forward and backward.

Counterpart of ``closerlook3d_tpu/ops/pallas/aggregation.py::pospool_fused``
in xyz mode: ``[B, Nq, C]`` from padded neighborhoods, without the
``[B, Nq, K, C]`` gather on the kernel path, differentiable in the
features (positions get no gradient, as in the JAX package's custom
VJP). On CUDA tensors a ``torch.autograd.Function`` runs the CUDA kernels
of ``csrc/pospool_xyz.cu`` forward and backward; on CPU tensors the plain
PyTorch version, the JAX package's gather path (``models/aggregation.py``
``_pospool``), runs under ordinary autograd.
"""

from __future__ import annotations

import torch

from closerlook3d_tpu_torch.ops import kernels
from closerlook3d_tpu_torch.ops.dispatch import use_kernel
from closerlook3d_tpu_torch.ops.grouping import (
    group_features, group_xyz, masked_avg, masked_sum, scatter_to_support)
from closerlook3d_tpu_torch.ops.neighbors import MAX_K

_REDUCTIONS = {"avg": masked_avg, "sum": masked_sum}


def _dp(query_xyz, support_xyz, idx, radius: float, dtype):
    """(p_j - p_i) / r in f32, cast to ``dtype``: [B, Nq, K, 3]."""
    pj = group_xyz(support_xyz.float(), idx)
    # divide by a tensor: a Python scalar divisor may become a multiply by
    # its reciprocal on CUDA, which rounds differently
    r = torch.tensor(radius, dtype=torch.float32, device=pj.device)
    return ((pj - query_xyz[:, :, None, :].float()) / r).to(dtype)


def pospool_xyz_plain(query_xyz, support_xyz, features, idx, mask,
                      radius: float, reduction: str):
    """Plain PyTorch PosPool xyz, the JAX package's gather path: dp =
    (p_j - p_i) / r in f32, cast to the features' dtype; channel third d
    of f_j is scaled by dp_d; masked avg or sum over the neighbors."""
    g = features.shape[-1] // 3
    f = group_features(features, idx)  # [B, Nq, K, C]
    dp = _dp(query_xyz, support_xyz, idx, radius, f.dtype)
    enc = torch.cat([f[..., :g] * dp[..., 0:1],
                     f[..., g:2 * g] * dp[..., 1:2],
                     f[..., 2 * g:] * dp[..., 2:3]], dim=-1)
    return _REDUCTIONS[reduction](enc, mask)


def pospool_xyz_bwd_plain(query_xyz, support_xyz, idx, mask, dy,
                          radius: float, reduction: str):
    """Plain twin of the backward kernel: d out / d features, [B, Ns, C].

    g = dy (sum) or dy / max(count, 1) rounded to dy's dtype (avg, as the
    gather path's autograd rounds it); each valid slot k adds
    g * dp_{d(c)} to its support row. Products and the scatter
    (``index_add_``) are f32, rounded once to dy's dtype, as the kernel
    does; autograd of ``pospool_xyz_plain`` rounds each step instead.
    """
    g = dy.float()
    if reduction == "avg":
        cnt = mask.sum(dim=-1, keepdim=True).clamp(min=1).float()
        g = (g / cnt).to(dy.dtype).float()
    dp = _dp(query_xyz, support_xyz, idx, radius, dy.dtype).float()
    dpc = dp.repeat_interleave(dy.shape[-1] // 3, dim=-1)  # [B, Nq, K, C]
    contrib = g[:, :, None, :] * dpc * mask[..., None]
    return scatter_to_support(contrib, idx,
                              support_xyz.shape[1]).to(dy.dtype)


def _check_call(what, query_xyz, support_xyz, values, idx, mask,
                reduction: str):
    """Raise on anything the kernels do not take; values are the
    features [B,Ns,C] (forward) or dy [B,Nq,C] (backward)."""
    b, nq, k = idx.shape
    ns, c = support_xyz.shape[1], values.shape[2]
    kernels.require_cuda(what, query_xyz=query_xyz, support_xyz=support_xyz,
                         values=values, idx=idx, mask=mask)
    kernels.require(query_xyz.dtype == torch.float32
                    and support_xyz.dtype == torch.float32,
                    f"{what}: points must be float32")
    kernels.require(values.dtype in (torch.float32, torch.bfloat16),
                    f"{what}: features must be float32 or bfloat16, "
                    f"got {values.dtype}")
    kernels.require(idx.dtype == torch.int32 and mask.dtype == torch.bool,
                    f"{what}: idx must be int32 and mask bool")
    kernels.require(query_xyz.shape == (b, nq, 3)
                    and support_xyz.shape == (b, ns, 3)
                    and values.shape[0] == b and values.ndim == 3
                    and mask.shape == (b, nq, k),
                    f"{what}: shapes do not fit q [B,Nq,3], s [B,Ns,3], "
                    f"f [B,Ns,C] / dy [B,Nq,C], idx/mask [B,Nq,K]")
    kernels.require(c >= 3 and c % 3 == 0, f"{what}: C={c} must be a "
                    f"positive multiple of 3")
    kernels.require(1 <= k <= MAX_K, f"{what}: K={k} outside [1, {MAX_K}]")
    kernels.require(ns >= 1 and b <= 65535,
                    f"{what}: need Ns >= 1 and B <= 65535")
    kernels.require(reduction in _REDUCTIONS,
                    f"{what}: reduction {reduction!r} not avg|sum")
    return b, nq, ns, c, k


def pospool_xyz_cuda(query_xyz, support_xyz, features, idx, mask,
                     radius: float, reduction: str):
    """Launch the forward of ``csrc/pospool_xyz.cu``; raises on anything
    it does not take."""
    what = "pospool_xyz_cuda"
    b, nq, ns, c, k = _check_call(what, query_xyz, support_xyz, features,
                                  idx, mask, reduction)
    kernels.require(features.shape == (b, ns, c),
                    f"{what}: features must be [B, Ns, C]")
    out = torch.empty((b, nq, c), dtype=features.dtype,
                      device=features.device)
    if b * nq == 0:
        return out
    lib, fn = kernels.entry(
        "pospool_xyz", "cl3d_pospool_xyz",
        [kernels.P] * 5 + [kernels.I] * 5 + [kernels.F] + [kernels.I] * 2
        + [kernels.P] * 2)
    with torch.cuda.device(features.device):
        err = fn(query_xyz.data_ptr(), support_xyz.data_ptr(),
                 features.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                 b, nq, ns, c, k, radius, int(reduction == "avg"),
                 int(features.dtype == torch.bfloat16), out.data_ptr(),
                 kernels.stream_of(out))
    kernels.check(lib, err, what)
    pospool_xyz_cuda.launches += 1
    return out


pospool_xyz_cuda.launches = 0


def pospool_xyz_bwd_cuda(query_xyz, support_xyz, idx, mask, dy,
                         radius: float, reduction: str):
    """Launch the backward of ``csrc/pospool_xyz.cu``: d out / d features
    [B, Ns, C] in dy's dtype. Raises on anything it does not take."""
    what = "pospool_xyz_bwd_cuda"
    b, nq, ns, c, k = _check_call(what, query_xyz, support_xyz, dy, idx,
                                  mask, reduction)
    kernels.require(dy.shape == (b, nq, c), f"{what}: dy must be [B, Nq, C]")
    df = torch.zeros((b, ns, c), dtype=torch.float32, device=dy.device)
    if b * nq == 0:
        return df.to(dy.dtype)
    lib, fn = kernels.entry(
        "pospool_xyz", "cl3d_pospool_xyz_bwd",
        [kernels.P] * 5 + [kernels.I] * 5 + [kernels.F] + [kernels.I] * 2
        + [kernels.P] * 2)
    with torch.cuda.device(dy.device):
        err = fn(query_xyz.data_ptr(), support_xyz.data_ptr(),
                 idx.data_ptr(), mask.data_ptr(), dy.data_ptr(),
                 b, nq, ns, c, k, radius, int(reduction == "avg"),
                 int(dy.dtype == torch.bfloat16), df.data_ptr(),
                 kernels.stream_of(df))
    kernels.check(lib, err, what)
    pospool_xyz_bwd_cuda.launches += 1
    return df.to(dy.dtype)


pospool_xyz_bwd_cuda.launches = 0


class _PosPoolXyz(torch.autograd.Function):
    """The kernels as one differentiable op (the JAX ``_pospool_vjp``)."""

    @staticmethod
    def forward(ctx, query_xyz, support_xyz, features, idx, mask,
                radius: float, reduction: str):
        ctx.save_for_backward(query_xyz, support_xyz, idx, mask)
        ctx.radius, ctx.reduction = radius, reduction
        return pospool_xyz_cuda(query_xyz, support_xyz, features, idx, mask,
                                radius, reduction)

    @staticmethod
    def backward(ctx, dy):
        df = None
        if ctx.needs_input_grad[2]:
            query_xyz, support_xyz, idx, mask = ctx.saved_tensors
            df = pospool_xyz_bwd_cuda(query_xyz, support_xyz, idx, mask,
                                      dy.contiguous(), ctx.radius,
                                      ctx.reduction)
        return None, None, df, None, None, None, None


def pospool_fused(query_xyz, support_xyz, features, idx, mask,
                  radius: float, mode: str, reduction: str):
    """PosPool over padded neighborhoods: [B, Nq, C] in the features' dtype.

    query_xyz [B,Nq,3] f32; support_xyz [B,Ns,3] f32; features [B,Ns,C]
    (bf16 or f32, C % 3 == 0); idx [B,Nq,K] int32; mask [B,Nq,K] bool.
    mode: "xyz" ("sin_cos" is not ported yet); reduction: avg|sum.
    Differentiable in ``features``.
    """
    if mode == "sin_cos":
        raise NotImplementedError(
            "PosPool sin_cos is not ported yet (ROADMAP A, remaining "
            "operators; kernel K5)")
    if mode != "xyz":
        raise ValueError(f"unknown PosPool position embedding: {mode!r}")
    if reduction not in _REDUCTIONS:
        raise ValueError(f"fused PosPool reduction must be avg|sum, "
                         f"got {reduction!r}")
    if features.shape[-1] % 3 != 0:
        raise ValueError("xyz PosPool needs channels % 3 == 0")
    if use_kernel(features):
        return _PosPoolXyz.apply(query_xyz, support_xyz, features, idx,
                                 mask, float(radius), reduction)
    return pospool_xyz_plain(query_xyz, support_xyz, features, idx, mask,
                             radius, reduction)
