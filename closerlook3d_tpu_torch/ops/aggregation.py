"""Fused PosPool (xyz or sin/cos position embedding, avg|sum), forward
and backward.

Counterpart of ``closerlook3d_tpu/ops/pallas/aggregation.py::pospool_fused``:
``[B, Nq, C]`` from padded neighborhoods, without the ``[B, Nq, K, C]``
gather on the kernel path, differentiable in the features (positions get
no gradient, as in the JAX package's custom VJPs). On CUDA tensors a
``torch.autograd.Function`` runs the CUDA kernels of
``csrc/pospool_xyz.cu`` or ``csrc/pospool_sincos.cu`` forward and
backward; on CPU tensors the plain PyTorch version, the JAX package's
gather path (``models/aggregation.py`` ``_pospool``), runs under ordinary
autograd. The forward of either embedding is the op ``cl3d::pospool``
(``ops/library.py``): the ``autograd.Function`` calls it, and so does
``pospool_fused`` wherever grad is off (eval, ``torch.export``).

The sin/cos embedding keeps dp in f32 for its angles and rounds the
embedding to the features' dtype, as the TPU kernel takes its angles from
f32 positions. In f32 this is exactly the JAX gather path; in bf16 that
path rounds dp to bf16 before the x100 scaling, which moves the top
frequencies' angles by up to ~0.2 rad.
"""

from __future__ import annotations

import functools

import torch

from closerlook3d_tpu_torch.ops import kernels, library
from closerlook3d_tpu_torch.ops.dispatch import use_kernel
from closerlook3d_tpu_torch.ops.grouping import (
    REDUCTIONS, group_features, neighbor_offsets, reduction_grad,
    scatter_to_support)
from closerlook3d_tpu_torch.ops.neighbors import MAX_K
from closerlook3d_tpu_torch.ops.reverse_index import launch_backward_gather

SINCOS_ALPHA = 100.0  # angle scale of the sin/cos embedding
SINCOS_BETA = 1000.0  # frequency base ("temperature")
# the channel count each position embedding needs a multiple of
CHANNEL_MULTIPLE = {"xyz": 3, "sin_cos": 6}


@functools.lru_cache(maxsize=None)
def _sincos_freq_on(channels: int, device: str) -> torch.Tensor:
    nf = channels // 6
    exps = torch.arange(nf, dtype=torch.float32) / nf
    return torch.pow(torch.tensor(SINCOS_BETA, dtype=torch.float32),
                     exps).to(device)


def sincos_freq(channels: int, device) -> torch.Tensor:
    """freq[j] = 1000 ** (j / nf), nf = channels // 6: [nf] f32. Computed
    on the CPU, so that the kernels and the plain versions share it, and
    kept per device: a copy to the card would synchronize the host with
    it at every call."""
    return _sincos_freq_on(channels, str(torch.device(device)))


def sinusoidal_embedding(dp: torch.Tensor, channels: int) -> torch.Tensor:
    """The JAX package's ``sinusoidal_embedding``: [..., 3] f32 offsets ->
    [..., channels] f32, coordinate-major blocks [sin(a_0..a_nf-1),
    cos(a_0..a_nf-1)] with a_j = (100 * dp_d) / freq[j]."""
    if channels % 6 != 0:
        raise ValueError("sin_cos PosPool needs channels % 6 == 0")
    ang = (SINCOS_ALPHA * dp[..., None]) / sincos_freq(channels, dp.device)
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return emb.reshape(*dp.shape[:-1], channels)


def pospool_xyz_plain(query_xyz, support_xyz, features, idx, mask,
                      radius: float, reduction: str):
    """Plain PyTorch PosPool xyz, the JAX package's gather path: dp =
    (p_j - p_i) / r in f32, cast to the features' dtype; channel third d
    of f_j is scaled by dp_d; masked avg or sum over the neighbors."""
    g = features.shape[-1] // 3
    f = group_features(features, idx)  # [B, Nq, K, C]
    dp = neighbor_offsets(query_xyz, support_xyz, idx, radius, f.dtype)
    enc = torch.cat([f[..., :g] * dp[..., 0:1],
                     f[..., g:2 * g] * dp[..., 1:2],
                     f[..., 2 * g:] * dp[..., 2:3]], dim=-1)
    return REDUCTIONS[reduction](enc, mask)


def pospool_xyz_bwd_plain(query_xyz, support_xyz, idx, mask, dy,
                          radius: float, reduction: str):
    """Plain twin of the backward kernel: d out / d features, [B, Ns, C].

    g = dy (sum) or dy / max(count, 1) rounded to dy's dtype (avg); each
    valid slot k adds g * dp_{d(c)} to its support row. Products and the
    scatter (``index_add_``) are f32, rounded once to dy's dtype, as the
    kernel does; autograd of ``pospool_xyz_plain`` rounds each step instead.
    On CPU tensors ``index_add_`` adds in (b, q, t) order, the kernel's, so
    the two are equal to the bit (on CUDA tensors it adds in atomic order).
    """
    g = reduction_grad(dy, mask, reduction)
    dp = neighbor_offsets(query_xyz, support_xyz, idx, radius,
                          dy.dtype).float()
    dpc = dp.repeat_interleave(dy.shape[-1] // 3, dim=-1)  # [B, Nq, K, C]
    contrib = g[:, :, None, :] * dpc * mask[..., None]
    return scatter_to_support(contrib, idx,
                              support_xyz.shape[1]).to(dy.dtype)


def _sincos_emb(query_xyz, support_xyz, idx, radius: float, channels: int,
                dtype) -> torch.Tensor:
    """Per-slot embedding from f32 dp, rounded to ``dtype``: [B,Nq,K,C]."""
    dp = neighbor_offsets(query_xyz, support_xyz, idx, radius, torch.float32)
    return sinusoidal_embedding(dp, channels).to(dtype)


def pospool_sincos_plain(query_xyz, support_xyz, features, idx, mask,
                         radius: float, reduction: str):
    """Plain PyTorch PosPool sin/cos: f_j times the sinusoidal embedding of
    f32 dp (rounded to the features' dtype), masked avg or sum."""
    f = group_features(features, idx)
    emb = _sincos_emb(query_xyz, support_xyz, idx, radius, f.shape[-1],
                      f.dtype)
    return REDUCTIONS[reduction](f * emb, mask)


def pospool_sincos_bwd_plain(query_xyz, support_xyz, idx, mask, dy,
                             radius: float, reduction: str):
    """Plain twin of the sin/cos backward kernel: d out / d features,
    [B, Ns, C]: each valid slot adds g * emb (emb rounded to dy's dtype) to
    its support row, f32 products and scatter rounded once."""
    g = reduction_grad(dy, mask, reduction)
    emb = _sincos_emb(query_xyz, support_xyz, idx, radius, dy.shape[-1],
                      dy.dtype).float()
    contrib = g[:, :, None, :] * emb * mask[..., None]
    return scatter_to_support(contrib, idx,
                              support_xyz.shape[1]).to(dy.dtype)


def check_neighborhood_call(what, query_xyz, support_xyz, values, idx, mask,
                            reduction: str, multiple: int = 1):
    """Raise on anything the neighborhood kernels do not take; values are
    the features [B,Ns,C] (forward) or dy [B,Nq,*] (backward), whose
    channel count must be a positive multiple of ``multiple``. Returns
    (B, Nq, Ns, channels of values, K)."""
    b, nq, k = idx.shape
    ns, c = support_xyz.shape[1], values.shape[-1]
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
    kernels.require(c >= multiple and c % multiple == 0,
                    f"{what}: C={c} must be a positive multiple of "
                    f"{multiple}")
    kernels.require(1 <= k <= MAX_K, f"{what}: K={k} outside [1, {MAX_K}]")
    kernels.require(ns >= 1 and b <= 65535,
                    f"{what}: need Ns >= 1 and B <= 65535")
    kernels.require(reduction in ("avg", "sum"),
                    f"{what}: reduction {reduction!r} not avg|sum")
    return b, nq, ns, c, k


def launch_neighborhood_kernel(source: str, fn_name: str, what: str,
                               inputs, shape, radius: float, reduction: str,
                               bf16: bool, out: torch.Tensor) -> None:
    """Call a C entry point of ``csrc/<source>.cu`` with the neighborhood
    kernels' signature: input pointers, then (B, Nq, Ns, C, K), radius,
    avg, is_bf16, the output pointer and the stream. Raises if the launch
    fails."""
    lib, fn = kernels.entry(
        source, fn_name, [kernels.P] * len(inputs) + [kernels.I] * 5
        + [kernels.F] + [kernels.I] * 2 + [kernels.P] * 2)
    with torch.cuda.device(out.device):
        err = fn(*[t.data_ptr() for t in inputs], *shape, radius,
                 int(reduction == "avg"), int(bf16), out.data_ptr(),
                 kernels.stream_of(out))
    kernels.check(lib, err, what)


def _pospool_fwd(mode: str, what: str, query_xyz, support_xyz, features,
                 idx, mask, radius: float, reduction: str):
    b, nq, ns, c, k = check_neighborhood_call(
        what, query_xyz, support_xyz, features, idx, mask, reduction,
        CHANNEL_MULTIPLE[mode])
    kernels.require(features.shape == (b, ns, c),
                    f"{what}: features must be [B, Ns, C]")
    out = torch.empty((b, nq, c), dtype=features.dtype,
                      device=features.device)
    if b * nq == 0:
        return out
    if mode == "xyz":
        source, inputs = "pospool_xyz", (query_xyz, support_xyz, features,
                                         idx, mask)
    else:
        source, inputs = "pospool_sincos", (
            query_xyz, support_xyz, features,
            sincos_freq(c, features.device), idx, mask)
    launch_neighborhood_kernel(source, f"cl3d_{source}", what, inputs,
                               (b, nq, ns, c, k), radius, reduction,
                               features.dtype == torch.bfloat16, out)
    return out


def pospool_xyz_cuda(query_xyz, support_xyz, features, idx, mask,
                     radius: float, reduction: str):
    """Launch the forward of ``csrc/pospool_xyz.cu``; raises on anything
    it does not take."""
    out = _pospool_fwd("xyz", "pospool_xyz_cuda", query_xyz, support_xyz,
                       features, idx, mask, radius, reduction)
    pospool_xyz_cuda.launches += 1
    return out


pospool_xyz_cuda.launches = 0


def pospool_xyz_bwd_cuda(query_xyz, support_xyz, idx, mask, dy,
                         radius: float, reduction: str):
    """Launch the backward of ``csrc/pospool_xyz.cu``: d out / d features
    [B, Ns, C] in dy's dtype. Two device kernels: the reverse index of
    idx/mask (for avg beside dy / max(count, 1) by query), then a gather
    per support row that recomputes each slot's term and writes the row
    once (``launch_backward_gather``); equal to ``pospool_xyz_bwd_plain``
    on CPU copies to the bit. Raises on anything it does not take."""
    what = "pospool_xyz_bwd_cuda"
    b, nq, ns, c, k = check_neighborhood_call(
        what, query_xyz, support_xyz, dy, idx, mask, reduction, 3)
    kernels.require(dy.shape == (b, nq, c), f"{what}: dy must be [B, Nq, C]")
    if b * nq == 0:
        return torch.zeros((b, ns, c), dtype=dy.dtype, device=dy.device)
    df = launch_backward_gather(
        "pospool_xyz", what, (query_xyz, support_xyz, idx, mask, dy),
        (b, nq, ns, c, k), dy, radius, reduction)
    pospool_xyz_bwd_cuda.launches += 1
    return df


pospool_xyz_bwd_cuda.launches = 0


def pospool_sincos_cuda(query_xyz, support_xyz, features, idx, mask,
                        radius: float, reduction: str):
    """Launch the forward of ``csrc/pospool_sincos.cu`` (C % 6 == 0);
    raises on anything it does not take."""
    out = _pospool_fwd("sin_cos", "pospool_sincos_cuda", query_xyz,
                       support_xyz, features, idx, mask, radius, reduction)
    pospool_sincos_cuda.launches += 1
    return out


pospool_sincos_cuda.launches = 0


def pospool_sincos_bwd_cuda(query_xyz, support_xyz, idx, mask, dy,
                            radius: float, reduction: str):
    """Launch the backward of ``csrc/pospool_sincos.cu``: d out / d
    features [B, Ns, C] in dy's dtype. Two device kernels: the reverse
    index of idx/mask (for avg beside dy / max(count, 1) by query), then a
    gather per support row that recomputes each slot's term and writes the
    row once (``launch_backward_gather``). Raises on anything it does not
    take."""
    what = "pospool_sincos_bwd_cuda"
    b, nq, ns, c, k = check_neighborhood_call(
        what, query_xyz, support_xyz, dy, idx, mask, reduction, 6)
    kernels.require(dy.shape == (b, nq, c), f"{what}: dy must be [B, Nq, C]")
    if b * nq == 0:
        return torch.zeros((b, ns, c), dtype=dy.dtype, device=dy.device)
    df = launch_backward_gather(
        "pospool_sincos", what,
        (query_xyz, support_xyz, sincos_freq(c, dy.device), idx, mask, dy),
        (b, nq, ns, c, k), dy, radius, reduction)
    pospool_sincos_bwd_cuda.launches += 1
    return df


pospool_sincos_bwd_cuda.launches = 0


class _PosPool(torch.autograd.Function):
    """The kernels of one embedding as one differentiable op (the JAX
    ``_pospool_vjp`` for xyz, ``_sc2_vjp`` for sin/cos)."""

    @staticmethod
    def forward(ctx, query_xyz, support_xyz, features, idx, mask,
                radius: float, mode: str, reduction: str):
        ctx.save_for_backward(query_xyz, support_xyz, idx, mask)
        ctx.radius, ctx.mode, ctx.reduction = radius, mode, reduction
        return _pospool_op(query_xyz, support_xyz, features, idx, mask,
                           radius, mode, reduction)

    @staticmethod
    def backward(ctx, dy):
        df = None
        if ctx.needs_input_grad[2]:
            query_xyz, support_xyz, idx, mask = ctx.saved_tensors
            bwd = (pospool_xyz_bwd_cuda if ctx.mode == "xyz"
                   else pospool_sincos_bwd_cuda)
            df = bwd(query_xyz, support_xyz, idx, mask, dy.contiguous(),
                     ctx.radius, ctx.reduction)
        return None, None, df, None, None, None, None, None


def pospool_fused(query_xyz, support_xyz, features, idx, mask,
                  radius: float, mode: str, reduction: str):
    """PosPool over padded neighborhoods: [B, Nq, C] in the features' dtype.

    query_xyz [B,Nq,3] f32; support_xyz [B,Ns,3] f32; features [B,Ns,C]
    (bf16 or f32; C % 3 == 0 for xyz, C % 6 == 0 for sin_cos); idx
    [B,Nq,K] int32; mask [B,Nq,K] bool. mode: xyz|sin_cos; reduction:
    avg|sum. Differentiable in ``features``.
    """
    if mode not in CHANNEL_MULTIPLE:
        raise ValueError(f"unknown PosPool position embedding: {mode!r}")
    if reduction not in ("avg", "sum"):
        raise ValueError(f"fused PosPool reduction must be avg|sum, "
                         f"got {reduction!r}")
    if features.shape[-1] % CHANNEL_MULTIPLE[mode] != 0:
        raise ValueError(f"{mode} PosPool needs channels % "
                         f"{CHANNEL_MULTIPLE[mode]} == 0")
    if not torch.is_grad_enabled():
        return _pospool_op(query_xyz, support_xyz, features, idx, mask,
                           float(radius), mode, reduction)
    if use_kernel(features):
        return _PosPool.apply(query_xyz, support_xyz, features, idx, mask,
                              float(radius), mode, reduction)
    plain = pospool_xyz_plain if mode == "xyz" else pospool_sincos_plain
    return plain(query_xyz, support_xyz, features, idx, mask, radius,
                 reduction)


def _pospool_impl(query_xyz, support_xyz, features, idx, mask, radius, mode,
                  reduction):
    if use_kernel(features):
        fwd = pospool_xyz_cuda if mode == "xyz" else pospool_sincos_cuda
    else:
        fwd = pospool_xyz_plain if mode == "xyz" else pospool_sincos_plain
    return fwd(query_xyz, support_xyz, features, idx, mask, radius,
               reduction).contiguous()


def _pospool_fake(query_xyz, support_xyz, features, idx, mask, radius, mode,
                  reduction):
    return features.new_empty((*idx.shape[:2], features.shape[-1]))


_pospool_op = library.define(
    "pospool(Tensor query_xyz, Tensor support_xyz, Tensor features, "
    "Tensor idx, Tensor mask, float radius, str mode, str reduction) "
    "-> Tensor", _pospool_impl, _pospool_fake)
