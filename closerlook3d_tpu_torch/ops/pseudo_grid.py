"""Fused pseudo-grid (KPConv-style) kernel-point correlation, forward and
backward.

Counterpart of ``closerlook3d_tpu/ops/pallas/pseudo_grid.py::
pseudo_grid_fused``: for each query, the neighbor features distributed
onto the Kp kernel points,

    h[q, p*C + c] = sum_k mask_k * infl(u_k, kp_p) * f[idx_k, c],
    u_k = (s[idx_k] - q) * (1 / r),

``[B, Nq, Kp*C]`` p-major, without the ``[B, Nq, K, Kp]`` influences or
the ``[B, Nq, K, C]`` gather on the kernel path; differentiable in the
features only (positions and kernel points get no gradient, as in the
JAX package's custom VJP). The per-kernel-point weight matmul stays in
the model (``models/aggregation.py``). On CUDA tensors a
``torch.autograd.Function`` runs the kernels of ``csrc/pseudo_grid.cu``
forward and backward; on CPU tensors the plain PyTorch version runs
under ordinary autograd. The forward is the op ``cl3d::pseudo_grid``
(``ops/library.py``), called by the ``autograd.Function`` and, where
grad is off, directly.

Numerics follow the TPU kernel (``_influence_rows``): u and the
influences stay f32 and the output is rounded once to the features'
dtype. The JAX jnp path (``models/aggregation.py::_pseudo_grid``)
divides by r instead of multiplying by 1/r, takes ``|u - kp|`` as a
norm, and in bf16 rounds dp and the influences to bf16 before its
einsum; in f32 the two agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from closerlook3d_tpu_torch.ops import kernels, library
from closerlook3d_tpu_torch.ops.dispatch import use_kernel
from closerlook3d_tpu_torch.ops.grouping import (
    group_features, group_xyz, scatter_to_support)
from closerlook3d_tpu_torch.ops.neighbors import MAX_K
from closerlook3d_tpu_torch.ops.reverse_index import index_buffers

INFLUENCE_MODES = ("linear", "constant", "gaussian")  # kernel's enum order
MAX_KERNEL_POINTS = 64  # csrc/pseudo_grid.cu kMaxKp


def influence_coef(extent: float, mode: str) -> float:
    """The f32 constant of each influence, as the TPU kernel forms it
    from Python floats: 1 / extent (linear), extent² (constant), or
    1 / (2 (0.3 extent)²) (gaussian)."""
    if mode == "linear":
        c = 1.0 / extent
    elif mode == "constant":
        c = extent * extent
    elif mode == "gaussian":
        sig = 0.3 * extent
        c = 1.0 / (2.0 * sig * sig)
    else:
        raise ValueError(f"unknown KP_influence {mode!r}")
    return float(np.float32(c))


def _inv_r(radius: float) -> float:
    return float(np.float32(1.0 / radius))


def influence_weights(query_xyz, support_xyz, idx, mask, kp, radius: float,
                      extent: float, mode: str) -> torch.Tensor:
    """Masked influences w [B, Nq, K, Kp] f32: u = (s[idx] - q) * (1/r),
    d2 = Σ_d (u_d - kp_d)² (each step rounded to f32, d = 0, 1, 2), then
    the mode's function of d2, zero for masked slots."""
    u = (group_xyz(support_xyz.float(), idx)
         - query_xyz[:, :, None, :].float()) * _inv_r(radius)
    kp = kp.float()
    d2 = None
    for d in range(3):
        diff = u[..., None, d] - kp[:, d]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    coef = influence_coef(extent, mode)
    if mode == "linear":
        w = torch.clamp(1.0 - torch.sqrt(d2) * coef, min=0.0)
    elif mode == "constant":
        w = (d2 <= coef).float()
    else:
        w = torch.exp(-d2 * coef)
    return w * mask[..., None]


def pseudo_grid_plain(query_xyz, support_xyz, features, idx, mask, kp,
                      radius: float, extent: float, mode: str):
    """Plain PyTorch pseudo-grid: f32 influences times f32 gathered
    features, summed over the slots (a batched matmul), rounded once to
    the features' dtype: [B, Nq, Kp*C]."""
    w = influence_weights(query_xyz, support_xyz, idx, mask, kp, radius,
                          extent, mode)
    fg = group_features(features.float(), idx)  # [B, Nq, K, C]
    h = torch.matmul(w.transpose(-1, -2), fg)  # [B, Nq, Kp, C]
    return h.reshape(*h.shape[:2], -1).to(features.dtype)


def pseudo_grid_bwd_plain(query_xyz, support_xyz, idx, mask, kp, dy,
                          radius: float, extent: float, mode: str):
    """Plain twin of the backward kernel: d out / d features, [B, Ns, C].

    Each valid slot k adds Σ_p w[k, p] dy[p*C + c] to its support row; the
    products and the scatter (``index_add_``, in (q, k) order) are f32,
    rounded once to dy's dtype, as the kernel's gather does (which sums
    over p in another order than the matmul).
    """
    kpn = kp.shape[0]
    b, nq, _ = dy.shape
    w = influence_weights(query_xyz, support_xyz, idx, mask, kp, radius,
                          extent, mode)
    dslot = torch.matmul(w, dy.float().reshape(b, nq, kpn, -1))
    return scatter_to_support(dslot * mask[..., None], idx,
                              support_xyz.shape[1]).to(dy.dtype)


def _check(what, query_xyz, support_xyz, values, idx, mask, kp, mode):
    """Raise on anything the kernels do not take; values are the features
    [B,Ns,C] (forward) or dy [B,Nq,Kp*C] (backward). Returns (B, Nq, Ns,
    K, Kp)."""
    b, nq, k = idx.shape
    ns = support_xyz.shape[1]
    kernels.require_cuda(what, query_xyz=query_xyz, support_xyz=support_xyz,
                         values=values, idx=idx, mask=mask, kp=kp)
    kernels.require(query_xyz.dtype == torch.float32
                    and support_xyz.dtype == torch.float32
                    and kp.dtype == torch.float32,
                    f"{what}: points and kernel points must be float32")
    kernels.require(values.dtype in (torch.float32, torch.bfloat16),
                    f"{what}: features must be float32 or bfloat16, "
                    f"got {values.dtype}")
    kernels.require(idx.dtype == torch.int32 and mask.dtype == torch.bool,
                    f"{what}: idx must be int32 and mask bool")
    kernels.require(query_xyz.shape == (b, nq, 3)
                    and support_xyz.shape == (b, ns, 3)
                    and values.ndim == 3 and values.shape[0] == b
                    and mask.shape == (b, nq, k)
                    and kp.ndim == 2 and kp.shape[1] == 3,
                    f"{what}: shapes do not fit q [B,Nq,3], s [B,Ns,3], "
                    f"idx/mask [B,Nq,K], kp [Kp,3]")
    kpn = kp.shape[0]
    kernels.require(1 <= kpn <= MAX_KERNEL_POINTS,
                    f"{what}: Kp={kpn} outside [1, {MAX_KERNEL_POINTS}]")
    kernels.require(1 <= k <= MAX_K, f"{what}: K={k} outside [1, {MAX_K}]")
    kernels.require(ns >= 1 and b <= 65535,
                    f"{what}: need Ns >= 1 and B <= 65535")
    kernels.require(mode in INFLUENCE_MODES,
                    f"{what}: KP_influence {mode!r} not one of "
                    f"{INFLUENCE_MODES}")
    return b, nq, ns, k, kpn


def pseudo_grid_cuda(query_xyz, support_xyz, features, idx, mask, kp,
                     radius: float, extent: float, mode: str):
    """Launch the forward of ``csrc/pseudo_grid.cu``: [B, Nq, Kp*C] in the
    features' dtype. Raises on anything it does not take."""
    what = "pseudo_grid_cuda"
    b, nq, ns, k, kpn = _check(what, query_xyz, support_xyz, features, idx,
                               mask, kp, mode)
    c = features.shape[-1]
    kernels.require(features.shape == (b, ns, c) and c >= 1,
                    f"{what}: features must be [B, Ns, C]")
    out = torch.empty((b, nq, kpn * c), dtype=features.dtype,
                      device=features.device)
    if b * nq == 0:
        return out
    lib, fn = kernels.entry(
        "pseudo_grid", "cl3d_pseudo_grid",
        [kernels.P] * 6 + [kernels.I] * 6 + [kernels.F] * 2
        + [kernels.I] * 2 + [kernels.P] * 2)
    with torch.cuda.device(out.device):
        err = fn(query_xyz.data_ptr(), support_xyz.data_ptr(),
                 features.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                 kp.data_ptr(), b, nq, ns, c, k, kpn, _inv_r(radius),
                 influence_coef(extent, mode), INFLUENCE_MODES.index(mode),
                 int(features.dtype == torch.bfloat16), out.data_ptr(),
                 kernels.stream_of(out))
    kernels.check(lib, err, what)
    pseudo_grid_cuda.launches += 1
    return out


pseudo_grid_cuda.launches = 0


def pseudo_grid_bwd_cuda(query_xyz, support_xyz, idx, mask, kp, dy,
                         radius: float, extent: float, mode: str):
    """Launch the backward of ``csrc/pseudo_grid.cu``: d out / d features
    [B, Ns, C] in dy's dtype. Two device kernels: the reverse index of
    idx/mask (``ops/reverse_index.py``) beside each valid slot's sum over
    the kernel points by query, then a gather per support row that writes
    the row once. Raises on anything it does not take."""
    what = "pseudo_grid_bwd_cuda"
    b, nq, ns, k, kpn = _check(what, query_xyz, support_xyz, dy, idx, mask,
                               kp, mode)
    kernels.require(dy.shape[1] == nq and dy.shape[2] >= kpn
                    and dy.shape[2] % kpn == 0,
                    f"{what}: dy must be [B, Nq, Kp*C]")
    c = dy.shape[2] // kpn
    if b * nq == 0:
        return torch.zeros((b, ns, c), dtype=dy.dtype, device=dy.device)
    index = index_buffers(b, nq, ns, k, dy.device)
    sums = torch.empty((b, nq, k, c), dtype=torch.float32, device=dy.device)
    df = torch.empty((b, ns, c), dtype=dy.dtype, device=dy.device)
    lib, fn = kernels.entry(
        "pseudo_grid", "cl3d_pseudo_grid_bwd",
        [kernels.P] * 6 + [kernels.I] * 6 + [kernels.F] * 2
        + [kernels.I] * 2 + [kernels.P] * 7)
    with torch.cuda.device(dy.device):
        err = fn(query_xyz.data_ptr(), support_xyz.data_ptr(),
                 idx.data_ptr(), mask.data_ptr(), kp.data_ptr(),
                 dy.data_ptr(), b, nq, ns, c, k, kpn, _inv_r(radius),
                 influence_coef(extent, mode), INFLUENCE_MODES.index(mode),
                 int(dy.dtype == torch.bfloat16),
                 *[t.data_ptr() for t in index], sums.data_ptr(),
                 df.data_ptr(), kernels.stream_of(df))
    kernels.check(lib, err, what)
    pseudo_grid_bwd_cuda.launches += 1
    return df


pseudo_grid_bwd_cuda.launches = 0


class _PseudoGrid(torch.autograd.Function):
    """The two kernels as one differentiable op (the JAX ``_pg_vjp``)."""

    @staticmethod
    def forward(ctx, query_xyz, support_xyz, features, idx, mask, kp,
                radius: float, extent: float, mode: str):
        ctx.save_for_backward(query_xyz, support_xyz, idx, mask, kp)
        ctx.radius, ctx.extent, ctx.mode = radius, extent, mode
        return _pseudo_grid_op(query_xyz, support_xyz, features, idx, mask,
                               kp, radius, extent, mode)

    @staticmethod
    def backward(ctx, dy):
        df = None
        if ctx.needs_input_grad[2]:
            query_xyz, support_xyz, idx, mask, kp = ctx.saved_tensors
            df = pseudo_grid_bwd_cuda(query_xyz, support_xyz, idx, mask, kp,
                                      dy.contiguous(), ctx.radius,
                                      ctx.extent, ctx.mode)
        return None, None, df, None, None, None, None, None, None


def pseudo_grid_fused(query_xyz, support_xyz, features, idx, mask, kp,
                      radius: float, extent: float, mode: str):
    """Kernel-point distributed features [B, Nq, Kp*C] (p-major) in the
    features' dtype.

    query_xyz [B,Nq,3] f32; support_xyz [B,Ns,3] f32; features [B,Ns,C]
    (bf16 or f32); idx [B,Nq,K] int32; mask [B,Nq,K] bool; kp [Kp,3] f32
    kernel points in radius units; extent: the influence scale in those
    units; mode: linear|constant|gaussian. Differentiable in ``features``.
    """
    if mode not in INFLUENCE_MODES:
        raise ValueError(f"unknown KP_influence {mode!r}")
    if not torch.is_grad_enabled():
        return _pseudo_grid_op(query_xyz, support_xyz, features, idx, mask,
                               kp, float(radius), float(extent), mode)
    if use_kernel(features):
        return _PseudoGrid.apply(query_xyz, support_xyz, features, idx, mask,
                                 kp, float(radius), float(extent), mode)
    return pseudo_grid_plain(query_xyz, support_xyz, features, idx, mask, kp,
                             radius, extent, mode)


def _pseudo_grid_impl(query_xyz, support_xyz, features, idx, mask, kp,
                      radius, extent, mode):
    fwd = pseudo_grid_cuda if use_kernel(features) else pseudo_grid_plain
    return fwd(query_xyz, support_xyz, features, idx, mask, kp, radius,
               extent, mode).contiguous()


def _pseudo_grid_fake(query_xyz, support_xyz, features, idx, mask, kp,
                      radius, extent, mode):
    return features.new_empty((*idx.shape[:2],
                               kp.shape[0] * features.shape[-1]))


_pseudo_grid_op = library.define(
    "pseudo_grid(Tensor query_xyz, Tensor support_xyz, Tensor features, "
    "Tensor idx, Tensor mask, Tensor kp, float radius, float extent, "
    "str mode) -> Tensor", _pseudo_grid_impl, _pseudo_grid_fake)
