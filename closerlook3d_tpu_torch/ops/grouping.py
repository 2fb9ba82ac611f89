"""Neighbor gathers, masked reductions, and the neighborhood max kernel.

Same conventions as ``closerlook3d_tpu/ops/grouping.py``:
  * max (and min): invalid slots -> -inf (+inf); queries with no valid
    neighbor -> 0;
  * avg (also called mean): sum of valid / max(count, 1);
  * sum: sum of valid.
Indices stay int32 at the public functions and widen to int64 only at the
``torch.gather`` call.
"""

from __future__ import annotations

from typing import Optional

import torch

from closerlook3d_tpu_torch.ops import kernels, library
from closerlook3d_tpu_torch.ops.dispatch import use_kernel
from closerlook3d_tpu_torch.ops.neighbors import MAX_K
from closerlook3d_tpu_torch.ops.reverse_index import launch_backward_gather


def group_features(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, Ns, C] gathered by [B, Nq, K] int32 indices -> [B, Nq, K, C]."""
    b, nq, k = idx.shape
    c = features.shape[-1]
    flat = idx.reshape(b, nq * k, 1).to(torch.int64).expand(b, nq * k, c)
    return torch.gather(features, 1, flat).reshape(b, nq, k, c)


def group_xyz(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbor coordinates: [B, Nq, K, 3]."""
    return group_features(xyz, idx)


def neighbor_offsets(query_xyz, support_xyz, idx, radius: float, dtype):
    """dp = (p_j - p_i) / r in f32, cast to ``dtype``: [B, Nq, K, 3]."""
    pj = group_xyz(support_xyz.float(), idx)
    # divide by a tensor: a Python scalar divisor may become a multiply by
    # its reciprocal on CUDA, which rounds differently. A fill, not a copy
    # from the host, which would synchronize with the card.
    r = torch.full((), radius, dtype=torch.float32, device=pj.device)
    return ((pj - query_xyz[:, :, None, :].float()) / r).to(dtype)


def masked_max(values: torch.Tensor, mask: Optional[torch.Tensor],
               dim: int = -2) -> torch.Tensor:
    """Max over the neighbor axis; empty neighborhoods produce 0."""
    if mask is None:
        return values.amax(dim=dim)
    out = values.masked_fill(~mask[..., None], float("-inf")).amax(dim=dim)
    any_valid = mask.any(dim=-1, keepdim=True)
    return torch.where(any_valid, out, torch.zeros_like(out))


def masked_min(values: torch.Tensor, mask: torch.Tensor,
               dim: int = -2) -> torch.Tensor:
    """Min over the neighbor axis; empty neighborhoods produce 0."""
    out = values.masked_fill(~mask[..., None], float("inf")).amin(dim=dim)
    any_valid = mask.any(dim=-1, keepdim=True)
    return torch.where(any_valid, out, torch.zeros_like(out))


def masked_sum(values: torch.Tensor, mask: Optional[torch.Tensor],
               dim: int = -2) -> torch.Tensor:
    if mask is None:
        return values.sum(dim=dim)
    return (values * mask[..., None].to(values.dtype)).sum(dim=dim)


def masked_avg(values: torch.Tensor, mask: Optional[torch.Tensor],
               dim: int = -2) -> torch.Tensor:
    if mask is None:
        return values.mean(dim=dim)
    total = masked_sum(values, mask, dim=dim)
    count = mask.sum(dim=-1, keepdim=True).to(values.dtype)
    return total / torch.clamp(count, min=1.0)


REDUCTIONS = {"max": masked_max, "avg": masked_avg, "mean": masked_avg,
              "sum": masked_sum}


def neighborhood_max_plain(features, idx, mask):
    """Plain PyTorch version: gather, then masked max. Its autograd splits
    dy evenly over tying slots (amax's backward), as JAX's jnp path does."""
    return masked_max(group_features(features, idx), mask)


def neighborhood_max_bwd_plain(features, idx, mask, out, dy):
    """Plain twin of the backward kernel: d out / d features, [B, Ns, C].

    dy / n (n = valid slots whose value equals ``out``), rounded to dy's
    dtype as amax's backward rounds it, goes to each such slot's support
    row; the scatter (``index_add_``) is f32 and rounded once, as the
    kernel does: on CPU tensors it adds in (q, t) order, the kernel's
    order. Empty neighborhoods send nothing. Every slot adds g * tie, so an
    inf or NaN in dy reaches every row the query's slots name, where the
    kernel adds only at ties.
    """
    ties = (group_features(features, idx) == out[:, :, None, :]) \
        & mask[..., None]
    n = ties.sum(dim=2)
    g = (dy.float() / n.clamp(min=1)).to(dy.dtype).float()
    return scatter_to_support(g[:, :, None, :] * ties, idx,
                              features.shape[1]).to(dy.dtype)


def reduction_grad(dy: torch.Tensor, mask: torch.Tensor,
                   reduction: str) -> torch.Tensor:
    """The gradient each valid slot receives from an avg|sum over the
    neighbors, as f32: dy (sum), or dy / max(count, 1) rounded to dy's
    dtype (avg, as masked_avg's autograd rounds it)."""
    g = dy.float()
    if reduction == "avg":
        cnt = mask.sum(dim=-1, keepdim=True).clamp(min=1).float()
        g = (g / cnt).to(dy.dtype).float()
    return g


def scatter_to_support(contrib: torch.Tensor, idx: torch.Tensor,
                       ns: int) -> torch.Tensor:
    """Sum [B, Nq, K, C] per-slot terms onto their support rows
    (``index_add_``): [B, Ns, C] in contrib's dtype."""
    b, c = contrib.shape[0], contrib.shape[-1]
    rows = (idx.long() + torch.arange(b, device=idx.device)[:, None, None]
            * ns).reshape(-1)
    out = torch.zeros((b * ns, c), dtype=contrib.dtype, device=contrib.device)
    out.index_add_(0, rows, contrib.reshape(-1, c))
    return out.reshape(b, ns, c)


def _check_call(what, features, idx, mask, **more):
    """Raise on anything the kernels do not take; ``more`` holds out/dy
    ([B,Nq,C] in the features' dtype) for the backward."""
    b, nq, k = idx.shape
    kernels.require_cuda(what, features=features, idx=idx, mask=mask, **more)
    kernels.require(features.dtype in (torch.float32, torch.bfloat16),
                    f"{what}: features must be float32 or bfloat16, got "
                    f"{features.dtype}")
    kernels.require(all(t.dtype == features.dtype for t in more.values()),
                    f"{what}: {', '.join(more)} must have the features' "
                    f"dtype")
    kernels.require(idx.dtype == torch.int32 and mask.dtype == torch.bool,
                    f"{what}: idx must be int32 and mask bool")
    kernels.require(features.ndim == 3 and features.shape[0] == b
                    and mask.shape == (b, nq, k)
                    and all(t.shape == (b, nq, features.shape[2])
                            for t in more.values()),
                    f"{what}: shapes do not fit f [B,Ns,C], idx/mask "
                    f"[B,Nq,K], out/dy [B,Nq,C]")
    kernels.require(1 <= k <= MAX_K, f"{what}: K={k} outside [1, {MAX_K}]")
    ns, c = features.shape[1], features.shape[2]
    kernels.require(ns >= 1 and c >= 1 and b <= 65535,
                    f"{what}: need Ns >= 1, C >= 1 and B <= 65535")
    return b, nq, ns, c, k


def neighborhood_max_cuda(features, idx, mask):
    """Launch the forward of ``csrc/neighborhood_max.cu``; raises on
    anything it does not take."""
    what = "neighborhood_max_cuda"
    b, nq, ns, c, k = _check_call(what, features, idx, mask)
    out = torch.empty((b, nq, c), dtype=features.dtype,
                      device=features.device)
    if b * nq == 0:
        return out
    lib, fn = kernels.entry(
        "neighborhood_max", "cl3d_neighborhood_max",
        [kernels.P] * 3 + [kernels.I] * 6 + [kernels.P] * 2)
    with torch.cuda.device(features.device):
        err = fn(features.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                 b, nq, ns, c, k, int(features.dtype == torch.bfloat16),
                 out.data_ptr(), kernels.stream_of(out))
    kernels.check(lib, err, what)
    neighborhood_max_cuda.launches += 1
    return out


neighborhood_max_cuda.launches = 0


def neighborhood_max_bwd_cuda(features, idx, mask, out, dy):
    """Launch the backward of ``csrc/neighborhood_max.cu``: d out / d
    features [B, Ns, C] in the features' dtype; ``out`` is the forward's
    output for ``features``. Two device kernels: the reverse index of
    idx/mask in query tiles beside g = dy / (tying slots) by query, then a
    gather per support row that adds g where the row ties and writes the
    row once (``launch_backward_gather``); equal to
    ``neighborhood_max_bwd_plain`` on CPU copies to the bit for finite dy.
    Raises on anything it does not take."""
    what = "neighborhood_max_bwd_cuda"
    b, nq, ns, c, k = _check_call(what, features, idx, mask, out=out,
                                  dy=dy)
    if b * nq == 0:
        return torch.zeros((b, ns, c), dtype=features.dtype,
                           device=features.device)
    # radius is unused; "avg" has g allocated for launch 1's quotients
    df = launch_backward_gather(
        "neighborhood_max", what, (features, out, idx, mask, dy),
        (b, nq, ns, c, k), dy, 0.0, "avg")
    neighborhood_max_bwd_cuda.launches += 1
    return df


neighborhood_max_bwd_cuda.launches = 0


class _NeighborhoodMax(torch.autograd.Function):
    """The kernels as one differentiable op (the JAX ``_max_vjp``)."""

    @staticmethod
    def forward(ctx, features, idx, mask):
        out = _neighborhood_max_op(features, idx, mask)
        ctx.save_for_backward(features, idx, mask, out)
        return out

    @staticmethod
    def backward(ctx, dy):
        df = None
        if ctx.needs_input_grad[0]:
            features, idx, mask, out = ctx.saved_tensors
            df = neighborhood_max_bwd_cuda(features, idx, mask, out,
                                           dy.contiguous())
        return df, None, None


def neighborhood_max(features: torch.Tensor, idx: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Gather + masked max over a neighborhood: [B, Nq, C], 0 where no
    slot is valid; differentiable in ``features``.

    features [B,Ns,C] (bf16 or f32); idx [B,Nq,K] int32; mask [B,Nq,K]
    bool or None (all valid). A CUDA tensor launches the kernels at every
    support size (the JAX package's switch to its Pallas kernel at
    Ns >= 2048 was a TPU speed choice); a CPU tensor takes the plain
    version; either through the op ``cl3d::neighborhood_max``
    (``ops/library.py``), which the ``autograd.Function`` calls and, where
    grad is off, this function.
    """
    if not torch.is_grad_enabled():
        return _neighborhood_max_op(features, idx, mask)
    if use_kernel(features):
        if mask is None:
            mask = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        return _NeighborhoodMax.apply(features, idx, mask)
    return neighborhood_max_plain(features, idx, mask)


def _neighborhood_max_impl(features, idx, mask):
    if use_kernel(features):
        if mask is None:
            mask = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        return neighborhood_max_cuda(features, idx, mask)
    return neighborhood_max_plain(features, idx, mask).contiguous()


def _neighborhood_max_fake(features, idx, mask):
    return features.new_empty((*idx.shape[:2], features.shape[-1]))


_neighborhood_max_op = library.define(
    "neighborhood_max(Tensor features, Tensor idx, Tensor? mask) -> Tensor",
    _neighborhood_max_impl, _neighborhood_max_fake)
