"""The point-wise MLP's neighborhood reductions, forward and backward.

Counterpart of ``closerlook3d_tpu/ops/pallas/gather_reduce.py``'s
``pwmlp_minmax_stats``, ``gather_sub_minmax`` and ``neighborhood_sum``.
The factorized
point-wise MLP (``models/aggregation.py``) projects support points to G
and query points to D, so that h[q, k] = G[idx[q, k]] - D[q]; then

  * train mode: ``pwmlp_minmax_stats(g, gsq, idx, mask)`` gives the masked
    max and min of g over each neighborhood (the "- D" commutes out of
    both) and the sums of g and of gsq = g² that the masked BatchNorm's
    statistics are made of;
  * eval mode: ``gather_sub_minmax(g, d, idx, mask)`` gives the masked max
    and min of h itself, in f32.

Every output is ``[B, Nq, C]`` f32 and 0 where a neighborhood has no valid
slot. ``neighborhood_sum(f, idx, mask)`` (K13) gives the masked sum of
f[idx] in f's dtype. The ops are differentiable in their float inputs. On
CUDA tensors a ``torch.autograd.Function`` runs the kernels of
``csrc/gather_reduce.cu``; on CPU tensors the plain gather version runs
under ordinary autograd. K7f, which an eval-mode forward reaches, is the
op ``cl3d::gather_sub_minmax`` (``ops/library.py``); K6f and K13, reached
only in train mode, are plain launches.

Route: ``pwmlp_minmax_stats`` composes K13 over [g, gsq] and K7 against a
zero query term where the batch holds at most 64 queries (B·Nq <= 64),
and runs K6 elsewhere, on both devices. The rule is the JAX package's:
its ``pwmlp_minmax_stats`` takes that branch wherever its query tile is
not a multiple of 128 lanes, and the tile (over B·Nq queries, batches
folded) is the next power of two of at least 8 below 128 queries, so
it falls short of 128 exactly up to 64; from 65 to 127 queries it pads
to 128 and K6 runs. The route is kept for the reference's numerics at
those shapes, not for speed: on it s1 and s2 come out of K13 in g's
dtype (rounded to bf16 in a bf16 model), where K6 sums in f64 and
rounds to f32. Under data parallelism the caller passes the global
batch's query count (every rank's clouds), as the JAX package's sharded
step sees its shapes, so that every rank takes the route of one process
stepping the whole batch.

Sums: s1 and s2 accumulate in f64 and round once to f32, in the kernel
and the plain version alike, so that the two agree to the bit but for
rare double roundings whatever their summation order. The masked BN's
variance E[h^2] - mean^2 is formed from them and cancels: one f32 ulp of
noise on s1 and s2 moves a 5000-point train step's loss by ~5e-5 and its
gradients by ~16% (relative L2; CPU, batch 2, f32), where exactly rounded
sums leave both unchanged.

Ties: a max or min cotangent is split evenly over the valid slots that
reach the extremum, as autograd of ``amax``/``amin`` (the plain versions)
and JAX's jnp path split it. The Pallas kernels do not agree with each
other here (K6 routes it to the first extremal slot, K7 to every tying
slot); the backward kernels follow the plain versions.
"""

from __future__ import annotations

import torch

from closerlook3d_tpu_torch.ops import kernels, library
from closerlook3d_tpu_torch.ops.dispatch import use_kernel
from closerlook3d_tpu_torch.ops.grouping import (
    group_features, masked_max, masked_min, masked_sum, scatter_to_support)
from closerlook3d_tpu_torch.ops.neighbors import MAX_K
from closerlook3d_tpu_torch.ops.reverse_index import (
    index_buffers, launch_backward_gather)

SOURCE = "gather_reduce"
# pwmlp_minmax_stats takes the K13 + K7 route up to this many queries in
# the batch (B·Nq), as the JAX package does (see the module's note)
K13_ROUTE_MAX_QUERIES = 64


# ---- plain versions ----------------------------------------------------------

def pwmlp_minmax_stats_plain(g, gsq, idx, mask):
    """(gmax, gmin, s1, s2), each [B, Nq, C] f32: masked max, min and sum
    of g[idx], and masked sum of gsq[idx], gathered in f32; the sums
    accumulate in f64 and round once (see the module's note)."""
    gf = group_features(g.float(), idx)
    qf = group_features(gsq.float(), idx)
    return (masked_max(gf, mask), masked_min(gf, mask),
            masked_sum(gf.double(), mask).float(),
            masked_sum(qf.double(), mask).float())


def gather_sub_minmax_plain(g, d, idx, mask):
    """(hmax, hmin), each [B, Nq, C] f32: masked max and min over the
    neighborhood of h = float(g[idx]) - float(d)."""
    h = group_features(g.float(), idx) - d.float()[:, :, None, :]
    return masked_max(h, mask), masked_min(h, mask)


def _extremal_shares(values, mask, vmax, vmin, dmax, dmin):
    """Per-slot f32 cotangent of (max, min) over the neighbor axis of
    ``values`` [B,Nq,K,C] f32: dmax / n at the n valid slots equal to
    ``vmax``, dmin / m at the m equal to ``vmin`` (amax's and amin's
    backward), summed in that order; 0 at masked slots."""
    m = mask[..., None]
    tmax = (values == vmax[:, :, None, :]) & m
    tmin = (values == vmin[:, :, None, :]) & m
    smax = dmax.float() / tmax.sum(dim=2).clamp(min=1)
    smin = dmin.float() / tmin.sum(dim=2).clamp(min=1)
    return smax[:, :, None, :] * tmax + smin[:, :, None, :] * tmin


def pwmlp_minmax_stats_bwd_plain(g, idx, mask, gmax, gmin, dmax, dmin, ds1,
                                 ds2):
    """Plain twin of the backward kernel: (dg, dgsq), [B, Ns, C] in g's
    dtype. Each valid slot adds ds1 + its even share of dmax and of dmin
    to its g row and ds2 to its gsq row; the scatter (``index_add_``) is
    f32 and rounded once, as the kernel does."""
    ns = g.shape[1]
    m = mask[..., None]
    contrib = ds1.float()[:, :, None, :] + _extremal_shares(
        group_features(g.float(), idx), mask, gmax, gmin, dmax, dmin)
    dg = scatter_to_support(contrib * m, idx, ns)
    dgsq = scatter_to_support(ds2.float()[:, :, None, :] * m, idx, ns)
    return dg.to(g.dtype), dgsq.to(g.dtype)


def gather_sub_minmax_bwd_plain(g, d, idx, mask, hmax, hmin, dmax, dmin):
    """Plain twin of the backward kernel: (dg [B, Ns, C] in g's dtype, dd
    [B, Nq, C] in d's dtype). Each valid slot adds its even share of dmax
    and of dmin to its g row, grouped as ``_extremal_shares`` groups it
    (f32 scatter in (b, q, t) order, rounded once: the kernel's order, so
    the two are equal to the bit); dd = -(dmax + dmin) where the
    neighborhood has a valid slot, else 0. The twin multiplies each share
    by its tie indicator at every valid slot, where the kernel adds only
    at tying slots: the same for finite cotangents, but a non-finite dmax
    or dmin gives NaN at the non-tying slots' rows here and not in the
    kernel."""
    h = group_features(g.float(), idx) - d.float()[:, :, None, :]
    contrib = _extremal_shares(h, mask, hmax, hmin, dmax, dmin)
    dg = scatter_to_support(contrib, idx, g.shape[1]).to(g.dtype)
    dd = torch.where(mask.any(dim=-1, keepdim=True),
                     -(dmax.float() + dmin.float()),
                     torch.zeros((), device=d.device)).to(d.dtype)
    return dg, dd


def neighborhood_sum_plain(f, idx, mask):
    """[B, Nq, C] in f's dtype: the masked sum of f[idx] over the slots,
    added in f32 slot by slot in slot order (t = 0, 1, ..., K-1; a masked
    slot adds 0) and rounded once, the order of the kernel, so that the
    two are equal to the bit."""
    b, nq, k = idx.shape
    c = f.shape[2]
    f32 = f.float()
    acc = torch.zeros((b, nq, c), dtype=torch.float32, device=f.device)
    zero = torch.zeros((), dtype=torch.float32, device=f.device)
    for t in range(k):
        rows = torch.gather(f32, 1, idx[:, :, t].long()[..., None].expand(
            -1, -1, c))
        acc = acc + torch.where(mask[:, :, t, None], rows, zero)
    return acc.to(f.dtype)


def neighborhood_sum_bwd_plain(idx, mask, dy, ns: int):
    """Plain twin of the backward kernel: df [B, Ns, C] in dy's dtype (f's),
    each valid slot adding its query's dy row to its support row; the
    scatter (``index_add_``) is f32 and rounded once, as the kernel's. On
    CPU tensors ``index_add_`` adds in (b, q, t) order, the kernel's order,
    so the two are equal to the bit (on CUDA tensors it adds in atomic
    order)."""
    contrib = dy.float()[:, :, None, :] * mask[..., None]
    return scatter_to_support(contrib, idx, ns).to(dy.dtype)


# ---- CUDA launchers ----------------------------------------------------------

def _check_call(what, g, idx, mask, support=(), query=()):
    """Raise on anything the kernels do not take. ``support`` holds more
    [B,Ns,C] tensors in g's dtype, ``query`` [B,Nq,C] tensors as (tensor,
    dtype) pairs. Returns (B, Nq, Ns, C, K)."""
    b, nq, k = idx.shape
    named = dict(g=g, idx=idx, mask=mask)
    named.update({f"support{i}": t for i, t in enumerate(support)})
    named.update({f"query{i}": t for i, (t, _) in enumerate(query)})
    kernels.require_cuda(what, **named)
    kernels.require(g.dtype in (torch.float32, torch.bfloat16),
                    f"{what}: g must be float32 or bfloat16, got {g.dtype}")
    kernels.require(all(t.dtype == g.dtype for t in support),
                    f"{what}: support tensors must have g's dtype")
    kernels.require(all(t.dtype == dt for t, dt in query),
                    f"{what}: a query tensor has the wrong dtype")
    kernels.require(idx.dtype == torch.int32 and mask.dtype == torch.bool,
                    f"{what}: idx must be int32 and mask bool")
    kernels.require(g.ndim == 3 and g.shape[0] == b
                    and mask.shape == (b, nq, k)
                    and all(t.shape == g.shape for t in support)
                    and all(t.shape == (b, nq, g.shape[2]) for t, _ in query),
                    f"{what}: shapes do not fit g [B,Ns,C], idx/mask "
                    f"[B,Nq,K], query tensors [B,Nq,C]")
    kernels.require(1 <= k <= MAX_K, f"{what}: K={k} outside [1, {MAX_K}]")
    ns, c = g.shape[1], g.shape[2]
    kernels.require(ns >= 1 and c >= 1 and b <= 65535,
                    f"{what}: need Ns >= 1, C >= 1 and B <= 65535")
    return b, nq, ns, c, k


def _launch(fn_name, what, inputs, shape, bf16, outputs, stream_of):
    """Call ``cl3d_<fn_name>`` of ``csrc/gather_reduce.cu``: input
    pointers, (B, Nq, Ns, C, K), is_bf16, output pointers, the stream."""
    lib, fn = kernels.entry(
        SOURCE, fn_name, [kernels.P] * len(inputs) + [kernels.I] * 6
        + [kernels.P] * (len(outputs) + 1))
    with torch.cuda.device(stream_of.device):
        err = fn(*[t.data_ptr() for t in inputs], *shape, int(bf16),
                 *[t.data_ptr() for t in outputs],
                 kernels.stream_of(stream_of))
    kernels.check(lib, err, what)


def _f32_outputs(n, b, nq, c, device):
    return [torch.empty((b, nq, c), dtype=torch.float32, device=device)
            for _ in range(n)]


def pwmlp_minmax_stats_cuda(g, gsq, idx, mask):
    """Launch the forward of K6 in ``csrc/gather_reduce.cu``: (gmax, gmin,
    s1, s2), each [B, Nq, C] f32. Raises on anything it does not take."""
    what = "pwmlp_minmax_stats_cuda"
    b, nq, ns, c, k = _check_call(what, g, idx, mask, support=(gsq,))
    outs = _f32_outputs(4, b, nq, c, g.device)
    if b * nq == 0:
        return tuple(outs)
    _launch("cl3d_pwmlp_stats", what, (g, gsq, idx, mask),
            (b, nq, ns, c, k), g.dtype == torch.bfloat16, outs, g)
    pwmlp_minmax_stats_cuda.launches += 1
    return tuple(outs)


pwmlp_minmax_stats_cuda.launches = 0


def pwmlp_minmax_stats_bwd_cuda(g, idx, mask, gmax, gmin, dmax, dmin, ds1,
                                ds2):
    """Launch the backward of K6: (dg, dgsq), [B, Ns, C] in g's dtype, from
    the forward's gmax/gmin for ``g`` and the four f32 cotangents. Two
    device kernels: the reverse index of idx/mask (``ops/reverse_index.py``)
    beside the per-slot terms by query, then a gather per support row that
    writes each row once; equal to ``pwmlp_minmax_stats_bwd_plain`` on CPU
    copies to the bit. Raises on anything it does not take."""
    what = "pwmlp_minmax_stats_bwd_cuda"
    f32 = torch.float32
    b, nq, ns, c, k = _check_call(
        what, g, idx, mask,
        query=[(t, f32) for t in (gmax, gmin, dmax, dmin, ds1, ds2)])
    if b * nq == 0:
        return g.new_zeros(g.shape), g.new_zeros(g.shape)
    index = index_buffers(b, nq, ns, k, g.device)
    terms = torch.empty((b, nq, k, c), dtype=f32, device=g.device)
    dg, dgsq = torch.empty_like(g), torch.empty_like(g)
    _launch("cl3d_pwmlp_stats_bwd", what,
            (g, idx, mask, gmax, gmin, dmax, dmin, ds1, ds2),
            (b, nq, ns, c, k), g.dtype == torch.bfloat16,
            (*index, terms, dg, dgsq), g)
    pwmlp_minmax_stats_bwd_cuda.launches += 1
    return dg, dgsq


pwmlp_minmax_stats_bwd_cuda.launches = 0


def gather_sub_minmax_cuda(g, d, idx, mask):
    """Launch the forward of K7 in ``csrc/gather_reduce.cu``: (hmax, hmin),
    each [B, Nq, C] f32. Raises on anything it does not take."""
    what = "gather_sub_minmax_cuda"
    b, nq, ns, c, k = _check_call(what, g, idx, mask, query=[(d, g.dtype)])
    outs = _f32_outputs(2, b, nq, c, g.device)
    if b * nq == 0:
        return tuple(outs)
    _launch("cl3d_gather_sub_minmax", what, (g, d, idx, mask),
            (b, nq, ns, c, k), g.dtype == torch.bfloat16, outs, g)
    gather_sub_minmax_cuda.launches += 1
    return tuple(outs)


gather_sub_minmax_cuda.launches = 0


def gather_sub_minmax_bwd_cuda(g, d, idx, mask, hmax, hmin, dmax, dmin):
    """Launch the backward of K7: (dg [B, Ns, C] in g's dtype, dd
    [B, Nq, C] in d's dtype), from the forward's hmax/hmin and the two f32
    cotangents. Two device kernels (``launch_backward_gather``): the
    reverse index of idx/mask in query tiles beside query groups that
    count the ties and write each query's two shares and dd, then a gather
    per support row that writes each row once; equal to
    ``gather_sub_minmax_bwd_plain`` on CPU copies to the bit where the
    cotangents are finite. Raises on anything it does not take."""
    what = "gather_sub_minmax_bwd_cuda"
    f32 = torch.float32
    b, nq, ns, c, k = _check_call(
        what, g, idx, mask,
        query=[(d, g.dtype)] + [(t, f32) for t in (hmax, hmin, dmax, dmin)])
    if b * nq == 0:
        return g.new_zeros(g.shape), torch.empty_like(d)
    # launch 1's two f32 shares a (query, channel): csrc kShareFloats
    shares = torch.empty((b, nq, 2 * c), dtype=f32, device=g.device)
    dd = torch.empty((b, nq, c), dtype=d.dtype, device=g.device)
    dg = launch_backward_gather(
        SOURCE, what, (g, d, idx, mask, hmax, hmin, dmax, dmin),
        (b, nq, ns, c, k), d, 0.0, "avg", name="gather_sub_minmax",
        scratch=shares, out_dtype=g.dtype, extra_outputs=(dd,))
    gather_sub_minmax_bwd_cuda.launches += 1
    return dg, dd


gather_sub_minmax_bwd_cuda.launches = 0


def neighborhood_sum_cuda(f, idx, mask):
    """Launch the forward of K13 in ``csrc/gather_reduce.cu``: [B, Nq, C]
    in f's dtype. Raises on anything it does not take."""
    what = "neighborhood_sum_cuda"
    b, nq, ns, c, k = _check_call(what, f, idx, mask)
    out = torch.empty((b, nq, c), dtype=f.dtype, device=f.device)
    if b * nq == 0:
        return out
    _launch("cl3d_neighborhood_sum", what, (f, idx, mask), (b, nq, ns, c, k),
            f.dtype == torch.bfloat16, (out,), f)
    neighborhood_sum_cuda.launches += 1
    return out


neighborhood_sum_cuda.launches = 0


def neighborhood_sum_bwd_cuda(idx, mask, dy, ns: int):
    """Launch the backward of K13: df [B, Ns, C] in dy's dtype (f's), from
    the cotangent dy [B, Nq, C], in one launch that writes every row.
    Raises on anything it does not take."""
    what = "neighborhood_sum_bwd_cuda"
    # dy [B, Nq, C] takes the checks of the forward's f [B, Ns, C]
    b, nq, _, c, k = _check_call(what, dy, idx, mask)
    kernels.require(dy.shape[1] == nq,
                    f"{what}: shapes do not fit dy [B,Nq,C], idx [B,Nq,K]")
    kernels.require(ns >= 1, f"{what}: need Ns >= 1, got {ns}")
    if b * nq == 0:
        return torch.zeros((b, ns, c), dtype=dy.dtype, device=dy.device)
    df = torch.empty((b, ns, c), dtype=dy.dtype, device=dy.device)
    _launch("cl3d_neighborhood_sum_bwd", what, (idx, mask, dy),
            (b, nq, ns, c, k), dy.dtype == torch.bfloat16, (df,), dy)
    neighborhood_sum_bwd_cuda.launches += 1
    return df


neighborhood_sum_bwd_cuda.launches = 0


# ---- differentiable ops --------------------------------------------------------

class _PwmlpStats(torch.autograd.Function):
    """K6 forward and backward as one differentiable op (the JAX
    ``_pwstats_vjp``)."""

    @staticmethod
    def forward(ctx, g, gsq, idx, mask):
        outs = pwmlp_minmax_stats_cuda(g, gsq, idx, mask)
        ctx.save_for_backward(g, idx, mask, outs[0], outs[1])
        return outs

    @staticmethod
    def backward(ctx, dmax, dmin, ds1, ds2):
        dg = dgsq = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            g, idx, mask, gmax, gmin = ctx.saved_tensors
            dg, dgsq = pwmlp_minmax_stats_bwd_cuda(
                g, idx, mask, gmax, gmin, *(t.contiguous()
                                            for t in (dmax, dmin, ds1, ds2)))
        return dg, dgsq, None, None


class _GatherSubMinmax(torch.autograd.Function):
    """K7 forward and backward as one differentiable op (the JAX
    ``_mm_vjp``)."""

    @staticmethod
    def forward(ctx, g, d, idx, mask):
        hmax, hmin = _gather_sub_minmax_op(g, d, idx, mask)
        ctx.save_for_backward(g, d, idx, mask, hmax, hmin)
        return hmax, hmin

    @staticmethod
    def backward(ctx, dmax, dmin):
        dg = dd = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            g, d, idx, mask, hmax, hmin = ctx.saved_tensors
            dg, dd = gather_sub_minmax_bwd_cuda(
                g, d, idx, mask, hmax, hmin, dmax.contiguous(),
                dmin.contiguous())
        return dg, dd, None, None


class _NeighborhoodSum(torch.autograd.Function):
    """K13 forward and backward as one differentiable op (the JAX
    ``_sum_vjp``)."""

    @staticmethod
    def forward(ctx, f, idx, mask):
        out = neighborhood_sum_cuda(f, idx, mask)
        ctx.save_for_backward(idx, mask)
        ctx.ns = f.shape[1]
        return out

    @staticmethod
    def backward(ctx, dy):
        df = None
        if ctx.needs_input_grad[0]:
            idx, mask = ctx.saved_tensors
            df = neighborhood_sum_bwd_cuda(idx, mask, dy.contiguous(), ctx.ns)
        return df, None, None


def neighborhood_sum(f, idx, mask):
    """[B, Nq, C] in f's dtype, 0 where a neighborhood is empty: the masked
    sum of f[idx] over the slots, accumulated in f32 (a support index that
    repeats counts once per slot). f [B,Ns,C] bf16 or f32; idx [B,Nq,K]
    int32; mask [B,Nq,K] bool. Differentiable in f."""
    if use_kernel(f):
        return _NeighborhoodSum.apply(f, idx, mask)
    return neighborhood_sum_plain(f, idx, mask)


def pwmlp_minmax_stats(g, gsq, idx, mask, queries=None):
    """(gmax, gmin, s1, s2), each [B, Nq, C] f32 and 0 where a
    neighborhood is empty: masked max, min and sum of g[idx] and masked sum
    of gsq[idx]. g, gsq [B,Ns,C] in one dtype (bf16 or f32; gsq is g² in
    f32 rounded to that dtype, an input of its own, so that its gradient
    reaches g through the caller's ``g * g``); idx [B,Nq,K] int32; mask
    [B,Nq,K] bool. Differentiable in g and gsq.

    Where ``queries`` (default B·Nq; under data parallelism the global
    batch's) is at most ``K13_ROUTE_MAX_QUERIES`` the sums come from
    ``neighborhood_sum`` over [g, gsq] in g's dtype and the extrema from
    ``gather_sub_minmax`` against zeros, as the JAX package composes them
    there (see the module's note); elsewhere K6 gives all four."""
    b, nq, _ = idx.shape
    if (b * nq if queries is None else queries) <= K13_ROUTE_MAX_QUERIES:
        c = g.shape[2]
        s = neighborhood_sum(torch.cat([g, gsq], dim=-1), idx, mask)
        hmax, hmin = gather_sub_minmax(g, g.new_zeros((b, nq, c)), idx, mask)
        return hmax, hmin, s[..., :c].float(), s[..., c:].float()
    if use_kernel(g):
        return _PwmlpStats.apply(g, gsq, idx, mask)
    return pwmlp_minmax_stats_plain(g, gsq, idx, mask)


def gather_sub_minmax(g, d, idx, mask):
    """(hmax, hmin), each [B, Nq, C] f32 and 0 where a neighborhood is
    empty: masked max and min of h = g[idx] - d, computed in f32. g
    [B,Ns,C] and d [B,Nq,C] in one dtype (bf16 or f32); idx [B,Nq,K]
    int32; mask [B,Nq,K] bool. Differentiable in g and d. The forward is
    the op ``cl3d::gather_sub_minmax`` (``ops/library.py``), which the
    ``autograd.Function`` calls and, where grad is off, this function."""
    if not torch.is_grad_enabled():
        return _gather_sub_minmax_op(g, d, idx, mask)
    if use_kernel(g):
        return _GatherSubMinmax.apply(g, d, idx, mask)
    return gather_sub_minmax_plain(g, d, idx, mask)


def _gather_sub_minmax_impl(g, d, idx, mask):
    fwd = gather_sub_minmax_cuda if use_kernel(g) else gather_sub_minmax_plain
    return library.contiguous(*fwd(g, d, idx, mask))


def _gather_sub_minmax_fake(g, d, idx, mask):
    shape = (*idx.shape[:2], g.shape[-1])
    return (g.new_empty(shape, dtype=torch.float32),
            g.new_empty(shape, dtype=torch.float32))


_gather_sub_minmax_op = library.define(
    "gather_sub_minmax(Tensor g, Tensor d, Tensor idx, Tensor mask) "
    "-> (Tensor, Tensor)", _gather_sub_minmax_impl, _gather_sub_minmax_fake)
