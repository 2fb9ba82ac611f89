"""Masked ordered ball query and k nearest neighbors over padded clouds.

Ball query: for each query point, up to ``nsample`` support points within
``radius``, sorted by ascending squared distance (lowest index first on
ties), invalid slots padded with the nearest support's index, plus a
validity mask. k-NN: the k nearest supports, ascending, with their
squared distances; masked supports sit 1e10 further away. Same
semantics, layouts and dtypes as ``closerlook3d_tpu/ops/neighbors.py``'s
``ball_query`` and ``knn`` (its jnp path): ``[B, N, 3]`` f32 points,
``[B, N]`` bool masks, ``[B, Nq, K]`` int32 indices.

``ball_query`` runs the CUDA kernel of ``csrc/ball_query.cu`` and ``knn``
that of ``csrc/knn.cu`` on CUDA tensors, the plain PyTorch versions on
CPU tensors, each through its op ``cl3d::ball_query`` or ``cl3d::knn``
(``ops/library.py``). The ball query and the 1-NN from 1024 supports up
share one exact pruned nearest-support search
(``csrc/support_tiles.cuh``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from closerlook3d_tpu_torch.ops import kernels, library
from closerlook3d_tpu_torch.ops.dispatch import use_kernel

_BIG = 1e10  # exactly representable in f32 (2^10 * 9765625)
MAX_K = 64  # per-query candidate list held by one thread in the kernel
MAX_KNN = 16  # k-NN list held by one thread in the kernel
# k = 1 over supports of at least this many points takes the route of the
# JAX package's chunked 1-NN kernel (its ops/neighbors.py knn)
KNN1_CHUNKED_MIN_SUPPORT = 1024
# the plain versions take queries in chunks of QUERY_CHUNK from
# CHUNK_MIN_QUERIES queries up (``query_chunk``)
QUERY_CHUNK = 512
CHUNK_MIN_QUERIES = 4096


def _r2(radius: float) -> float:
    """f32(radius) * f32(radius), rounded to f32 as the reference does."""
    return float(np.float32(radius) * np.float32(radius))


def pairwise_dist2(query_xyz: torch.Tensor,
                   support_xyz: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[B, Nq, Ns]`` as Σ_d (q_d - s_d)², d = 0, 1, 2.

    Accumulated per coordinate in that order, each product and sum
    rounded to f32, which the CUDA kernel reproduces bit for bit.
    """
    q = query_xyz.float()
    s = support_xyz.float()
    d2 = None
    for d in range(3):
        diff = q[..., :, None, d] - s[..., None, :, d]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def _topk_neighbors(d2: torch.Tensor, nsample: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest entries of the last axis, lowest index first on ties.

    When the support set is smaller than nsample, the extra slots repeat
    the nearest index at distance BIG so the radius test masks them out.
    """
    k = min(nsample, d2.shape[-1])
    d2s, order = torch.sort(d2, dim=-1, stable=True)
    d2k, idx = d2s[..., :k], order[..., :k].to(torch.int32)
    if k < nsample:
        pad = nsample - k
        d2k = torch.cat([d2k, d2k.new_full((*d2k.shape[:-1], pad), _BIG)], -1)
        idx = torch.cat([idx, idx[..., :1].expand(*idx.shape[:-1], pad)], -1)
    return d2k, idx


def query_chunk(nq: int) -> Optional[int]:
    """Queries per chunk of the plain ball query and k-NN: 512 from 4096
    queries up (the JAX backbone's ``_chunk_for``), else None (one
    block)."""
    return QUERY_CHUNK if nq >= CHUNK_MIN_QUERIES else None


def _by_query_chunks(fn, query_xyz, chunk_size: Optional[int]):
    """``fn(query rows)`` over slices of at most ``chunk_size`` queries,
    concatenated along the query axis (the last slice may be shorter);
    one call when ``chunk_size`` is None or covers every query. Rows are
    independent, so the result equals the unchunked one bit for bit."""
    nq = query_xyz.shape[1]
    if chunk_size is None or nq <= chunk_size:
        return fn(query_xyz)
    parts = [fn(query_xyz[:, i:i + chunk_size])
             for i in range(0, nq, chunk_size)]
    return tuple(torch.cat(ts, dim=1) for ts in zip(*parts))


def _support_bias(support_mask):
    if support_mask is None:
        return None
    return torch.where(support_mask, 0.0, _BIG).to(torch.float32)[:, None, :]


def ball_query_plain(query_xyz, support_xyz, radius: float, nsample: int,
                     query_mask=None, support_mask=None,
                     chunk_size: Optional[int] = None):
    """Plain PyTorch ball query (the jnp reference's arithmetic), over
    query chunks of ``chunk_size`` (None: all at once). A chunk holds its
    [B, chunk, Ns] f32 d2 and the stable sort's f32 values and int64
    order at once, 16 bytes a (query, support) pair: 0.92 GiB for a chunk
    of 8 x 512 queries over 15000 supports (S3DIS stage 0), where the
    unchunked stage would hold 27 GiB."""
    bias = _support_bias(support_mask)

    def block(q):
        d2 = pairwise_dist2(q, support_xyz)
        if bias is not None:
            d2 = d2 + bias
        d2k, idx = _topk_neighbors(d2, nsample)
        valid = d2k <= _r2(radius)
        return torch.where(valid, idx, idx[..., :1]), valid

    idx, valid = _by_query_chunks(block, query_xyz, chunk_size)
    if query_mask is not None:
        valid = valid & query_mask[..., None]
    return idx, valid


def ball_query_cuda(query_xyz, support_xyz, radius: float, nsample: int,
                    query_mask=None, support_mask=None):
    """Launch ``csrc/ball_query.cu`` (its preparation pass, then its query
    kernel); raises on anything it does not take."""
    what = "ball_query_cuda"
    b, nq, _ = query_xyz.shape
    ns = support_xyz.shape[1]
    if query_mask is None:
        query_mask = torch.ones((b, nq), dtype=torch.bool,
                                device=query_xyz.device)
    if support_mask is None:
        support_mask = torch.ones((b, ns), dtype=torch.bool,
                                  device=support_xyz.device)
    kernels.require_cuda(what, query_xyz=query_xyz, support_xyz=support_xyz,
                         query_mask=query_mask, support_mask=support_mask)
    kernels.require(query_xyz.dtype == torch.float32
                    and support_xyz.dtype == torch.float32,
                    f"{what}: points must be float32")
    kernels.require(query_mask.dtype == torch.bool
                    and support_mask.dtype == torch.bool,
                    f"{what}: masks must be bool")
    kernels.require(query_xyz.shape == (b, nq, 3)
                    and support_xyz.shape == (b, ns, 3)
                    and query_mask.shape == (b, nq)
                    and support_mask.shape == (b, ns),
                    f"{what}: shapes {tuple(query_xyz.shape)}, "
                    f"{tuple(support_xyz.shape)}, {tuple(query_mask.shape)}, "
                    f"{tuple(support_mask.shape)} do not fit [B,Nq,3], "
                    f"[B,Ns,3], [B,Nq], [B,Ns]")
    kernels.require(1 <= nsample <= MAX_K,
                    f"{what}: nsample {nsample} outside [1, {MAX_K}]")
    kernels.require(ns >= 1 and b <= 65535, f"{what}: need 1 <= Ns and "
                    f"B <= 65535, got Ns={ns}, B={b}")
    idx = torch.empty((b, nq, nsample), dtype=torch.int32,
                      device=query_xyz.device)
    valid = torch.empty((b, nq, nsample), dtype=torch.bool,
                        device=query_xyz.device)
    if b * nq == 0:
        return idx, valid
    # the kernel's scratch (packed supports, tile and chunk boxes);
    # torch.empty's blocks are 512-byte aligned, as its float4s need
    _, ws_floats = kernels.entry("ball_query",
                                 "cl3d_ball_query_workspace_floats",
                                 [kernels.I, kernels.I], kernels.L)
    work = torch.empty(ws_floats(b, ns), dtype=torch.float32,
                       device=query_xyz.device)
    lib, fn = kernels.entry(
        "ball_query", "cl3d_ball_query",
        [kernels.P] * 4 + [kernels.I] * 4 + [kernels.F] + [kernels.P] * 3
        + [kernels.L, kernels.P])
    with torch.cuda.device(query_xyz.device):
        err = fn(query_xyz.data_ptr(), support_xyz.data_ptr(),
                 query_mask.data_ptr(), support_mask.data_ptr(),
                 b, nq, ns, nsample, _r2(radius),
                 idx.data_ptr(), valid.data_ptr(), work.data_ptr(),
                 work.numel(), kernels.stream_of(idx))
    kernels.check(lib, err, what)
    ball_query_cuda.launches += 1
    return idx, valid


ball_query_cuda.launches = 0


def ball_query(
    query_xyz: torch.Tensor,
    support_xyz: torch.Tensor,
    radius: float,
    nsample: int,
    query_mask: Optional[torch.Tensor] = None,
    support_mask: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked ordered ball query over padded batches.

    Args:
      query_xyz:    [B, Nq, 3] float32.
      support_xyz:  [B, Ns, 3] float32.
      radius:       search radius.
      nsample:      max neighbors K.
      query_mask:   [B, Nq] bool, True = real point.
      support_mask: [B, Ns] bool.
      chunk_size:   queries per chunk of the plain version (None: all);
                    the kernel holds no [Nq, Ns] buffer and ignores it.

    Returns:
      idx  [B, Nq, K] int32: ascending-distance neighbor indices; invalid
           slots hold the nearest support's index.
      mask [B, Nq, K] bool: True where the slot is a real in-radius
           neighbor of a real query point.
    """
    return _ball_query_op(query_xyz, support_xyz, float(radius),
                          int(nsample), query_mask, support_mask, chunk_size)


def _ball_query_impl(query_xyz, support_xyz, radius, nsample, query_mask,
                     support_mask, chunk_size):
    if use_kernel(query_xyz):
        return ball_query_cuda(query_xyz, support_xyz, radius, nsample,
                               query_mask, support_mask)
    return library.contiguous(*ball_query_plain(
        query_xyz, support_xyz, radius, nsample, query_mask, support_mask,
        chunk_size))


def _ball_query_fake(query_xyz, support_xyz, radius, nsample, query_mask,
                     support_mask, chunk_size):
    shape = (*query_xyz.shape[:2], nsample)
    return (query_xyz.new_empty(shape, dtype=torch.int32),
            query_xyz.new_empty(shape, dtype=torch.bool))


_ball_query_op = library.define(
    "ball_query(Tensor query_xyz, Tensor support_xyz, float radius, "
    "int nsample, Tensor? query_mask, Tensor? support_mask, "
    "int? chunk_size) -> (Tensor, Tensor)",
    _ball_query_impl, _ball_query_fake)


def knn_plain(query_xyz, support_xyz, k: int, support_mask=None,
              chunk_size: Optional[int] = None):
    """Plain PyTorch k-NN (the jnp reference's arithmetic): a stable sort
    of d2 (``torch.topk``'s order on ties is unspecified), over query
    chunks of ``chunk_size`` as ``ball_query_plain``."""
    bias = _support_bias(support_mask)

    def block(q):
        d2 = pairwise_dist2(q, support_xyz)
        if bias is not None:
            d2 = d2 + bias
        d2k, idx = _topk_neighbors(d2, k)
        return idx, d2k

    return _by_query_chunks(block, query_xyz, chunk_size)


def _knn_launch(what: str, query_xyz, support_xyz, k: int, support_mask):
    """Launch ``csrc/knn.cu``; raises on anything it does not take."""
    b, nq, _ = query_xyz.shape
    ns = support_xyz.shape[1]
    if support_mask is None:
        support_mask = torch.ones((b, ns), dtype=torch.bool,
                                  device=support_xyz.device)
    kernels.require_cuda(what, query_xyz=query_xyz, support_xyz=support_xyz,
                         support_mask=support_mask)
    kernels.require(query_xyz.dtype == torch.float32
                    and support_xyz.dtype == torch.float32,
                    f"{what}: points must be float32")
    kernels.require(support_mask.dtype == torch.bool,
                    f"{what}: support_mask must be bool")
    kernels.require(query_xyz.shape == (b, nq, 3)
                    and support_xyz.shape == (b, ns, 3)
                    and support_mask.shape == (b, ns),
                    f"{what}: shapes {tuple(query_xyz.shape)}, "
                    f"{tuple(support_xyz.shape)}, "
                    f"{tuple(support_mask.shape)} do not fit [B,Nq,3], "
                    f"[B,Ns,3], [B,Ns]")
    kernels.require(1 <= k <= MAX_KNN,
                    f"{what}: k {k} outside [1, {MAX_KNN}]")
    kernels.require(ns >= 1 and b <= 65535, f"{what}: need 1 <= Ns and "
                    f"B <= 65535, got Ns={ns}, B={b}")
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=query_xyz.device)
    d2 = torch.empty((b, nq, k), dtype=torch.float32,
                     device=query_xyz.device)
    if b * nq == 0:
        return idx, d2
    # the pruned 1-NN's scratch (packed supports, tile and chunk boxes;
    # none for the all-pairs kernels), 512-byte aligned as torch.empty's
    # blocks are
    _, ws_floats = kernels.entry("knn", "cl3d_knn_workspace_floats",
                                 [kernels.I] * 3, kernels.L)
    n_ws = ws_floats(b, ns, k)
    work = (torch.empty(n_ws, dtype=torch.float32, device=query_xyz.device)
            if n_ws else None)
    lib, fn = kernels.entry("knn", "cl3d_knn",
                            [kernels.P] * 3 + [kernels.I] * 4
                            + [kernels.P] * 3 + [kernels.L, kernels.P])
    with torch.cuda.device(query_xyz.device):
        err = fn(query_xyz.data_ptr(), support_xyz.data_ptr(),
                 support_mask.data_ptr(), b, nq, ns, k, idx.data_ptr(),
                 d2.data_ptr(), work.data_ptr() if n_ws else None, n_ws,
                 kernels.stream_of(idx))
    kernels.check(lib, err, what)
    return idx, d2


def knn_device_ops(ns: int, k: int) -> int:
    """Device ops one call of ``csrc/knn.cu`` launches over ``ns``
    supports at this ``k``, as its C entry reports them: 2 for the pruned
    1-NN (the preparation, then the search), 1 for the all-pairs
    kernels."""
    _, fn = kernels.entry("knn", "cl3d_knn_device_ops", [kernels.I] * 2)
    return fn(ns, k)


def knn1_cuda(query_xyz, support_xyz, k: int = 1, support_mask=None):
    """The 1-NN over large supports (the route of the JAX package's
    chunked 1-NN kernel): ``csrc/knn.cu`` with k = 1, its exact pruned
    search over tile boxes (2 device ops a call, ``knn_device_ops``)."""
    kernels.require(k == 1, f"knn1_cuda: k must be 1, got {k}")
    out = _knn_launch("knn1_cuda", query_xyz, support_xyz, 1, support_mask)
    knn1_cuda.launches += 1
    return out


knn1_cuda.launches = 0


def knn_cuda(query_xyz, support_xyz, k: int, support_mask=None):
    """Every other k-NN (the route of the JAX package's k-NN kernel):
    ``csrc/knn.cu``."""
    out = _knn_launch("knn_cuda", query_xyz, support_xyz, k, support_mask)
    knn_cuda.launches += 1
    return out


knn_cuda.launches = 0


def knn(
    query_xyz: torch.Tensor,
    support_xyz: torch.Tensor,
    k: int,
    support_mask: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbors: (idx [B,Nq,k] int32, dist2 [B,Nq,k] f32).

    Ascending by distance, lowest index first on ties. Masked supports
    (support_mask False) are pushed to +1e10, so they are returned only
    when a cloud has fewer than k valid points; for k > Ns the extra slots
    repeat the nearest index at distance 1e10. ``chunk_size``: queries per
    chunk of the plain version, as ``ball_query``'s.
    """
    return _knn_op(query_xyz, support_xyz, int(k), support_mask, chunk_size)


def _knn_impl(query_xyz, support_xyz, k, support_mask, chunk_size):
    if use_kernel(query_xyz):
        if k == 1 and support_xyz.shape[1] >= KNN1_CHUNKED_MIN_SUPPORT:
            return knn1_cuda(query_xyz, support_xyz, 1, support_mask)
        return knn_cuda(query_xyz, support_xyz, k, support_mask)
    return library.contiguous(*knn_plain(query_xyz, support_xyz, k,
                                         support_mask, chunk_size))


def _knn_fake(query_xyz, support_xyz, k, support_mask, chunk_size):
    shape = (*query_xyz.shape[:2], k)
    return (query_xyz.new_empty(shape, dtype=torch.int32),
            query_xyz.new_empty(shape, dtype=torch.float32))


_knn_op = library.define(
    "knn(Tensor query_xyz, Tensor support_xyz, int k, Tensor? support_mask, "
    "int? chunk_size) -> (Tensor, Tensor)", _knn_impl, _knn_fake)
