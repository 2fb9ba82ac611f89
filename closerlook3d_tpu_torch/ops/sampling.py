"""Greedy furthest point sampling and voxel-grid subsampling over masked
clouds.

Same semantics, layouts and dtypes as
``closerlook3d_tpu/ops/sampling.py``'s ``furthest_point_sample`` and
``grid_subsample``. FPS runs the CUDA kernel (``csrc/fps.cu``) on CUDA
tensors and the plain PyTorch version on CPU tensors. The grid
subsampling has no kernel in either package: it is plain PyTorch on both
devices, with the same arithmetic on both. Each is an op of
``ops/library.py``: ``cl3d::furthest_point_sample``,
``cl3d::grid_subsample``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from closerlook3d_tpu_torch.ops import kernels, library
from closerlook3d_tpu_torch.ops.dispatch import use_kernel
from closerlook3d_tpu_torch.ops.spatial import morton_code

_SENTINEL = 2**30  # voxel key of invalid points: after every 30-bit code


def furthest_point_sample_plain(xyz, npoint: int, mask=None):
    """Plain PyTorch FPS: the jnp reference's loop, step for step."""
    b, n, _ = xyz.shape
    x = xyz.float()
    valid = (torch.ones((b, n), dtype=torch.bool, device=xyz.device)
             if mask is None else mask)
    # invalid points carry mindist -1 forever, so they are never the
    # argmax while an unpicked valid point (mindist > 0) remains
    mindist = torch.where(valid, 1e10, -1.0).to(torch.float32)
    # first valid point; 0 for an all-masked cloud (argmax of all-False)
    cur = torch.argmax(valid.to(torch.int32), dim=1)
    out = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = cur
        sel = torch.gather(x, 1, cur[:, None, None].expand(b, 1, 3))
        diff = x - sel
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
        mindist = torch.minimum(mindist, d)
        cur = torch.argmax(mindist, dim=1)  # first index on ties
    nvalid = valid.sum(dim=1)
    slot = torch.arange(npoint, device=xyz.device)[None, :]
    return out, slot < nvalid[:, None]


def furthest_point_sample_cuda(xyz, npoint: int, mask=None):
    """Launch ``csrc/fps.cu``; raises on anything it does not take."""
    what = "furthest_point_sample_cuda"
    b, n, _ = xyz.shape
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    kernels.require_cuda(what, xyz=xyz, mask=mask)
    kernels.require(xyz.dtype == torch.float32, f"{what}: xyz must be float32")
    kernels.require(mask.dtype == torch.bool, f"{what}: mask must be bool")
    kernels.require(xyz.shape == (b, n, 3) and mask.shape == (b, n),
                    f"{what}: shapes {tuple(xyz.shape)}, {tuple(mask.shape)} "
                    f"do not fit [B,N,3], [B,N]")
    kernels.require(npoint >= 1, f"{what}: npoint must be >= 1")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    smask = torch.empty((b, npoint), dtype=torch.bool, device=xyz.device)
    if b == 0:
        return idx, smask
    lib, fn = kernels.entry(
        "fps", "cl3d_fps",
        [kernels.P, kernels.P, kernels.I, kernels.I, kernels.I,
         kernels.P, kernels.P, kernels.P])
    max_n = lib.cl3d_fps_max_points()
    kernels.require(1 <= n <= max_n, f"{what}: N={n} outside [1, {max_n}]")
    with torch.cuda.device(xyz.device):
        err = fn(xyz.data_ptr(), mask.data_ptr(), b, n, npoint,
                 idx.data_ptr(), smask.data_ptr(), kernels.stream_of(idx))
    kernels.check(lib, err, what)
    furthest_point_sample_cuda.launches += 1
    return idx, smask


furthest_point_sample_cuda.launches = 0


def furthest_point_sample(
    xyz: torch.Tensor,
    npoint: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy furthest point sampling.

    Args:
      xyz:    [B, N, 3] float32.
      npoint: number of points to select.
      mask:   [B, N] bool; invalid points are picked only once a cloud has
        fewer than npoint valid points, and sample_mask marks those slots.

    Returns:
      idx [B, npoint] int32, sample_mask [B, npoint] bool.
    """
    return _fps_op(xyz, int(npoint), mask)


def _fps_impl(xyz, npoint, mask):
    if use_kernel(xyz):
        return furthest_point_sample_cuda(xyz, npoint, mask)
    return furthest_point_sample_plain(xyz, npoint, mask)


def _fps_fake(xyz, npoint, mask):
    shape = (xyz.shape[0], npoint)
    return (xyz.new_empty(shape, dtype=torch.int32),
            xyz.new_empty(shape, dtype=torch.bool))


_fps_op = library.define(
    "furthest_point_sample(Tensor xyz, int npoint, Tensor? mask) "
    "-> (Tensor, Tensor)", _fps_impl, _fps_fake)


def grid_subsample(
    xyz: torch.Tensor,
    cell_size: float,
    max_out: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel-grid barycenter subsampling with a fixed output size, as the
    op ``cl3d::grid_subsample`` (``grid_subsample_plain`` on every
    device): its one host read of the deepest voxel stays inside the op,
    where ``torch.export`` does not trace it.

    Args:
      xyz:  [B, N, 3] float32.
      cell_size: voxel edge length.
      max_out:   output point budget M.
      mask: [B, N] bool.

    Returns:
      sub_xyz [B, M, 3] float32, sub_mask [B, M] bool.
    """
    return _grid_op(xyz, float(cell_size), int(max_out), mask)


def _grid_fake(xyz, cell_size, max_out, mask):
    return (xyz.new_empty((xyz.shape[0], max_out, 3), dtype=torch.float32),
            xyz.new_empty((xyz.shape[0], max_out), dtype=torch.bool))


def grid_subsample_plain(xyz, cell_size: float, max_out: int, mask=None):
    """Voxel-grid barycenter subsampling with a fixed output size.

    Each occupied voxel of side ``cell_size`` (cells counted from the
    cloud's valid minimum, 1024 per axis at most) gives the barycenter of
    its points. Voxels come out in Morton-key order; a cloud with more
    than ``max_out`` occupied voxels drops the highest-keyed ones, one
    with fewer pads with mask False.

    The JAX package sums each voxel's points one after another in sorted
    order (a scatter-add); so does this version, on every device: the
    points of a voxel are contiguous after the stable key sort, are laid
    out by their rank within the voxel, and the ranks are added in order.
    No atomics, so the card's barycenters equal the CPU's bit for bit
    (they feed the ball query, where one ulp can flip a neighbor). The
    loop over ranks needs the deepest voxel's size on the host: one
    synchronization per call on the card.

    Arguments and outputs as ``grid_subsample``'s.
    """
    b, n, _ = xyz.shape
    dev = xyz.device
    x = xyz.float()
    valid = (torch.ones((b, n), dtype=torch.bool, device=dev)
             if mask is None else mask)
    mins = torch.where(valid[..., None], x, 1e10).amin(dim=1, keepdim=True)
    # divide by a tensor: a Python scalar divisor may become a multiply by
    # its reciprocal on CUDA, which rounds differently
    cell = torch.full((), cell_size, dtype=torch.float32, device=dev)
    cells = torch.clamp(torch.floor((x - mins) / cell), 0, 1023).to(
        torch.int32)
    key = torch.where(valid, morton_code(cells), _SENTINEL)
    ksort, order = torch.sort(key, dim=1, stable=True)
    xsort = torch.gather(x, 1, order[..., None].expand(-1, -1, 3))

    newflag = torch.ones_like(ksort, dtype=torch.bool)
    newflag[:, 1:] = ksort[:, 1:] != ksort[:, :-1]
    seg = torch.cumsum(newflag.to(torch.int64), dim=1) - 1  # voxel rank
    # invalid points and voxels beyond the budget go to bucket max_out
    seg = torch.where(ksort < _SENTINEL, seg, max_out).clamp(max=max_out)
    keep = seg < max_out
    pos = torch.arange(n, device=dev).expand(b, n)
    start = torch.cummax(torch.where(newflag, pos, 0), dim=1).values
    rank = torch.where(keep, pos - start, 0)  # position within the voxel
    depth = int(rank.max()) + 1 if n else 1

    bidx = torch.arange(b, device=dev)[:, None].expand(b, n)
    dense = torch.zeros((b, max_out + 1, depth, 3), dtype=torch.float32,
                        device=dev)
    # unique (voxel, rank) per kept point: each slot takes 0 + x exactly
    dense.index_put_((bidx, seg, rank),
                     torch.where(keep[..., None], xsort, 0.0),
                     accumulate=True)
    counts = torch.zeros((b, max_out + 1), dtype=torch.float32, device=dev)
    counts.index_put_((bidx, seg), keep.float(), accumulate=True)  # exact
    sums = dense[:, :max_out, 0]
    for r in range(1, depth):
        sums = sums + dense[:, :max_out, r]
    counts = counts[:, :max_out]
    return sums / torch.clamp(counts, min=1.0)[..., None], counts > 0


def _grid_impl(xyz, cell_size, max_out, mask):
    return library.contiguous(*grid_subsample_plain(xyz, cell_size, max_out,
                                                    mask))


_grid_op = library.define(
    "grid_subsample(Tensor xyz, float cell_size, int max_out, Tensor? mask) "
    "-> (Tensor, Tensor)", _grid_impl, _grid_fake)
