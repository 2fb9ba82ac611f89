"""Morton (Z-order) codes, keys and the device sort, in PyTorch.

A copy of ``closerlook3d_tpu/ops/spatial.py``: ``morton_code`` (the grid
subsampling, ``ops/sampling.py``, emits voxels in Z-order), and
``morton_keys``, ``morton_sort`` and ``apply_permutation``, the model's
sort on the device for ``spatial_sort`` "always" and "auto" above 2048
points (``models/build.py``). Sorting is for speed only: every op is
mask-correct for any order, and the kernels prune tiles better when
neighbors sit close in the cloud. Plain ATen on both devices, as in the
JAX package (no Pallas kernel computes the sort there).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

MORTON_BITS = 10  # bits per axis: 3 * 10 = 30 bits fit int32
_SENTINEL = 2**30  # sorts after every valid 30-bit code


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 x so consecutive bits are 3 apart."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_code(cells: torch.Tensor) -> torch.Tensor:
    """Interleave [..., 3] int32 cell coordinates (< 1024) into Z-order
    codes [...] int32."""
    cx = _part1by2(cells[..., 0])
    cy = _part1by2(cells[..., 1])
    cz = _part1by2(cells[..., 2])
    return cx | (cy << 1) | (cz << 2)


def morton_keys(xyz: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """[B, N] int32 Z-order key per point, quantized to 10 bits an axis
    over each cloud's bounding box of valid points; invalid points get a
    sentinel that sorts after every valid key."""
    x = xyz.float()
    if mask is None:
        mask = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    m = mask[..., None]
    big = 1e10
    mins = torch.where(m, x, big).amin(dim=-2, keepdim=True)
    maxs = torch.where(m, x, -big).amax(dim=-2, keepdim=True)
    extent = (maxs - mins).amax(dim=-1, keepdim=True).clamp_min(1e-9)
    # a true division, as the JAX package's (a Python number over a tensor
    # would take the reciprocal and multiply, another rounding)
    scale = torch.full_like(extent, 2**MORTON_BITS - 1) / extent
    cells = ((x - mins) * scale).clamp(0, 2**MORTON_BITS - 1).to(
        torch.int32)
    return morton_code(cells).masked_fill(~mask, _SENTINEL)


def morton_sort(xyz: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, inv_perm), both [B, N] int32: the permutation that sorts each
    cloud along the Z-order curve, invalid points last, and its inverse.
    ``apply_permutation(x, perm)`` sorts, ``apply_permutation(sorted,
    inv_perm)`` restores. Both argsorts are stable, as ``jnp.argsort``
    is, so equal keys (repeated points, every masked point) keep their
    order and the permutation equals the JAX package's."""
    keys = morton_keys(xyz, mask)
    perm = torch.argsort(keys, dim=-1, stable=True)
    inv = torch.argsort(perm, dim=-1, stable=True)
    return perm.to(torch.int32), inv.to(torch.int32)


def apply_permutation(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Gather rows of [B, N, ...] (or [B, N]) by a [B, N] permutation."""
    idx = perm.long().reshape(*perm.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(*perm.shape, *x.shape[2:]))
