"""Morton (Z-order) codes of voxel coordinates, in PyTorch.

A copy of ``closerlook3d_tpu/ops/spatial.py::morton_code`` for the grid
subsampling (``ops/sampling.py``), which emits voxels in Z-order. The
device-side sort of whole clouds (``morton_sort``) is not ported: the data
pipeline sorts on the host (``data/spatial_host.py``).
"""

from __future__ import annotations

import torch

MORTON_BITS = 10  # bits per axis: 3 * 10 = 30 bits fit int32


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
