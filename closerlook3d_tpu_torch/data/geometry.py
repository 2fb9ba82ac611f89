"""Host geometry precompute (``closerlook3d_tpu/data/geometry.py``).

With ``cfg.precompute_geometry: true`` every batch carries the whole
geometry of its forward (each stage's positions and masks, the neighbor,
strided and upsample indices), computed on the host's CPU by the model's
own ``models/backbone.py::compute_geometry`` on CPU tensors (the plain
versions of the kernels), so the two paths cannot diverge. The keys take
a ``geom_`` prefix; ``train/step.py`` gives them back to the model, which
then runs no neighbor search or sampling and does not sort.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

GEOM_PREFIX = "geom_"
# per-cloud batch keys, never permuted
_NON_POINT_KEYS = ("label", "category", "batch_pad")


@torch.no_grad()
def precompute_batch_geometry(batch: Dict[str, np.ndarray], cfg
                              ) -> Dict[str, np.ndarray]:
    """Add the ``geom_*`` keys (numpy) to a stacked batch dict, in place.

    Unless ``cfg.spatial_sort`` is "never", each cloud is Morton-sorted
    first (``ops/spatial.py::morton_sort`` on the CPU), and every per-point
    array, labels included, is permuted with it so losses and metrics
    line up: the model skips its own sort when geometry is supplied.
    """
    from closerlook3d_tpu_torch.models.backbone import compute_geometry
    from closerlook3d_tpu_torch.ops.spatial import morton_sort

    if getattr(cfg, "spatial_sort", "auto") != "never":
        perm, _ = morton_sort(torch.from_numpy(batch["xyz"]),
                              torch.from_numpy(batch["mask"]))
        perm = perm.numpy()
        n = batch["xyz"].shape[1]
        bidx = np.arange(perm.shape[0])[:, None]
        for k, v in list(batch.items()):
            if (k not in _NON_POINT_KEYS and getattr(v, "ndim", 0) >= 2
                    and v.shape[1] == n):
                batch[k] = v[bidx, perm]
    g = compute_geometry(cfg, torch.from_numpy(batch["xyz"]),
                         torch.from_numpy(batch["mask"]),
                         need_up="segmentation" in cfg.task)
    for k, v in g.items():
        batch[GEOM_PREFIX + k] = v.numpy()
    return batch
