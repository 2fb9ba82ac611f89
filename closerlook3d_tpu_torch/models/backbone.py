"""5-stage residual point trunk (encoder).

Counterpart of ``closerlook3d_tpu/models/backbone.py``:
  * stem: 1x1 conv to width/2 -> one LocalAggregation -> one bottleneck
    to width, at full resolution;
  * stages s=1..4: one strided bottleneck (x4 point downsampling,
    channels x2) + ``depth`` residual bottlenecks;
  * bottleneck = 1x1 reduce -> LocalAggregation -> 1x1 expand + shortcut
    (masked max over the neighborhood for strided blocks), ReLU after the
    residual add;
  * the ball-query radius doubles per stage; FPS (shape tasks) or grid
    barycenters (``sampling: grid``, scene tasks) downsample.
Neighbor indices are computed once per stage and reused by every block of
the stage; segmentation models also get each stage's 1-NN upsample
indices for the decoder. Flax infers input widths; here each module is
built with them.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from closerlook3d_tpu_torch.data.loader import feature_dim
from closerlook3d_tpu_torch.models.aggregation import LocalAggregation
from closerlook3d_tpu_torch.models.nn_utils import ConvBN, compute_dtype
from closerlook3d_tpu_torch.ops.grouping import neighborhood_max
from closerlook3d_tpu_torch.ops.neighbors import ball_query, knn
from closerlook3d_tpu_torch.ops.sampling import (
    furthest_point_sample, grid_subsample)
from closerlook3d_tpu_torch.utils.config import stage_plan


class StageOutput(NamedTuple):
    xyz: torch.Tensor  # [B, N_s, 3]
    mask: torch.Tensor  # [B, N_s]
    features: torch.Tensor  # [B, N_s, C_s]
    # decoder: index of each stage-s point's nearest stage-(s+1) point
    # (None for the last stage and for classification models)
    up_idx: Optional[torch.Tensor] = None  # [B, N_s] int32


def compute_geometry(cfg, xyz: torch.Tensor, mask: torch.Tensor,
                     need_up: bool = False) -> Dict[str, torch.Tensor]:
    """All irregular geometry of one forward pass, as a flat dict.

    Keys: xyz_s/mask_s [B,N_s(,3)], idx_s/nmask_s (same-resolution
    neighbors), sidx_s/smask_s (strided, coarse into fine, s >= 1), and
    with ``need_up`` up_s [B,N_s] (s < last: each stage-s point's nearest
    valid stage-(s+1) point, the masked 1-NN).
    """
    if cfg.sampling not in ("fps", "grid"):
        raise ValueError(f"unknown sampling {cfg.sampling!r}")
    plan = stage_plan(cfg)
    npoints, radii, nsamples = plan["npoints"], plan["radii"], plan["nsamples"]
    cells = plan["cells"]
    xyz = xyz.float()

    g = {"xyz_0": xyz, "mask_0": mask}
    g["idx_0"], g["nmask_0"] = ball_query(
        xyz, xyz, radii[0], nsamples[0], query_mask=mask, support_mask=mask)
    prev_xyz, prev_mask = xyz, mask
    for s in range(1, len(nsamples)):
        if cfg.sampling == "fps":
            fidx, new_mask = furthest_point_sample(prev_xyz, npoints[s],
                                                   prev_mask)
            new_xyz = torch.gather(prev_xyz, 1, fidx.to(torch.int64)[
                ..., None].expand(-1, -1, 3))
        else:
            new_xyz, new_mask = grid_subsample(prev_xyz, cells[s],
                                               npoints[s], prev_mask)
        g[f"sidx_{s}"], g[f"smask_{s}"] = ball_query(
            new_xyz, prev_xyz, radii[s - 1] * 2.0, nsamples[s - 1],
            query_mask=new_mask, support_mask=prev_mask)
        g[f"idx_{s}"], g[f"nmask_{s}"] = ball_query(
            new_xyz, new_xyz, radii[s], nsamples[s], query_mask=new_mask,
            support_mask=new_mask)
        g[f"xyz_{s}"], g[f"mask_{s}"] = new_xyz, new_mask
        prev_xyz, prev_mask = new_xyz, new_mask
    if need_up:
        for s in range(len(nsamples) - 1):
            up, _ = knn(g[f"xyz_{s}"], g[f"xyz_{s + 1}"], 1,
                        support_mask=g[f"mask_{s + 1}"])
            g[f"up_{s}"] = up[..., 0]
    return g


class Bottleneck(nn.Module):
    """Residual bottleneck block around one LocalAggregation."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 config, strided: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = out_channels // config.bottleneck_ratio
        mom = config.batchnorm_momentum
        self.strided = strided
        self.reduce = ConvBN(in_channels, mid, mom, dtype=dtype)
        self.agg = LocalAggregation(mid, mid, radius, config, dtype=dtype)
        self.expand = ConvBN(mid, out_channels, mom, activation=False,
                             dtype=dtype)
        self.shortcut = None
        if in_channels != out_channels:
            self.shortcut = ConvBN(in_channels, out_channels, mom,
                                   activation=False, dtype=dtype)

    def forward(self, query_xyz, query_mask, support_xyz, support_mask,
                support_features, neighbor_idx, neighbor_mask):
        x = self.reduce(support_features)
        x = self.agg(query_xyz, support_xyz, x, neighbor_idx, neighbor_mask)
        x = self.expand(x)
        if self.strided:
            shortcut = neighborhood_max(support_features, neighbor_idx,
                                        neighbor_mask)
        else:
            shortcut = support_features
        if self.shortcut is not None:
            shortcut = self.shortcut(shortcut)
        out = F.relu(x + shortcut)
        return out * query_mask[..., None].to(out.dtype)


class ResNetBackbone(nn.Module):
    """Encoder: per-stage (xyz, mask, features).

    ``blocks`` holds the bottlenecks in the order flax creates them
    (``Bottleneck_0`` is the stem's), which ``convert.py`` relies on.
    """

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.dtype = compute_dtype(config)
        plan = stage_plan(config)
        radii, widths = plan["radii"], plan["widths"]
        self.nstage = len(plan["nsamples"])
        mom = config.batchnorm_momentum
        w0 = widths[0]
        self.stem = ConvBN(feature_dim(config.input_features), w0 // 2, mom,
                           dtype=self.dtype)
        self.stem_agg = LocalAggregation(w0 // 2, w0 // 2, radii[0], config,
                                         dtype=self.dtype)
        blocks = [Bottleneck(w0 // 2, w0, radii[0], config, dtype=self.dtype)]
        for s in range(1, self.nstage):
            blocks.append(Bottleneck(widths[s - 1], widths[s],
                                     radii[s - 1] * 2.0, config, strided=True,
                                     dtype=self.dtype))
            for _ in range(config.depth):
                blocks.append(Bottleneck(widths[s], widths[s], radii[s],
                                         config, dtype=self.dtype))
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = widths[-1]

    def forward(self, xyz, mask, features, geometry=None
                ) -> List[StageOutput]:
        g = geometry if geometry is not None else compute_geometry(
            self.config, xyz, mask,
            need_up="segmentation" in self.config.task)
        blocks = iter(self.blocks)
        outputs: List[StageOutput] = []

        xyz, mask = g["xyz_0"], g["mask_0"]
        idx, nmask = g["idx_0"], g["nmask_0"]
        feats = self.stem(features.to(self.dtype))
        feats = self.stem_agg(xyz, xyz, feats, idx, nmask)
        feats = next(blocks)(xyz, mask, xyz, mask, feats, idx, nmask)
        outputs.append(StageOutput(xyz, mask, feats, g.get("up_0")))

        for s in range(1, self.nstage):
            new_xyz, new_mask = g[f"xyz_{s}"], g[f"mask_{s}"]
            feats = next(blocks)(new_xyz, new_mask, xyz, mask, feats,
                                 g[f"sidx_{s}"], g[f"smask_{s}"])
            xyz, mask = new_xyz, new_mask
            idx, nmask = g[f"idx_{s}"], g[f"nmask_{s}"]
            for _ in range(self.config.depth):
                feats = next(blocks)(xyz, mask, xyz, mask, feats, idx, nmask)
            outputs.append(StageOutput(xyz, mask, feats, g.get(f"up_{s}")))
        return outputs
