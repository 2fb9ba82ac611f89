"""Losses (``closerlook3d_tpu/models/losses.py``): label-smoothing CE
(classification), masked CE (scene segmentation) and the multi-shape CE
(part segmentation over every category's parts).

All are computed in f32 whatever the logits' dtype. The multi-shape loss
masks the logits outside each sample's category slice to -1e9 before the
softmax, so it has fixed shapes and no per-category branch.

In a process group of more than one process each rank's loss is its
share of the global batch's: the local sum over its rows divided by the
global denominator (the clouds, or the valid points, of every rank,
summed without gradient by ``parallel/collectives.py::reduce_sum``).
The shares sum to the global loss, and the gradients of the shares,
summed over ranks, to its gradient.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from closerlook3d_tpu_torch.parallel.collectives import distributed, reduce_sum

_NEG = -1e9


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE with label smoothing, in f32. logits [B, C], labels [B] int."""
    logits = logits.float()
    nclass = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), nclass).float()
    if smoothing > 0.0:
        onehot = onehot * (1.0 - smoothing) + smoothing / nclass
    ce = -(onehot * logp).sum(dim=-1)
    if distributed():
        return ce.sum() / reduce_sum(ce.new_full((), ce.shape[0]))
    return ce.mean()


def _one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows as ``jax.nn.one_hot`` gives them: all zeros for a
    label outside [0, n) (``F.one_hot`` raises on those)."""
    inside = (labels >= 0) & (labels < n)
    rows = F.one_hot(torch.where(inside, labels, 0).long(), n).float()
    return rows * inside[..., None]


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, smoothing: float = 0.0,
                         ignore_label: int = -1) -> torch.Tensor:
    """Per-point CE averaged over the valid points, in f32.

    logits [B, N, C]; labels [B, N] int; mask [B, N] bool. Points whose
    label is ``ignore_label`` (S3DIS's unannotated points) count as
    masked.
    """
    logits = logits.float()
    nclass = logits.shape[-1]
    valid = mask & (labels != ignore_label)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = F.log_softmax(logits, dim=-1)
    onehot = _one_hot(safe, nclass)
    if smoothing > 0.0:
        onehot = onehot * (1.0 - smoothing) + smoothing / nclass
    ce = -(onehot * logp).sum(dim=-1)  # [B, N]
    return _masked_mean(ce, valid.float())


def _masked_mean(ce: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum(ce w) / max(sum w, 1), the denominator over every rank."""
    return (ce * w).sum() / torch.clamp(reduce_sum(w.sum()), min=1.0)


def category_part_table(num_parts: Sequence[int]) -> np.ndarray:
    """[num_categories, 2] int32 (start, count) of each category's slice
    of the concatenated part axis."""
    starts = np.concatenate([[0], np.cumsum(num_parts)[:-1]])
    return np.stack([starts, np.asarray(num_parts)], axis=1).astype(np.int32)


def _table(num_parts: Sequence[int], device) -> torch.Tensor:
    return torch.from_numpy(category_part_table(num_parts)).to(device)


def category_slice_mask(shape_category: torch.Tensor,
                        num_parts: Sequence[int]) -> torch.Tensor:
    """[B, P_total] bool: the part columns of each sample's category.

    The multi-shape loss gives no gradient to the logits outside this
    slice, so they drift in training: whatever reads predictions (the
    metrics included) masks to the slice before its argmax.
    """
    table = _table(num_parts, shape_category.device)
    cat = shape_category.long()
    start, count = table[cat, 0][:, None], table[cat, 1][:, None]
    part_ids = torch.arange(int(np.sum(num_parts)), dtype=torch.int32,
                            device=shape_category.device)[None, :]
    return (part_ids >= start) & (part_ids < start + count)


def multi_shape_cross_entropy(logits: torch.Tensor,
                              point_labels: torch.Tensor,
                              shape_category: torch.Tensor,
                              mask: torch.Tensor, num_parts: Sequence[int],
                              smoothing: float = 0.0) -> torch.Tensor:
    """Per-category part CE averaged over the valid points, in f32.

    logits [B, N, P_total] over every category's parts; point_labels
    [B, N] global part ids (offset by the category's start);
    shape_category [B] int; mask [B, N] bool. The softmax runs over the
    sample's category slice only (-1e9 outside it, cast to f32 first so
    that bf16 logits cannot overflow), and smoothing spreads over the
    slice's parts.
    """
    logits = logits.float()
    ptotal = logits.shape[-1]
    table = _table(num_parts, logits.device)
    count = table[shape_category.long(), 1][:, None].float()  # [B, 1]
    in_slice = category_slice_mask(shape_category, num_parts)[:, None, :]
    logp = F.log_softmax(torch.where(in_slice, logits, _NEG), dim=-1)
    onehot = _one_hot(point_labels, ptotal)
    if smoothing > 0.0:
        onehot = (onehot * (1.0 - smoothing) + smoothing * in_slice.float()
                  / torch.clamp(count[:, :, None], min=1.0))
    ce = -(onehot * logp).sum(dim=-1)  # [B, N]
    return _masked_mean(ce, mask.float())
