"""Weight bridge between the JAX package's flax variables and the port.

Flax names submodules by creation order; the port's modules are built in
the same order, so each flax scope has one counterpart:

  ResNetBackbone_0/ConvBN_0                    backbone.stem
  ResNetBackbone_0/LocalAggregation_0          backbone.stem_agg
  ResNetBackbone_0/Bottleneck_i/ConvBN_0       backbone.blocks.i.reduce
  ResNetBackbone_0/Bottleneck_i/LocalAggregation_0  backbone.blocks.i.agg
    .../Bottleneck_i/ConvBN_1                  backbone.blocks.i.expand
    .../Bottleneck_i/ConvBN_2                  backbone.blocks.i.shortcut
  ClassifierHead_0/ConvBN_j                    head.convs.j
  ClassifierHead_0/Dense_0                     head.fc
  SceneSegHead_0/_Decoder_0/ConvBN_j           head.decoder.convs.j
  SceneSegHead_0/ConvBN_0                      head.conv
  SceneSegHead_0/Dense_0                       head.fc

(``MultiPartSegHead_0`` as ``SceneSegHead_0``), and within each
LocalAggregation_0:

  ConvBN_0 .. ConvBN_{n-1}   weight_convs.0 .. weight_convs.{n-1}
                             (adaptive weight: the gather path's
                             fc_num - 1 weight convs)
  Dense_0                    dense (adaptive weight)
  pw_kernel_i                pw_linears.i.weight (point-wise MLP, a bare
                             [in, out] param)
  pw_bn_i                    pw_bns.i (point-wise MLP, MaskedBatchNorm)
  kernel_weights             kernel_weights.weight (pseudo-grid, a bare
                             [Kp*C, out] param)
  ConvBN_n                   output_conv

(output convs and shortcuts exist only where channels change, or where
the operator's config asks for an output conv). Within a ConvBN,
``Dense_0/kernel`` [in, out] is the transpose of ``linear.weight``
[out, in], as ``pw_kernel_i`` is of ``pw_linears.i.weight``; BatchNorm
(and MaskedBatchNorm) ``scale``/``bias`` come from ``params`` and
``mean``/``var`` from ``batch_stats``. ``kernel_weights`` is transposed
the same way.

Flax variables are given as numpy arrays, either nested
(``{"params": {...}, "batch_stats": {...}}``) or flat with '/'-joined
keys (``params/ResNetBackbone_0/...``), the layout of the
``weights.npz`` that ``closerlook3d_tpu.serving.export_forward`` writes.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from closerlook3d_tpu_torch.models.heads import (
    ClassifierHead, MultiPartSegHead, SceneSegHead)


def flatten_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """Nested or already-flat flax variables -> {'params/a/b': array}."""
    out: Dict[str, np.ndarray] = {}

    def rec(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                rec(v, f"{path}/{k}" if path else str(k))
        else:
            out[path] = np.asarray(node)

    rec(variables, "")
    return out


def _agg_scopes(agg: nn.Module, f: str, t: str):
    """(ConvBN pairs, Dense pairs, point-wise MLP layer pairs, bare kernel
    pairs) of one LocalAggregation at flax scope ``f`` and torch prefix
    ``t``; a layer pair is (flax scope, torch prefix) of the layer's
    kernel and of its MaskedBatchNorm."""
    convs = [(f"{f}/ConvBN_{i}", f"{t}.weight_convs.{i}")
             for i in range(len(agg.weight_convs))]
    if agg.output_conv is not None:
        convs.append((f"{f}/ConvBN_{len(agg.weight_convs)}",
                      f"{t}.output_conv"))
    dense = [] if agg.dense is None else [(f"{f}/Dense_0", f"{t}.dense")]
    pw = [((f"{f}/pw_kernel_{i}", f"{t}.pw_linears.{i}"),
           (f"{f}/pw_bn_{i}", f"{t}.pw_bns.{i}"))
          for i in range(len(agg.pw_linears))]
    if agg.kernel_weights is not None:
        pw.append(((f"{f}/kernel_weights", f"{t}.kernel_weights"), None))
    return convs, dense, pw


_HEAD_SCOPES = ((ClassifierHead, "ClassifierHead_0"),
                (SceneSegHead, "SceneSegHead_0"),
                (MultiPartSegHead, "MultiPartSegHead_0"))


def _scopes(model: nn.Module):
    """(flax scope, torch prefix) pairs: (every ConvBN, every Dense with a
    bias, every bare kernel with its MaskedBatchNorm or None, as
    ``_agg_scopes``' layer pairs)."""
    bb = model.backbone
    convs = [("ResNetBackbone_0/ConvBN_0", "backbone.stem")]
    dense, pw = [], []

    def add_agg(agg, f, t):
        c, d, p = _agg_scopes(agg, f, t)
        convs.extend(c)
        dense.extend(d)
        pw.extend(p)

    add_agg(bb.stem_agg, "ResNetBackbone_0/LocalAggregation_0",
            "backbone.stem_agg")
    for i, blk in enumerate(bb.blocks):
        f, t = f"ResNetBackbone_0/Bottleneck_{i}", f"backbone.blocks.{i}"
        convs.append((f"{f}/ConvBN_0", f"{t}.reduce"))
        add_agg(blk.agg, f"{f}/LocalAggregation_0", f"{t}.agg")
        convs.append((f"{f}/ConvBN_1", f"{t}.expand"))
        if blk.shortcut is not None:
            convs.append((f"{f}/ConvBN_2", f"{t}.shortcut"))
    head = model.head
    h = next(name for cls, name in _HEAD_SCOPES if isinstance(head, cls))
    if isinstance(head, ClassifierHead):
        for j in range(len(head.convs)):
            convs.append((f"{h}/ConvBN_{j}", f"head.convs.{j}"))
    else:
        for j in range(len(head.decoder.convs)):
            convs.append((f"{h}/_Decoder_0/ConvBN_{j}",
                          f"head.decoder.convs.{j}"))
        convs.append((f"{h}/ConvBN_0", "head.conv"))
    dense.append((f"{h}/Dense_0", "head.fc"))
    return convs, dense, pw


def _bn_rows(f: str, t: str) -> List[Tuple[str, str, bool]]:
    """The four rows of a BatchNorm at flax scope ``f``, torch prefix
    ``t``."""
    return [(f"params/{f}/scale", f"{t}.weight", False),
            (f"params/{f}/bias", f"{t}.bias", False),
            (f"batch_stats/{f}/mean", f"{t}.running_mean", False),
            (f"batch_stats/{f}/var", f"{t}.running_var", False)]


def key_map(model: nn.Module) -> List[Tuple[str, str, bool]]:
    """(flax flat key, state_dict key, transposed) for every tensor."""
    rows = []
    convs, dense, pw = _scopes(model)
    for f, t in convs:
        rows += [(f"params/{f}/Dense_0/kernel", f"{t}.linear.weight", True),
                 *_bn_rows(f"{f}/BatchNorm_0", f"{t}.bn")]
    for (fk, tk), bn in pw:
        rows.append((f"params/{fk}", f"{tk}.weight", True))
        if bn is not None:
            rows += _bn_rows(*bn)
    for f, t in dense:
        rows += [(f"params/{f}/kernel", f"{t}.weight", True),
                 (f"params/{f}/bias", f"{t}.bias", False)]
    return rows


def flax_to_state_dict(variables: Mapping, model: nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """Flax variables -> a complete ``state_dict`` for ``model``.

    Raises on a flax key it does not consume, a state_dict key it leaves
    unset, or a shape that does not fit.
    """
    flat = flatten_variables(variables)
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for fk, tk, transposed in key_map(model):
        if fk not in flat:
            raise KeyError(f"missing flax variable {fk} (for {tk})")
        arr = np.asarray(flat[fk], dtype=np.float32)
        if transposed:
            arr = arr.T
        if tuple(arr.shape) != tuple(expected[tk].shape):
            raise ValueError(f"{fk}: shape {arr.shape} does not fit {tk} "
                             f"{tuple(expected[tk].shape)}")
        out[tk] = torch.from_numpy(np.array(arr, order="C"))  # own copy
        used.add(fk)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"flax variables with no counterpart: {unused}")
    unset = sorted(set(expected) - set(out))
    if unset:
        raise KeyError(f"state_dict keys left unset: {unset}")
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor],
                       model: nn.Module,
                       params_only: bool = False) -> Dict[str, np.ndarray]:
    """A port ``state_dict`` -> flat flax variables (``weights.npz`` keys).

    ``params_only`` maps only the ``params/...`` keys, for tensors laid
    out like the parameters, such as their gradients
    ({name: p.grad for name, p in model.named_parameters()}).
    """
    rows = [r for r in key_map(model)
            if not params_only or r[0].startswith("params/")]
    extra = sorted(set(state_dict) - {tk for _, tk, _ in rows})
    if extra:
        raise KeyError(f"state_dict keys with no flax counterpart: {extra}")
    out = {}
    for fk, tk, transposed in rows:
        arr = state_dict[tk].detach().cpu().float().numpy()
        # a copy: on the CPU ``arr`` shares memory with the live tensor
        out[fk] = np.array(arr.T if transposed else arr, order="C")
    return out
