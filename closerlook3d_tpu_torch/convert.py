"""Weight bridge between the JAX package's flax variables and the port.

Flax names submodules by creation order; the port's modules are built in
the same order, so each flax scope has one counterpart:

  ResNetBackbone_0/ConvBN_0                    backbone.stem
  ResNetBackbone_0/LocalAggregation_0/ConvBN_0 backbone.stem_agg.output_conv
  ResNetBackbone_0/Bottleneck_i/ConvBN_0       backbone.blocks.i.reduce
    .../Bottleneck_i/LocalAggregation_0/ConvBN_0  ...agg.output_conv
    .../Bottleneck_i/ConvBN_1                  backbone.blocks.i.expand
    .../Bottleneck_i/ConvBN_2                  backbone.blocks.i.shortcut
  ClassifierHead_0/ConvBN_j                    head.convs.j
  ClassifierHead_0/Dense_0                     head.fc

(output convs and shortcuts exist only where channels change). Within a
ConvBN, ``Dense_0/kernel`` [in, out] is the transpose of
``linear.weight`` [out, in]; BatchNorm ``scale``/``bias`` come from
``params`` and ``mean``/``var`` from ``batch_stats``.

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


def _scopes(model: nn.Module) -> List[Tuple[str, str]]:
    """(flax scope, torch prefix) for every ConvBN of the model."""
    bb = model.backbone
    pairs = [("ResNetBackbone_0/ConvBN_0", "backbone.stem")]
    if bb.stem_agg.output_conv is not None:
        pairs.append(("ResNetBackbone_0/LocalAggregation_0/ConvBN_0",
                      "backbone.stem_agg.output_conv"))
    for i, blk in enumerate(bb.blocks):
        f, t = f"ResNetBackbone_0/Bottleneck_{i}", f"backbone.blocks.{i}"
        pairs.append((f"{f}/ConvBN_0", f"{t}.reduce"))
        if blk.agg.output_conv is not None:
            pairs.append((f"{f}/LocalAggregation_0/ConvBN_0",
                          f"{t}.agg.output_conv"))
        pairs.append((f"{f}/ConvBN_1", f"{t}.expand"))
        if blk.shortcut is not None:
            pairs.append((f"{f}/ConvBN_2", f"{t}.shortcut"))
    for j in range(len(model.head.convs)):
        pairs.append((f"ClassifierHead_0/ConvBN_{j}", f"head.convs.{j}"))
    return pairs


def key_map(model: nn.Module) -> List[Tuple[str, str, bool]]:
    """(flax flat key, state_dict key, transposed) for every tensor."""
    rows = []
    for f, t in _scopes(model):
        rows += [
            (f"params/{f}/Dense_0/kernel", f"{t}.linear.weight", True),
            (f"params/{f}/BatchNorm_0/scale", f"{t}.bn.weight", False),
            (f"params/{f}/BatchNorm_0/bias", f"{t}.bn.bias", False),
            (f"batch_stats/{f}/BatchNorm_0/mean", f"{t}.bn.running_mean",
             False),
            (f"batch_stats/{f}/BatchNorm_0/var", f"{t}.bn.running_var",
             False),
        ]
    rows += [("params/ClassifierHead_0/Dense_0/kernel", "head.fc.weight",
              True),
             ("params/ClassifierHead_0/Dense_0/bias", "head.fc.bias", False)]
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
