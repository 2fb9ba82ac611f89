"""Ahead-of-time export of the inference forward for serving.

Counterpart of ``closerlook3d_tpu/serving/export.py``. ``export_forward``
captures the eval-mode forward with ``torch.export`` (non-strict, grad
off) on the device the model lives on, and ``load_forward`` restores a
predictor that needs only ``torch`` and ``closerlook3d_tpu_torch.ops``
(whose import registers the ``cl3d`` ops, ``ops/library.py``): none of
the model code. Every kernel family the forward reaches is one ``cl3d``
node of the graph, so on the card the loaded program launches the same
hand-written kernels as ``Predictor`` (and counts them the same way), and
on the CPU their plain versions.

Artifact layout (a directory):
    forward.pt2   ``torch.export.save`` of the exported program (weights
                  included), pinned to the device it was exported on
    weights.npz   the weights as the JAX artifact's flat flax keys
                  ('/'-joined ``params/...`` and ``batch_stats/...``),
                  which ``Predictor`` and the JAX package both read
    meta.json     the JAX artifact's keys: shapes, task, operator,
                  ``platforms`` (["cuda"] or ["cpu"]) and ``torch_version``
                  where the JAX one has ``jax_version``

Exports are shape-static, as the JAX ones: a program exported for
[B, N] serves any smaller cloud through the mask, and refuses any other
shape.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

import closerlook3d_tpu_torch.ops  # noqa: F401  (registers the cl3d ops)

_FWD = "forward.pt2"
_WTS = "weights.npz"
_META = "meta.json"


def export_forward(cfg, state, out_dir: str) -> str:
    """Export the eval-mode forward of ``state``'s model (a ``TrainState``
    or the model itself) to ``out_dir``; returns ``out_dir``.

    The example inputs have the JAX artifact's shapes: xyz [B, N, 3] f32,
    mask [B, N] bool, features [B, N, D] f32 with B = ``cfg.batch_size``,
    N = ``cfg.num_points`` and D the width of ``cfg.input_features``. The
    model is put in eval mode and stays there.
    """
    from closerlook3d_tpu_torch.convert import state_dict_to_flax
    from closerlook3d_tpu_torch.data.loader import feature_dim

    model = getattr(state, "model", state)
    model.eval()
    device = next(model.parameters()).device
    b, n = int(cfg.batch_size), int(cfg.num_points)
    d = feature_dim(cfg.input_features)
    example = (torch.zeros((b, n, 3), dtype=torch.float32, device=device),
               torch.ones((b, n), dtype=torch.bool, device=device),
               torch.zeros((b, n, d), dtype=torch.float32, device=device))
    # (xyz, mask, features) alone: no precomputed geometry, no dropout
    # generator
    with torch.no_grad():
        program = torch.export.export(model, example, strict=False)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _FWD))
    np.savez(os.path.join(out_dir, _WTS),
             **state_dict_to_flax(model.state_dict(), model))
    meta = {
        "batch_size": b,
        "num_points": n,
        "feature_dim": d,
        "num_outputs": int(getattr(cfg, "num_classes", 0)),
        "task": str(cfg.task),
        "local_aggregation_type": str(cfg.local_aggregation_type),
        "platforms": [device.type],
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def without_metadata_asserts(module: torch.fx.GraphModule
                             ) -> torch.fx.GraphModule:
    """``module`` without the ``aten._assert_tensor_metadata`` nodes that
    ``torch.export`` puts before each ``.to()`` of the traced forward.
    They check an intermediate's dtype, device and layout, which the
    trace fixed and the checked input shapes and dtypes keep, and cost the
    host time of one more op call each on every request (``chip_smoke.py``
    ``phase_export`` times a program with and without them)."""
    graph = module.graph
    for node in list(graph.nodes):
        if (node.op == "call_function" and node.target
                is torch.ops.aten._assert_tensor_metadata.default):
            graph.erase_node(node)
    module.recompile()
    return module


class ExportedPredictor:
    """Loaded serving artifact: ``predictor(xyz, mask, features)``.

    Inputs as ``serving/predictor.py::Predictor`` takes them (array-likes
    or tensors, Morton-sorted per cloud), of exactly the exported shapes;
    returns f32 logits on the artifact's device: [B, classes], or
    [B, N, classes or parts] for segmentation.
    """

    def __init__(self, program, meta: dict, device: torch.device):
        self.meta = meta
        self.device = device
        self._forward = without_metadata_asserts(program.module())
        b, n, d = meta["batch_size"], meta["num_points"], meta["feature_dim"]
        self._shapes = ((b, n, 3), (b, n), (b, n, d))

    def __call__(self, xyz, mask, features) -> torch.Tensor:
        args = (torch.as_tensor(xyz, dtype=torch.float32, device=self.device),
                torch.as_tensor(mask, dtype=torch.bool, device=self.device),
                torch.as_tensor(features, dtype=torch.float32,
                                device=self.device))
        got = tuple(tuple(a.shape) for a in args)
        if got != self._shapes:
            raise ValueError(f"request shapes {got} differ from the "
                             f"exported {self._shapes} (xyz, mask, "
                             f"features)")
        with torch.inference_mode():
            return self._forward(*args)


def load_forward(out_dir: str, device=None
                 ) -> Tuple[ExportedPredictor, dict]:
    """Restore (predictor, meta) from an ``export_forward`` directory.

    ``device`` defaults to the artifact's; any other device raises, as
    does a CUDA artifact where there is no card: an artifact never moves
    between the card and the CPU.
    """
    with open(os.path.join(out_dir, _META)) as f:
        meta = json.load(f)
    platform = meta["platforms"][0]
    device = torch.device(platform if device is None else device)
    if device.type != platform:
        raise ValueError(f"artifact in {out_dir} was exported for "
                         f"{platform!r} and cannot serve on {str(device)!r}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"artifact in {out_dir} was exported for 'cuda' "
                           f"and CUDA is not available")
    program = torch.export.load(os.path.join(out_dir, _FWD))
    return ExportedPredictor(program, meta, device), meta
