"""Export a trained checkpoint to a serving artifact
(``closerlook3d_tpu/cli/export.py``).

    python -m closerlook3d_tpu_torch.cli.export --cfg <yaml> \
        --load_path runs/x/ckpt --out serve/model [--device cuda|cpu]

The checkpoint is restored as ``cli/evaluate.py`` restores it, on the
card unless ``--device`` names another device. The artifact (see
``serving/export.py``) holds the ``torch.export`` program of the eval
forward and its weights, pinned to the device this command runs on.
"""

from __future__ import annotations

import argparse

from closerlook3d_tpu_torch.data.loader import feature_dim
from closerlook3d_tpu_torch.models.build import build_model_and_loss
from closerlook3d_tpu_torch.serving.export import export_forward
from closerlook3d_tpu_torch.train.checkpoints import CheckpointManager
from closerlook3d_tpu_torch.train.schedules import make_optimizer
from closerlook3d_tpu_torch.train.state import (
    create_train_state, require_device)
from closerlook3d_tpu_torch.utils.config import load_config, parse_overrides


def main(argv=None):
    p = argparse.ArgumentParser(description="CloserLook3D export (PyTorch)")
    p.add_argument("--cfg", default=None)
    p.add_argument("--load_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device to export for (default: cuda)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    device = require_device(args.device)
    cfg = load_config(args.cfg, parse_overrides(args.overrides))
    cfg.input_features_dim = feature_dim(cfg.input_features)
    model, _ = build_model_and_loss(cfg)
    optimizer, _ = make_optimizer(cfg, 1)
    state = create_train_state(model, optimizer, device)
    state, _, step = CheckpointManager(args.load_path).restore(state)
    if state is None:
        raise SystemExit(f"no checkpoint found in {args.load_path}")
    out = export_forward(cfg, state, args.out)
    print(f"exported checkpoint @ step {step} -> {out}", flush=True)
    return out


if __name__ == "__main__":
    main()
