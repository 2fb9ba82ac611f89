"""Evaluation entry point (``closerlook3d_tpu/cli/evaluate.py``): restores
a checkpoint and prints the task's metrics as one JSON line, last.

    python -m closerlook3d_tpu_torch.cli.evaluate --cfg <yaml> --load_path runs/x/ckpt
    python -m closerlook3d_tpu_torch.cli.evaluate ... --device cpu

S3DIS scenes go through sphere voting, part segmentation through the
whole-shape part mIoU, classification through the accuracy, each with
``train/evaluate.py``'s evaluator over the eval-mode logits of the
restored model (``train/step.py::eval_logits``). Under torchrun each
rank evaluates its shard (its batches, or its S3DIS rooms), the metrics
are reduced over the ranks, and rank 0 prints them.
"""

from __future__ import annotations

import argparse
import json

import torch.distributed as dist

from closerlook3d_tpu_torch.data.build import build_dataset
from closerlook3d_tpu_torch.data.loader import BatchIterator, feature_dim
from closerlook3d_tpu_torch.models.build import build_model_and_loss
from closerlook3d_tpu_torch.parallel import mesh
from closerlook3d_tpu_torch.train.checkpoints import CheckpointManager
from closerlook3d_tpu_torch.train.evaluate import (
    evaluate_classification, evaluate_partseg, evaluate_s3dis_voting)
from closerlook3d_tpu_torch.train.schedules import make_optimizer
from closerlook3d_tpu_torch.train.state import (
    create_train_state, require_device)
from closerlook3d_tpu_torch.train.step import eval_logits
from closerlook3d_tpu_torch.utils.config import load_config, parse_overrides
from closerlook3d_tpu_torch.utils.logger import print_json_line, setup_logger


def main(argv=None):
    p = argparse.ArgumentParser(
        description="CloserLook3D evaluation (PyTorch)")
    p.add_argument("--cfg", default=None)
    p.add_argument("--log_dir", default="runs/eval")
    p.add_argument("--load_path", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default: cuda)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    # leave the group at the end only where this run joined it (see
    # cli/train.py)
    joined = (not dist.is_initialized()
              and mesh.maybe_initialize_distributed(args.device))
    try:
        return _evaluate(args)
    finally:
        if joined:
            mesh.destroy()


def _evaluate(args):
    lay = mesh.layout(require_device(args.device))
    device = lay.device
    cfg = load_config(args.cfg, parse_overrides(args.overrides))
    logger = setup_logger(args.log_dir)
    dataset = build_dataset(cfg, "test")
    cfg.input_features_dim = feature_dim(cfg.input_features)
    model, _ = build_model_and_loss(cfg)
    optimizer, _ = make_optimizer(cfg, 1)
    it = BatchIterator(dataset, cfg.batch_size, shuffle=False,
                       feature_spec=cfg.input_features, drop_last=False,
                       spatial_sort=cfg.spatial_sort == "host",
                       process_index=lay.rank,
                       process_count=lay.world_size)
    state = create_train_state(model, optimizer, device)
    state, _, step = CheckpointManager(args.load_path).restore(state)
    if state is None:
        raise SystemExit(f"no checkpoint found in {args.load_path}")
    logger.info("evaluating checkpoint @ step %s", step)

    if cfg.task == "scene_segmentation" and cfg.datasets == "s3dis":
        results = evaluate_s3dis_voting(cfg, dataset, state, eval_logits,
                                        logger)
    elif cfg.task == "part_segmentation":
        results = evaluate_partseg(cfg, dataset, state, eval_logits, it)
    else:
        results = evaluate_classification(cfg, state, eval_logits, it)

    logger.info("results: %s", json.dumps(results))
    if lay.rank == 0:
        print_json_line(results)
    return results


if __name__ == "__main__":
    main()
