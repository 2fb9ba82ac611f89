"""Training engine (``closerlook3d_tpu/train/loop.py``): epoch loop,
validation, checkpoints, logging.

``Trainer(cfg, workdir, load_path=None, device="cuda")`` builds the
datasets, the batch iterators (prefetched when ``num_workers > 0``), the
model, the optimizer and the train state on ``device`` (in a process
group, the rank's device of its layout), then resumes
from ``workdir/ckpt`` if it holds a checkpoint (else warm-starts from
``load_path``). ``fit()`` runs ``train_one_epoch`` and, every
``val_interval`` epochs, ``validate``; it saves to ``workdir/ckpt``
(keep ``keep_checkpoints``) every ``save_interval`` epochs and keeps the
best validation model (mIoU, else accuracy) in ``workdir/ckpt_best``.
The host reads the step's metrics every ``log_interval`` steps and at
the end of an epoch, and nowhere else, so the other steps queue on the
card without waiting; a non-finite loss at such a reading raises
``FloatingPointError``.

Data parallelism: in a process group (``parallel/mesh.py``, joined
before the ``Trainer`` is built, as the CLIs do) every rank trains its
shard of each epoch's order (``BatchIterator``'s ``process_index``),
``cfg.batch_size`` clouds a step, and the step is the global batch's
(``train/step.py``). ``data_parallel`` must be -1 or the world size and
``model_parallel`` 1 (``make_mesh``). Validation sums over ranks; rank 0
alone writes scalars and checkpoints. The loss read at a logging step is
the global one, so a non-finite loss stops every rank at the same step.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from closerlook3d_tpu_torch.data.build import build_dataset
from closerlook3d_tpu_torch.data.loader import (
    BatchIterator, PrefetchIterator, feature_dim, host_pipeline)
from closerlook3d_tpu_torch.models.build import (
    build_model_and_loss, part_counts)
from closerlook3d_tpu_torch.models.losses import category_part_table
from closerlook3d_tpu_torch.parallel.collectives import all_processes_sum
from closerlook3d_tpu_torch.parallel.mesh import layout, make_mesh, shard_batch
from closerlook3d_tpu_torch.train.checkpoints import CheckpointManager
from closerlook3d_tpu_torch.train.metrics import (
    AverageMeter, confusion_matrix, iou_from_confusion)
from closerlook3d_tpu_torch.train.schedules import make_optimizer
from closerlook3d_tpu_torch.train.state import (
    create_train_state, param_count, require_device)
from closerlook3d_tpu_torch.train.step import make_eval_step, make_train_step
from closerlook3d_tpu_torch.utils.logger import process_rank, setup_logger
from closerlook3d_tpu_torch.utils.tb import ScalarWriter

_DEVICE_KEYS = ("xyz", "mask", "features", "label", "labels", "category")


def device_batch(batch):
    """The keys of a host batch that the steps read: the model's inputs,
    the labels and the precomputed geometry (``geom_*``)."""
    return {k: v for k, v in batch.items()
            if k in _DEVICE_KEYS or k.startswith("geom_")}


class Trainer:
    def __init__(self, cfg, workdir: str, load_path: Optional[str] = None,
                 device="cuda"):
        self.layout = make_mesh(cfg.data_parallel, cfg.model_parallel,
                                layout(require_device(device)))
        self.device = self.layout.device
        self.cfg = cfg
        self.workdir = workdir
        self.logger = setup_logger(workdir)
        # rank 0 alone writes scalars, as it alone logs
        self.writer = ScalarWriter(workdir if process_rank() == 0 else None)

        self.train_set = build_dataset(cfg, "train")
        self.val_set = build_dataset(cfg, "test")
        cfg.input_features_dim = feature_dim(cfg.input_features)
        pipeline = dict(host_pipeline(cfg),
                        process_index=self.layout.rank,
                        process_count=self.layout.world_size)
        self.train_iter = BatchIterator(
            self.train_set, cfg.batch_size, shuffle=True,
            feature_spec=cfg.input_features, seed=cfg.rng_seed, **pipeline)
        self.val_iter = BatchIterator(
            self.val_set, cfg.batch_size, shuffle=False,
            feature_spec=cfg.input_features, seed=cfg.rng_seed,
            drop_last=False, **pipeline)
        if int(getattr(cfg, "num_workers", 0)) > 0:
            self.train_iter = PrefetchIterator(self.train_iter)
            self.val_iter = PrefetchIterator(self.val_iter)

        model, self.loss_fn = build_model_and_loss(cfg)
        steps_per_epoch = max(len(self.train_iter), 1)
        self.optimizer, self.lr_schedule = make_optimizer(
            cfg, steps_per_epoch)
        self.state = create_train_state(model, self.optimizer, self.device)
        self.logger.info(
            "model built: %s / %s — %.2fM params; %d process(es) of %d "
            "clouds a step on %s (%s)", cfg.task, cfg.local_aggregation_type,
            param_count(self.state) / 1e6, self.layout.world_size,
            cfg.batch_size, self.device, self.layout.backend or "no group")

        num_parts = (part_counts(cfg) if cfg.task == "part_segmentation"
                     else None)
        self.train_step = make_train_step(self.loss_fn, cfg.task, num_parts)
        self.eval_step = make_eval_step(self.loss_fn, cfg.task, num_parts)

        self.ckpt = CheckpointManager(f"{workdir}/ckpt",
                                      keep=cfg.keep_checkpoints)
        # keep-k keeps the latest k only, so the best validation model
        # has a keep-1 slot of its own
        self.ckpt_best = CheckpointManager(f"{workdir}/ckpt_best", keep=1)
        self.start_epoch = cfg.start_epoch
        restored, extra, step = self.ckpt.restore(self.state)
        self.resumed_step = step  # None on a fresh run
        if restored is not None:
            self.start_epoch = (int(extra["epoch"]) + 1 if extra
                                else cfg.start_epoch)
            self.logger.info("resumed from step %s (epoch %s)", step,
                             self.start_epoch)
        elif load_path:
            restored, _, step = CheckpointManager(load_path).restore(
                self.state)
            if restored is not None:
                self.logger.info("loaded weights from %s @ %s",
                                 load_path, step)

        self.seed = cfg.rng_seed + 1  # the dropout seed

    # ------------------------------------------------------------------
    def _run_step(self, batch):
        self.state, metrics = self.train_step(
            self.state, shard_batch(device_batch(batch), self.layout),
            self.seed)
        return metrics

    def train_one_epoch(self, epoch: int):
        cfg = self.cfg
        self.train_iter.set_epoch(epoch)
        loss_m, acc_m, time_m = AverageMeter(), AverageMeter(), AverageMeter()
        end = time.perf_counter()
        profile_at = int(getattr(cfg, "profile_steps", 0))
        n = len(self.train_iter)
        for it, batch in enumerate(self.train_iter):
            if profile_at and epoch == self.start_epoch and it == 2:
                # past the first steps' allocations, trace a few steps
                from closerlook3d_tpu_torch.utils.profiling import trace
                with trace(f"{self.workdir}/profile"):
                    for _ in range(profile_at):
                        metrics = self._run_step(batch)
                    float(metrics["loss"])  # the device's work in the trace
                self.logger.info("profile trace written to %s/profile",
                                 self.workdir)
            metrics = self._run_step(batch)
            if (it + 1) % cfg.log_interval == 0 or it + 1 == n:
                loss = float(metrics["loss"])  # waits for the device
                if not np.isfinite(loss):
                    # fail loudly at the first fetched divergence
                    self.logger.error(
                        "non-finite loss %s at epoch %d it %d — aborting",
                        loss, epoch, it + 1)
                    raise FloatingPointError(
                        f"non-finite training loss at epoch {epoch} "
                        f"it {it + 1}")
                loss_m.update(loss)
                acc_m.update(float(metrics["acc"]))
                time_m.update(time.perf_counter() - end)
                end = time.perf_counter()
                step = self.state.step
                lr = float(self.lr_schedule(step))
                self.logger.info(
                    "epoch %d it %d/%d loss %.4f acc %.4f lr %.5f",
                    epoch, it + 1, n, loss_m.avg, acc_m.avg, lr)
                self.writer.scalars(
                    {"loss": loss_m.avg, "acc": acc_m.avg, "lr": lr,
                     "batch_time": time_m.avg}, step, prefix="train/")
        return loss_m.avg, acc_m.avg

    def validate(self, epoch: int):
        cfg = self.cfg
        loss_m, acc_m = AverageMeter(), AverageMeter()
        conf = None
        table = (category_part_table(part_counts(cfg))
                 if cfg.task == "part_segmentation" else None)
        for batch in self.val_iter:
            logits, metrics = self.eval_step(
                self.state, shard_batch(device_batch(batch), self.layout))
            keep = ~batch["batch_pad"]
            loss_m.update(float(metrics["loss"]), int(keep.sum()))
            lg = logits.float().cpu().numpy()
            if cfg.task == "classification":
                pred = lg.argmax(-1)
                acc_m.update(
                    float((pred[keep] == batch["label"][keep]).mean()),
                    int(keep.sum()))
                continue
            if table is not None:
                # the category's slice alone: out-of-slice columns carry
                # no training signal (losses.category_slice_mask)
                pid = np.arange(lg.shape[-1])
                start = table[batch["category"], 0][:, None]
                cnt = table[batch["category"], 1][:, None]
                sl = (pid[None] >= start) & (pid[None] < start + cnt)
                lg = np.where(sl[:, None, :], lg, -np.inf)
            pred = lg.argmax(-1)
            m = batch["mask"] & keep[:, None]
            c = confusion_matrix(
                torch.from_numpy(pred), torch.from_numpy(batch["labels"]),
                lg.shape[-1], torch.from_numpy(m)).numpy()
            conf = c if conf is None else conf + c
            acc_m.update(float((pred == batch["labels"])[m].mean()),
                         int(m.sum()))
        loss_m.sum, loss_m.count, acc_m.sum, acc_m.count = all_processes_sum(
            (loss_m.sum, loss_m.count, acc_m.sum, acc_m.count))
        if conf is not None:
            conf = all_processes_sum(conf)
            _, miou, oa = iou_from_confusion(conf)
            self.logger.info("val epoch %d: loss %.4f acc %.4f mIoU %.4f "
                             "OA %.4f", epoch, loss_m.avg, acc_m.avg, miou,
                             oa)
            stats = {"loss": loss_m.avg, "acc": acc_m.avg, "miou": miou,
                     "oa": oa}
        else:
            self.logger.info("val epoch %d: loss %.4f acc %.4f",
                             epoch, loss_m.avg, acc_m.avg)
            stats = {"loss": loss_m.avg, "acc": acc_m.avg}
        self.writer.scalars(stats, self.state.step, prefix="val/")
        return stats

    def fit(self):
        cfg = self.cfg
        best = 0.0
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            t0 = time.perf_counter()
            loss, acc = self.train_one_epoch(epoch)
            self.logger.info("epoch %d done in %.1fs: loss %.4f acc %.4f",
                             epoch, time.perf_counter() - t0, loss, acc)
            if epoch % cfg.val_interval == 0 or epoch == cfg.epochs:
                stats = self.validate(epoch)
                key = "miou" if "miou" in stats else "acc"
                if stats[key] > best:
                    best = stats[key]
                    self.ckpt_best.save(
                        self.state.step, self.state,
                        extra={"epoch": epoch, "value": float(best)})
                    self.logger.info(
                        "new best %s %.4f @ epoch %d (saved to "
                        "ckpt_best)", key, best, epoch)
            if epoch % cfg.save_interval == 0 or epoch == cfg.epochs:
                self.ckpt.save(self.state.step, self.state,
                               extra={"epoch": epoch})
        self.ckpt.wait()
        self.ckpt_best.wait()
        self.writer.close()
        self.logger.info("training complete; best %.4f", best)
        return best
