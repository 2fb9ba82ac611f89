"""Train and eval steps (``closerlook3d_tpu/train/step.py``).

``train_step(state, batch, seed) -> (state, metrics)`` runs forward in
train mode, the task loss, backward and one optimizer update, on the
device of the state's model; the state is updated in place and returned.
Dropout draws from a ``torch.Generator`` seeded from (seed, state.step),
as the JAX step folds the step into its dropout key. Batches are numpy
dicts (``data/loader.py::BatchIterator``) or tensors; ``geom_*`` keys
carry a precomputed ``compute_geometry`` dict, as in the JAX step.

Data parallelism: in a process group of more than one process each rank
steps its own rows of the global batch and the step is the JAX package's
step on the global batch. BatchNorm statistics and loss denominators are
taken over every rank (``models/nn_utils.py``, ``models/losses.py``), so
each rank's loss is its share of the global loss; after ``backward`` the
gradients are summed over ranks in one all-reduce
(``parallel/collectives.py::reduce_gradients``), so that the clip and the
update see the global gradient and every rank applies the same update.
Dropout draws the global batch's mask from the (seed, step) generator,
which every rank seeds alike, and keeps its own rows
(``models/heads.py::dropout``). The metrics are the global batch's, and
so is the eval step's loss.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from closerlook3d_tpu_torch.models.losses import category_slice_mask
from closerlook3d_tpu_torch.parallel.collectives import (
    distributed, reduce_gradients, reduce_sum)
from closerlook3d_tpu_torch.train.state import TrainState


def batch_geometry(batch):
    """Precomputed geometry dict from geom_* batch keys (None if absent)."""
    geom = {k[5:]: v for k, v in batch.items() if k.startswith("geom_")}
    return geom or None


def apply_task_loss(task: str, loss_fn: Callable, logits, batch):
    if task == "classification":
        return loss_fn(logits, batch["label"])
    if task == "scene_segmentation":
        return loss_fn(logits, batch["labels"], batch["mask"])
    if task == "part_segmentation":
        return loss_fn(logits, batch["labels"], batch["category"],
                       batch["mask"])
    raise ValueError(f"unknown task: {task}")


def _hits(task: str, logits, batch, num_parts):
    """(hits, weights): 1.0 where the argmax is right, per cloud
    (classification; weights None) or per valid point (weights the mask;
    part segmentation masks the logits outside each sample's category
    slice first)."""
    if task == "classification":
        return (torch.argmax(logits, dim=-1) == batch["label"]).float(), None
    if task not in ("scene_segmentation", "part_segmentation"):
        raise ValueError(f"unknown task: {task}")
    if task == "part_segmentation" and num_parts:
        sl = category_slice_mask(batch["category"], tuple(num_parts))
        logits = logits.masked_fill(~sl[:, None, :], float("-inf"))
    m = batch["mask"].float()
    return (torch.argmax(logits, dim=-1) == batch["labels"]).float() * m, m


def task_metrics(task: str, logits, batch,
                 num_parts: Optional[Sequence[int]] = None
                 ) -> Dict[str, torch.Tensor]:
    """{"acc"}: classification accuracy, or the accuracy over the valid
    points of a segmentation batch. With ``num_parts``, part segmentation
    masks the logits outside each sample's category slice before the
    argmax (the multi-shape loss leaves them untrained)."""
    hits, m = _hits(task, logits, batch, num_parts)
    if m is None:
        return {"acc": hits.mean()}
    return {"acc": hits.sum() / torch.clamp(m.sum(), min=1.0)}


def global_metrics(task: str, loss, logits, batch,
                   num_parts: Optional[Sequence[int]] = None
                   ) -> Dict[str, torch.Tensor]:
    """``task_metrics`` and the loss of the global batch, from this rank's
    loss share and rows: one all-reduce of [loss, hits, count]."""
    hits, m = _hits(task, logits, batch, num_parts)
    count = hits.new_full((), hits.numel()) if m is None else m.sum()
    sums = reduce_sum(torch.stack([loss.detach().float(), hits.sum(),
                                   count]))
    return {"loss": sums[0], "acc": sums[1] / torch.clamp(sums[2], min=1.0)}


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step)."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) & (2**63 - 1))


def _to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _forward(model, batch, generator=None):
    return model(batch["xyz"], batch["mask"], batch["features"],
                 geometry=batch_geometry(batch), generator=generator)


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _metrics(task, loss, logits, batch, num_parts):
    if distributed():
        return global_metrics(task, loss, logits, batch, num_parts)
    return {"loss": loss.detach(),
            **task_metrics(task, logits, batch, num_parts)}


def make_train_step(loss_fn: Callable, task: str,
                    num_parts: Optional[Sequence[int]] = None):
    """The model is the state's; metrics are {"loss", "acc"} from the
    train-mode logits, 0-d tensors on the model's device (``num_parts``:
    as ``task_metrics``')."""
    def train_step(state: TrainState, batch, seed: int):
        model = state.model
        device = _device_of(state)
        batch = _to_device(batch, device)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = _forward(model, batch,
                          dropout_generator(seed, state.step, device))
        loss = apply_task_loss(task, loss_fn, logits, batch)
        loss.backward()
        reduce_gradients(model.parameters())
        state.apply_gradients()
        with torch.no_grad():
            metrics = _metrics(task, loss, logits, batch, num_parts)
        return state, metrics

    return train_step


def eval_logits(state: TrainState, batch) -> torch.Tensor:
    """The state's model's logits for ``batch`` (xyz, mask, features and
    any ``geom_*``) in eval mode, on the model's device: the forward of
    ``make_eval_step``'s steps, for the evaluators."""
    state.model.eval()
    with torch.inference_mode():
        return _forward(state.model, _to_device(batch, _device_of(state)))


def make_eval_step(loss_fn: Callable, task: str,
                   num_parts: Optional[Sequence[int]] = None):
    """eval_step(state, batch) -> (logits, {"loss", "acc"}), eval mode."""
    def eval_step(state: TrainState, batch):
        batch = _to_device(batch, _device_of(state))
        logits = eval_logits(state, batch)
        with torch.inference_mode():
            loss = apply_task_loss(task, loss_fn, logits, batch)
            return logits, _metrics(task, loss, logits, batch, num_parts)

    return eval_step
