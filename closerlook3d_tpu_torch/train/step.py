"""Train and eval steps (``closerlook3d_tpu/train/step.py``).

``train_step(state, batch, seed) -> (state, metrics)`` runs forward in
train mode, the task loss, backward and one optimizer update, on the
device of the state's model; the state is updated in place and returned.
Dropout draws from a ``torch.Generator`` seeded from (seed, state.step),
as the JAX step folds the step into its dropout key. Batches are numpy
dicts (``data/loader.py::BatchIterator``) or tensors; ``geom_*`` keys
carry a precomputed ``compute_geometry`` dict, as in the JAX step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from closerlook3d_tpu_torch.models.losses import category_slice_mask
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


def task_metrics(task: str, logits, batch,
                 num_parts: Optional[Sequence[int]] = None
                 ) -> Dict[str, torch.Tensor]:
    """{"acc"}: classification accuracy, or the accuracy over the valid
    points of a segmentation batch. With ``num_parts``, part segmentation
    masks the logits outside each sample's category slice before the
    argmax (the multi-shape loss leaves them untrained)."""
    if task == "classification":
        pred = torch.argmax(logits, dim=-1)
        return {"acc": (pred == batch["label"]).float().mean()}
    if task not in ("scene_segmentation", "part_segmentation"):
        raise ValueError(f"unknown task: {task}")
    if task == "part_segmentation" and num_parts:
        sl = category_slice_mask(batch["category"], tuple(num_parts))
        logits = logits.masked_fill(~sl[:, None, :], float("-inf"))
    pred = torch.argmax(logits, dim=-1)
    m = batch["mask"].float()
    correct = (pred == batch["labels"]).float() * m
    return {"acc": correct.sum() / torch.clamp(m.sum(), min=1.0)}


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
        state.apply_gradients()
        with torch.no_grad():
            metrics = {"loss": loss.detach(),
                       **task_metrics(task, logits, batch, num_parts)}
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
            return logits, {"loss": loss,
                            **task_metrics(task, logits, batch, num_parts)}

    return eval_step
