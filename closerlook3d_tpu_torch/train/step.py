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

from typing import Callable, Dict

import numpy as np
import torch

from closerlook3d_tpu_torch.train.state import TrainState


def batch_geometry(batch):
    """Precomputed geometry dict from geom_* batch keys (None if absent)."""
    geom = {k[5:]: v for k, v in batch.items() if k.startswith("geom_")}
    return geom or None


def apply_task_loss(task: str, loss_fn: Callable, logits, batch):
    if task == "classification":
        return loss_fn(logits, batch["label"])
    raise NotImplementedError(
        f"task={task!r} is not ported yet (ROADMAP A, segmentation)")


def task_metrics(task: str, logits, batch) -> Dict[str, torch.Tensor]:
    if task == "classification":
        pred = torch.argmax(logits, dim=-1)
        return {"acc": (pred == batch["label"]).float().mean()}
    raise NotImplementedError(
        f"task={task!r} is not ported yet (ROADMAP A, segmentation)")


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


def make_train_step(loss_fn: Callable, task: str):
    """The model is the state's; metrics are {"loss", "acc"} from the
    train-mode logits, 0-d tensors on the model's device."""
    def train_step(state: TrainState, batch, seed: int):
        model = state.model
        device = next(model.parameters()).device
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
                       **task_metrics(task, logits, batch)}
        return state, metrics

    return train_step


def make_eval_step(loss_fn: Callable, task: str):
    """eval_step(state, batch) -> (logits, {"loss", "acc"}), eval mode."""
    def eval_step(state: TrainState, batch):
        model = state.model
        batch = _to_device(batch, next(model.parameters()).device)
        model.eval()
        with torch.inference_mode():
            logits = _forward(model, batch)
            loss = apply_task_loss(task, loss_fn, logits, batch)
            return logits, {"loss": loss,
                            **task_metrics(task, logits, batch)}

    return eval_step
