"""Train state (``closerlook3d_tpu/train/state.py``).

Where the JAX package keeps params, batch_stats and the optimizer state
in one immutable pytree, the port keeps the model (parameters and
BatchNorm running statistics), the optimizer recipe (``SGD`` or
``AdamW``), the bound torch optimizer and the step count in one object
that the train step updates in place.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch
from torch import nn

from closerlook3d_tpu_torch.parallel.collectives import broadcast_module_
from closerlook3d_tpu_torch.train.schedules import SGD, AdamW


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    tx: Union[SGD, AdamW]
    optimizer: torch.optim.Optimizer
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``p.grad``."""
        self.tx.update(self.optimizer, self.step)
        self.step += 1


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises where it names a CUDA
    device and there is none, so no entry point falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for and CUDA is not available; "
            f"pass device='cpu' (--device cpu) to run on the CPU")
    return device


def create_train_state(model: nn.Module, tx: Union[SGD, AdamW],
                       device="cuda") -> TrainState:
    """Move ``model`` of any task (weights as built: the task's builder,
    e.g. ``build_classification``, seeds them with ``cfg.rng_seed``, where
    the JAX package draws them here) to ``device`` and bind the optimizer
    to its parameters. In a process group of more than one process, rank
    0's parameters and buffers are then broadcast, so that every rank
    starts equal."""
    model = model.to(require_device(device))
    broadcast_module_(model)
    return TrainState(model=model, tx=tx, optimizer=tx.init(model))


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
