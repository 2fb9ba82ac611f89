"""Train state (``closerlook3d_tpu/train/state.py``).

Where the JAX package keeps params, batch_stats and the optimizer state
in one immutable pytree, the port keeps the model (parameters and
BatchNorm running statistics), the optimizer recipe, the bound
``torch.optim.SGD`` and the step count in one object that the train step
updates in place.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from closerlook3d_tpu_torch.train.schedules import SGD


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    tx: SGD
    optimizer: torch.optim.SGD
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``p.grad``."""
        self.tx.update(self.optimizer, self.step)
        self.step += 1


def create_train_state(model: nn.Module, tx: SGD,
                       device="cuda") -> TrainState:
    """Move ``model`` (weights as built: ``build_classification`` seeds
    them with ``cfg.rng_seed``, where the JAX package draws them here) to
    ``device`` and bind the optimizer to its parameters."""
    model = model.to(torch.device(device))
    return TrainState(model=model, tx=tx, optimizer=tx.init(model))
