"""LR schedules and the optimizer (``closerlook3d_tpu/train/schedules.py``).

Schedules are functions of the optimizer step, written out from optax's
formulas (optax 0.2): linear warmup from 0.01 * base, then cosine, step
(staircase exponential) or multistep decay; ``join_schedules`` hands the
main schedule ``step - warmup_steps``. Epoch-denominated config values are
converted with ``steps_per_epoch``.

The optimizer is optax's chain of ``clip_by_global_norm`` (when
``grad_clip > 0``) and then, for ``optimizer: sgd``,
``add_decayed_weights`` masked to parameters with ndim >= 2 and ``sgd``
with non-Nesterov momentum, carried out by ``torch.optim.SGD`` over two
parameter groups (with and without decay). Its update equals optax's:
trace = momentum * trace + g + wd * p, then p -= lr * trace. For
``optimizer: adamw`` it is ``optax.adamw(lr, weight_decay=wd,
mask=ndim >= 2)``, carried out by ``torch.optim.AdamW`` over the same two
groups: b1 0.9, b2 0.999, eps 1e-8 outside the square root, and the
decay decoupled from the moments and scaled by the LR,
p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch
from torch import nn

Schedule = Callable[[int], float]


def _cosine(base: float, decay_steps: int) -> Schedule:
    def schedule(count):
        count = min(count, decay_steps)
        return base * 0.5 * (1 + math.cos(math.pi * count / decay_steps))
    return schedule


def _staircase(base: float, transition_steps: int, rate: float) -> Schedule:
    if transition_steps <= 0:  # optax: a constant schedule
        return lambda count: base

    def schedule(count):
        if count <= 0:
            return base
        return base * rate ** math.floor(count / transition_steps)
    return schedule


def _piecewise(base: float, bounds: dict) -> Schedule:
    def schedule(count):
        v = base
        for threshold, scale in sorted(bounds.items()):
            if count >= threshold:
                v *= scale
        return v
    return schedule


def _linear(init: float, end: float, steps: int) -> Schedule:
    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def make_lr_schedule(cfg, steps_per_epoch: int) -> Schedule:
    """step -> learning rate (a Python float)."""
    base = cfg.base_learning_rate
    warmup_steps = int(cfg.warmup_epoch * steps_per_epoch)
    total_steps = max(int(cfg.epochs * steps_per_epoch), warmup_steps + 1)

    if cfg.lr_scheduler == "cosine":
        main = _cosine(base, max(total_steps - warmup_steps, 1))
    elif cfg.lr_scheduler == "step":
        main = _staircase(base, int(cfg.lr_decay_steps * steps_per_epoch),
                          cfg.lr_decay_rate)
    elif cfg.lr_scheduler == "multistep":
        main = _piecewise(base, {int(m * steps_per_epoch): cfg.lr_decay_rate
                                 for m in cfg.lr_milestones})
    else:
        raise ValueError(cfg.lr_scheduler)

    if warmup_steps > 0:
        warm = _linear(base * 0.01, base, warmup_steps)
        return lambda count: (warm(count) if count < warmup_steps
                              else main(count - warmup_steps))
    return main


class _Recipe:
    """An optimizer recipe; ``init`` binds it to a model's parameters.

    ``update`` applies one step to the gradients in ``p.grad``: clip by
    global norm, set every group's LR to ``lr_schedule(count)`` (count =
    updates already done, optax's ``count``), then the torch optimizer's
    ``step``. Weight decay goes to parameters with ndim >= 2 alone.
    """

    def __init__(self, lr_schedule: Schedule, weight_decay: float,
                 grad_clip: float):
        self.lr_schedule = lr_schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def _groups(self, model: nn.Module) -> List[dict]:
        params = list(model.parameters())
        return [{"params": [p for p in params if p.ndim >= 2],
                 "weight_decay": self.weight_decay},
                {"params": [p for p in params if p.ndim < 2],
                 "weight_decay": 0.0}]

    def init(self, model: nn.Module) -> torch.optim.Optimizer:
        raise NotImplementedError

    def update(self, opt: torch.optim.Optimizer, count: int) -> None:
        if self.grad_clip > 0:
            clip_by_global_norm_(
                [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None], self.grad_clip)
        lr = self.lr_schedule(count)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()


class SGD(_Recipe):
    """optax's ``add_decayed_weights`` + ``sgd`` (momentum, no Nesterov)."""

    def __init__(self, lr_schedule: Schedule, momentum: float,
                 weight_decay: float, grad_clip: float):
        super().__init__(lr_schedule, weight_decay, grad_clip)
        self.momentum = momentum

    def init(self, model: nn.Module) -> torch.optim.SGD:
        return torch.optim.SGD(self._groups(model), lr=self.lr_schedule(0),
                               momentum=self.momentum, dampening=0.0,
                               nesterov=False)


class AdamW(_Recipe):
    """optax's ``adamw`` with its default betas and eps."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def init(self, model: nn.Module) -> torch.optim.AdamW:
        return torch.optim.AdamW(self._groups(model), lr=self.lr_schedule(0),
                                 betas=(self.b1, self.b2), eps=self.eps)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place: when the global L2 norm n
    reaches max_norm, g <- (g / n) * max_norm (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, (g / norm) * max_norm, g))


def make_optimizer(cfg, steps_per_epoch: int) -> Tuple[_Recipe, Schedule]:
    """(optimizer recipe, lr schedule), as the JAX package's
    ``make_optimizer``."""
    lr = make_lr_schedule(cfg, steps_per_epoch)
    if cfg.optimizer == "sgd":
        return SGD(lr, cfg.momentum, cfg.weight_decay, cfg.grad_clip), lr
    if cfg.optimizer == "adamw":
        return AdamW(lr, cfg.weight_decay, cfg.grad_clip), lr
    raise ValueError(cfg.optimizer)
