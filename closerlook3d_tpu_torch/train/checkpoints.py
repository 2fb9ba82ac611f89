"""Checkpoint and resume (``closerlook3d_tpu/train/checkpoints.py``).

One file a step, ``<directory>/ckpt_<step>.pt``, written by ``torch.save``:
the model's ``state_dict`` (parameters and BatchNorm running statistics),
the optimizer's (momentum, or Adam's moments and counts), the step and a
numeric ``extra`` dict (the epoch, a best value). A save goes to a
temporary name and is renamed into place once complete, so a kill
mid-save never leaves a file that ``latest_step`` picks; keep-last-k
deletes the oldest files after that. ``restore`` maps the tensors to the
device of the state it fills, so a checkpoint written on the card
restores on the CPU.

In a process group of more than one process the ranks hold equal states
and share the directory: rank 0 alone writes and prunes, every rank waits
at a barrier after the save, and every rank restores the same file.
"""

from __future__ import annotations

import numbers
import os
import re
from typing import List, Optional

import torch

from closerlook3d_tpu_torch.parallel.collectives import barrier, world
from closerlook3d_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step)}.pt")

    def steps(self) -> List[int]:
        """The steps saved here, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: TrainState,
             extra: Optional[dict] = None) -> None:
        extra = dict(extra or {})
        bad = {k: v for k, v in extra.items()
               if not isinstance(v, numbers.Number)}
        if bad:
            raise TypeError(f"checkpoint extra must be numeric: {bad}")
        if world()[1] == 0:
            self._write(step, state, extra)
        barrier()

    def _write(self, step: int, state: TrainState, extra: dict) -> None:
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save({"step": int(step),
                        "model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict(),
                        "extra": extra}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        if self.keep > 0:
            for old in self.steps()[:-self.keep]:
                os.remove(self._path(old))

    def restore(self, state: TrainState, step: Optional[int] = None):
        """Fill ``state`` in place from the latest (or the given) step;
        returns (state, extra, step), or (None, None, None) if there is
        no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        device = next(state.model.parameters()).device
        payload = torch.load(self._path(step), map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state, payload["extra"] or None, step

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open between saves."""
