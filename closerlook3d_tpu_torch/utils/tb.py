"""Scalar logging (``closerlook3d_tpu/utils/tb.py``): an always-on JSONL
stream, ``<logdir>/scalars.jsonl``, with the JAX package's record
(``tag``, ``value``, ``step``, ``ts``) so that one tool reads both
packages' runs, and TensorBoard through ``torch.utils.tensorboard`` where
that imports (it needs the ``tensorboard`` package).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class ScalarWriter:
    """Write scalars to <logdir>/scalars.jsonl and (if available) TB.

    ``logdir=None`` writes nothing (ranks other than 0). Writes after
    ``close`` are dropped, as in the JAX package: a ``validate`` after
    ``fit`` still returns its metrics."""

    def __init__(self, logdir: Optional[str]):
        self._jsonl = None
        self._tb = None
        if not logdir:
            return
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a",
                           buffering=1)
        try:  # TB is optional: it needs the tensorboard package
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(os.path.join(logdir, "tb"))

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is None or self._jsonl.closed:
            return
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def scalars(self, values: dict, step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
