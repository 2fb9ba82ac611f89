"""Host-side cross-process reductions for evaluation metrics
(``closerlook3d_tpu/parallel/collectives.py``), single-process form.

The evaluators accumulate their counts and confusions in host numpy and
reduce them across processes through these three functions. In one
process each returns its input. Data parallelism, and with it the
reductions over ``torch.distributed``, is not ported yet: where
``torch.distributed`` runs more than one process, each function raises
rather than return one process's share as if it were the whole.
"""

from __future__ import annotations

import numpy as np
import torch


def _single_process(what: str) -> None:
    if (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            f"{what}: reductions across {torch.distributed.get_world_size()}"
            f" processes are not ported; evaluate in one process")


def all_processes_sum(tree):
    """Element-wise sum of a numpy pytree across processes: the input,
    in one process."""
    _single_process("all_processes_sum")
    return tree


def all_processes_min(x: float) -> float:
    """Global minimum of a per-process scalar: the input, in one
    process."""
    _single_process("all_processes_min")
    return x


def all_processes_concat(x: np.ndarray) -> np.ndarray:
    """Concatenation of per-process [n_p, ...] arrays along axis 0: the
    input, in one process."""
    _single_process("all_processes_concat")
    return np.asarray(x)
