"""Tracing and timing (``closerlook3d_tpu/utils/profiling.py``).

* ``trace(logdir)``: ``torch.profiler`` over the enclosed block, with
  CUDA activity where there is a card; writes a Chrome trace
  (``logdir/trace.json``, chrome://tracing or Perfetto).
* ``timeit(fn, *args)``: steady-state wall time, synchronizing the
  device of the result before each reading of the clock.
* ``cost_analysis(fn, *args)``: FLOPs of one call, as
  ``torch.utils.flop_counter`` counts them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block into ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


def _sync(result) -> None:
    """Wait for the device that holds ``result``'s first tensor."""
    t = _first_tensor(result)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 2,
           **kwargs) -> Dict[str, float]:
    """Steady-state wall time of ``fn(*args)``: {"mean_ms", "best_ms",
    "iters"}. Each call is timed up to the end of the device work that
    produced its result."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {"mean_ms": float(np.mean(times) * 1e3),
            "best_ms": float(np.min(times) * 1e3),
            "iters": iters}


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """{"flops": n}: the floating-point operations of one call of
    ``fn(*args)``, counted by ``torch.utils.flop_counter.FlopCounterMode``.

    Only the ATen operators it knows (matmuls, convolutions, attention)
    are counted: the hand-written CUDA kernels (``csrc/``), launched
    through ``ctypes``, and elementwise operators add nothing, so this is
    a lower bound of a model's work."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": int(counter.get_total_flops())}
