"""Reductions across processes (``closerlook3d_tpu/parallel/collectives.py``).

Two kinds, both over ``torch.distributed``'s default process group:

* host reductions for the evaluators and validation, numpy in, numpy
  out, with the JAX semantics (a pytree stays a pytree, a scalar stays a
  scalar, a ragged concat works): ``all_processes_sum``,
  ``all_processes_min``, ``all_processes_concat``. They run over the gloo
  group (``parallel/mesh.py::host_group``);
* tensor reductions on the device for the train step: ``all_reduce_sum``
  (in the autograd graph: its backward sums the cotangents over ranks),
  ``reduce_sum`` (no gradient: loss denominators and metrics) and
  ``reduce_gradients`` (one bucketed sum of every parameter's gradient).

Each is the identity in one process, and every one is a collective: with
more than one process every rank calls it the same number of times, in
the same order, with tensors of equal shape. The JAX package's
``process_local_rows`` has no counterpart: a rank's tensors hold only
its own rows.

``COUNTS`` tallies the device collectives and their host time.
"""

from __future__ import annotations

import time
from typing import Iterable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from closerlook3d_tpu_torch.parallel.mesh import host_group

# device collectives since the last reset: calls, host seconds
COUNTS = {"calls": 0, "seconds": 0.0}


def reset_counts() -> None:
    COUNTS.update(calls=0, seconds=0.0)


def world() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def distributed() -> bool:
    """True where a process group of more than one process is up."""
    return world()[0] > 1


def _sum_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over ranks of a contiguous tensor, counted."""
    t0 = time.perf_counter()
    dist.all_reduce(t)
    COUNTS["calls"] += 1
    COUNTS["seconds"] += time.perf_counter() - t0
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the summed value, so each rank's input
        # gets the cotangents of all ranks
        return _sum_(g.clone(memory_format=torch.contiguous_format))


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over ranks, differentiable: the backward sums the
    cotangents over ranks. ``t`` itself in one process."""
    if not distributed():
        return t
    return _AllReduceSum.apply(t)


@torch.no_grad()
def reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over ranks, outside the graph; ``t`` in one process."""
    if not distributed():
        return t
    return _sum_(t.detach().clone(memory_format=torch.contiguous_format))


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every gradient by its sum over ranks, in one all-reduce of
    the flattened gradients a dtype (a missing gradient counts as 0 and
    is set)."""
    if not distributed():
        return
    by_dtype = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = _sum_(torch.cat([p.grad.reshape(-1) for p in ps]))
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad.copy_(g.view_as(p.grad))


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers into every rank's
    ``module``, one broadcast a dtype."""
    if not distributed():
        return
    with torch.no_grad():
        by_dtype = {}
        for t in list(module.parameters()) + list(module.buffers()):
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))


def barrier() -> None:
    """Wait for every rank (a no-op in one process)."""
    if distributed():
        dist.barrier(group=host_group())


# ---- host reductions --------------------------------------------------------

def _allgather(x: np.ndarray) -> np.ndarray:
    """[P, ...] stack of ``x`` over ranks (same shape on every rank)."""
    t = torch.from_numpy(np.array(x, order="C", copy=True))
    out = [torch.empty_like(t) for _ in range(world()[0])]
    dist.all_gather(out, t, group=host_group())
    return torch.stack(out).numpy()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def all_processes_sum(tree):
    """Element-wise sum of a numpy pytree across processes.

    Scalars stay scalars (Python numbers come back as the sum's item);
    arrays keep their shape, which must match across processes. One
    process: the input."""
    if not distributed():
        return tree

    def _sum(x):
        arr = np.asarray(x)
        out = _allgather(arr).sum(axis=0)
        return out.item() if arr.ndim == 0 else out

    return _tree_map(_sum, tree)


def all_processes_min(x: float) -> float:
    """Global minimum of a per-process scalar (one process: the input).
    Keeps loops whose rounds call collectives in lockstep, as the S3DIS
    voting loop's."""
    if not distributed():
        return x
    return float(_allgather(np.asarray(x, np.float64)).min())


def all_processes_concat(x: np.ndarray) -> np.ndarray:
    """Concatenation of per-process [n_p, ...] arrays along axis 0, in
    rank order; n_p may differ by process (the lengths are gathered
    first, the rows padded to the longest and cut back). One process:
    the input."""
    x = np.asarray(x)
    if not distributed():
        return x
    lens = _allgather(np.asarray([x.shape[0]], np.int64))[:, 0]
    m = int(lens.max())
    pad = np.zeros((m - x.shape[0],) + x.shape[1:], x.dtype)
    gathered = _allgather(np.concatenate([x, pad], axis=0))
    return np.concatenate(
        [gathered[p, :int(lens[p])] for p in range(len(lens))], axis=0)


def rows_of_rank(n: int) -> slice:
    """The rows of this rank in a global tensor of ``world * n`` rows:
    rank r holds rows [r n, (r + 1) n)."""
    _, rank = world()
    return slice(rank * n, (rank + 1) * n)

