"""Run a function in ranks of one host, each in a process of its own.

``run_ranks(fn, world_size, args, device=..., timeout=...)`` starts
``world_size`` processes with ``torch.multiprocessing.start_processes``
by the ``spawn`` method (never ``fork``, which would copy a parent's
CUDA state), joins them into one process group through a ``file://``
rendezvous in a fresh temporary directory (no port to pick, so
concurrent runs cannot collide), calls ``fn(rank, *args)`` in each, and
returns the ranks' results in rank order. ``fn`` must be importable by
name (a module-level function).

It never leaves a rank waiting on a dead peer: when one rank fails,
``start_processes`` ends the others, and the failure is raised with the
traceback of the rank that failed first; past ``timeout`` seconds every
rank still running is killed, and the error names them (a collective
waits a minute longer than that before it gives up by itself, so that
the limit, and not a peer's time-out, ends a hung run). Kernels the
ranks launch should be built before (the built libraries are shared
files, ``ops/kernels.py``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time


def _rank_main(rank, fn, world_size, init_method, device, args, root,
               threads, timeout):
    import torch

    from closerlook3d_tpu_torch.parallel import mesh

    if threads:
        torch.set_num_threads(threads)
    mesh.maybe_initialize_distributed(
        device, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout + 60))
    out = os.path.join(root, f"rank{rank}.pt")
    # a rank that raises leaves without leaving the group: its traceback
    # is written first, and its peers are ended
    torch.save(fn(rank, *args), out + ".tmp")
    os.replace(out + ".tmp", out)
    mesh.destroy()


def run_ranks(fn, world_size: int, args=(), *, device="cpu",
              timeout: float = 120.0, threads=None) -> list:
    """``[fn(0, *args), ..., fn(world_size - 1, *args)]``, each run in its
    own rank (see the module's note). ``threads`` sets each rank's ATen
    threads."""
    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    root = tempfile.mkdtemp(prefix="cl3d_ranks_")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, f"file://{root}/rendezvous",
                          device, args, root, threads, timeout),
        nprocs=world_size, join=False, daemon=True, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                alive = [r for r, p in enumerate(ctx.processes)
                         if p.is_alive()]
                raise TimeoutError(
                    f"rank(s) {alive} of {world_size} still running after "
                    f"{timeout:.0f} s; all ranks killed")
        return [torch.load(os.path.join(root, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
    except ProcessException:
        raise RuntimeError(_failure(ctx)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        for f in ctx.error_files:
            if os.path.exists(f):
                os.remove(f)
        shutil.rmtree(root, ignore_errors=True)


def _failure(ctx) -> str:
    """The failed ranks, the first of them (by the time of its traceback:
    a rank that dies takes down its peers' collectives) named first, with
    its traceback."""
    def when(r):
        f = ctx.error_files[r]
        return os.path.getmtime(f) if os.path.exists(f) else float("inf")

    failed = sorted((r for r, p in enumerate(ctx.processes)
                     if p.exitcode != 0), key=when)
    first = ctx.error_files[failed[0]]
    if os.path.exists(first):
        with open(first, "rb") as f:
            trace = pickle.load(f)
    else:
        trace = "(no traceback: the process ended by a signal)"
    return (f"rank(s) {failed} failed, rank {failed[0]} first (exit codes "
            f"{[ctx.processes[r].exitcode for r in failed]}); the others "
            f"were killed\n--- rank {failed[0]} ---\n{trace}")
