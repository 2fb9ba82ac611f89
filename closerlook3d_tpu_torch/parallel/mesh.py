"""Process layout and batch placement (``closerlook3d_tpu/parallel/mesh.py``).

The JAX package runs data parallelism as GSPMD: one global batch sharded
over a ``data`` mesh axis, every BatchNorm statistic, loss mean and
gradient taken over the global batch. The port runs it as one process a
rank over ``torch.distributed``: each process holds its own rows of the
global batch (``cfg.batch_size`` is the per-process batch, as on the JAX
package's multi-host runs) and the collectives of
``parallel/collectives.py`` make the statistics, the loss denominators,
the metrics and the gradients those of the global batch.

``maybe_initialize_distributed`` joins the process group, from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or from explicit
arguments, before anything touches the device. The backend follows from
the layout alone: NCCL where every local rank has a card of its own;
gloo on the CPU and where ranks share a card (gloo reduces CUDA tensors
through the host; NCCL refuses two ranks on one device). Beside an NCCL
group a gloo group carries the host reductions (numpy in, numpy out),
which NCCL cannot.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# how long a collective may wait for its peers before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_LOG = logging.getLogger("closerlook3d_torch")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where this process sits: ``world_size`` ranks, this one ``rank``
    (``local_rank`` of ``local_world_size`` on its host), its ``device``
    and the process group's ``backend`` ("nccl", "gloo", or None in one
    process)."""

    world_size: int = 1
    rank: int = 0
    local_rank: int = 0
    local_world_size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None


_LAYOUT: Optional[Layout] = None
_HOST_GROUP = None  # the gloo group of an NCCL job, for host reductions


def plan_layout(device, world_size: int, rank: int, local_rank: int,
                local_world_size: int) -> Layout:
    """The layout of one rank: on the CPU, gloo; on CUDA, the rank's card
    ``cuda:{local_rank}`` and NCCL where the host has a card for every
    local rank, else ``cuda:{local_rank % cards}`` shared with other
    ranks, and gloo. The NCCL layout (and the gloo host group beside it)
    is untested: it has run neither in a test nor on a card, where only
    ranks sharing one card (gloo) have."""
    device = torch.device(device)
    if device.type == "cpu":
        return Layout(world_size, rank, local_rank, local_world_size,
                      torch.device("cpu"), "gloo")
    if device.type != "cuda":
        raise ValueError(f"data parallelism runs on cuda or cpu, not "
                         f"{device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for and CUDA is not available; "
            f"pass device='cpu' (--device cpu) to run on the CPU")
    cards = torch.cuda.device_count()
    if cards >= local_world_size:
        return Layout(world_size, rank, local_rank, local_world_size,
                      torch.device("cuda", local_rank), "nccl")
    return Layout(world_size, rank, local_rank, local_world_size,
                  torch.device("cuda", local_rank % cards), "gloo")


def maybe_initialize_distributed(device="cuda", *, init_method=None,
                                 world_size=None, rank=None,
                                 timeout=DEFAULT_TIMEOUT) -> bool:
    """Join the process group; call before anything uses the device.

    Without ``init_method`` the job comes from torchrun's environment; a
    process without ``WORLD_SIZE`` there is a run of its own, and this
    returns False (``layout(device)`` is then one process). With
    ``init_method`` (``file://...`` or ``tcp://host:port``),
    ``world_size`` and ``rank`` name a job on one host (the local rank
    is the rank). Returns True once the group is up; the layout and
    backend are logged."""
    global _LAYOUT, _HOST_GROUP
    if init_method is None:
        if not os.environ.get("WORLD_SIZE"):
            return False
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                              world_size))
        init_method = "env://"
    elif world_size is None or rank is None:
        raise ValueError("init_method needs world_size and rank")
    else:
        local_rank, local_world_size = rank, world_size
    lay = plan_layout(device, world_size, rank, local_rank, local_world_size)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} (rank "
                f"{dist.get_rank()}) is already up; asked for "
                f"{world_size} (rank {rank})")
    else:
        if lay.device.type == "cuda":
            torch.cuda.set_device(lay.device)
        kwargs = {}
        if lay.backend == "nccl":
            kwargs["device_id"] = lay.device
        dist.init_process_group(lay.backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timeout, **kwargs)
        if lay.backend == "nccl":
            _HOST_GROUP = dist.new_group(backend="gloo", timeout=timeout)
    _LAYOUT = lay
    _LOG.info("process group: rank %d of %d (local %d of %d) on %s, %s",
              lay.rank, lay.world_size, lay.local_rank,
              lay.local_world_size, lay.device, lay.backend)
    return True


def layout(device="cuda") -> Layout:
    """This process's layout: the process group's where one is up, else
    one process on ``device``."""
    if _LAYOUT is not None and dist.is_initialized():
        return _LAYOUT
    return Layout(device=torch.device(device))


def host_group():
    """The group of the host reductions: the gloo group beside an NCCL
    one, else the default group."""
    return _HOST_GROUP if dist.is_initialized() else None


def destroy() -> None:
    """Leave the process group (each rank, at the end of its run)."""
    global _LAYOUT, _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _LAYOUT = _HOST_GROUP = None


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              lay: Optional[Layout] = None) -> Layout:
    """Check the config's parallelism against the layout and return it.

    ``data_parallel`` is -1 (every rank) or the world size: each rank is
    one data-parallel replica. ``model_parallel`` must be 1: the JAX
    package shards nothing over its ``model`` axis (batches are
    ``P("data")``, parameters replicated), so there is nothing to split.
    """
    lay = lay if lay is not None else layout()
    if model_parallel != 1:
        raise ValueError(
            f"model_parallel={model_parallel}: the parameters are "
            f"replicated on every rank; only model_parallel=1 exists")
    if data_parallel not in (-1, lay.world_size):
        raise ValueError(
            f"data_parallel={data_parallel} with {lay.world_size} "
            f"process(es): each process is one data-parallel rank, so "
            f"data_parallel must be -1 or {lay.world_size} (launch "
            f"{data_parallel} processes with torchrun --nproc_per_node)")
    return lay


def shard_batch(batch: dict, lay: Layout) -> dict:
    """The process-local batch (numpy arrays or tensors) on the rank's
    device: through pinned memory with non-blocking copies on CUDA, so
    the host does not wait for the copy."""
    dev = lay.device
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(v) if isinstance(
            v, np.ndarray) else v)
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[k] = t
    return out
