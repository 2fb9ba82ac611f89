"""Reverse (CSR) neighbor index: from support rows to the slots naming them.

For idx, mask [B, Nq, K] (slot t of query q names support row idx[q, t]
where mask[q, t]) and Ns support rows, the index holds per cloud b

    offsets [B, Ns + 1] int32: row s holds entries offsets[b, s] ..
                               offsets[b, s + 1] - 1;
    slots   [B, Nq * K] int32: slots[b, e] = q * K + t of those entries,
                               each row's in ascending (q, t) order;
                               entries from offsets[b, Ns] on are unused.

Masked slots, and valid ones whose index lies outside [0, Ns), are left
out. The backward kernels of the point-wise MLP's statistics (K6,
``ops/gather_reduce.py``) and of the pseudo-grid (K10,
``ops/pseudo_grid.py``) build it in the first of their two launches
(``csrc/reverse_index.cuh``, in buffers from ``index_buffers``), so that
a group of lanes owning a support row reads that row's terms in (q, t)
order, the order of their plain twins' ``index_add_``. Those of PosPool
xyz and sin/cos (K1, K5, ``ops/aggregation.py``), of the neighborhood
moments (K9, ``ops/moments.py``) and of the neighborhood max (K8,
``ops/grouping.py``) and of the point-wise MLP's gather-subtract
min/max (K7, ``ops/gather_reduce.py``) build it in ``index_tiles`` tiles of
consecutive queries a cloud, a block each (``csrc/row_terms.cuh``): tile
i's offsets index its own entries, each holding its query, and a row's
entries, tile after tile, are again in (q, t) order. No TPU kernel
corresponds to it (the Pallas backwards scatter by one-hot matmuls).
``reverse_index_cuda`` launches it alone (``csrc/reverse_index.cu``),
which the card tests and ``chip_smoke.py`` hold to
``reverse_index_plain``.
"""

from __future__ import annotations

import functools

import torch

from closerlook3d_tpu_torch.ops import kernels


def reverse_index_plain(idx, mask, ns: int):
    """(offsets [B, Ns + 1], slots [B, Nq * K]) int32, as the module says;
    unused entries of ``slots`` are -1."""
    b, nq, k = idx.shape
    flat = idx.reshape(b, nq * k).long()
    valid = mask.reshape(b, nq * k) & (flat >= 0) & (flat < ns)
    cloud, slot = torch.nonzero(valid, as_tuple=True)  # (b, q, t) order
    key = cloud * ns + flat[cloud, slot]
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=b * ns).reshape(b, ns)
    offsets = torch.zeros((b, ns + 1), dtype=torch.int64, device=idx.device)
    offsets[:, 1:] = torch.cumsum(counts, dim=1)
    first = torch.cumsum(offsets[:, -1], 0) - offsets[:, -1]  # per cloud
    cloud = cloud[order]
    place = torch.arange(len(order), device=idx.device) - first[cloud]
    slots = torch.full((b, nq * k), -1, dtype=torch.int32, device=idx.device)
    slots[cloud, place] = slot[order].to(torch.int32)
    return offsets.to(torch.int32), slots


# csrc/row_terms.cuh: the reverse index of K1b, K5b, K9b, K8b and K7b in
# query tiles
MAX_TILES = 16  # kMaxTiles
TILE_MIN_SLOTS = 16384


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def index_tiles(b: int, nq: int, k: int, device) -> int:
    """Query tiles a cloud in the reverse index of K1b, K5b, K9b, K8b and
    K7b, each built by a block of its own: at most one block an SM over
    the B clouds (4 at B = 32 on 132 SMs) and MAX_TILES, each of at least
    TILE_MIN_SLOTS slots (the gather reads a row's entries tile by tile,
    which costs more the more tiles hold them)."""
    return max(1, min(MAX_TILES, _sm_count(torch.device(device).index) // b,
                      nq * k // TILE_MIN_SLOTS))


def index_buffers(b: int, nq: int, ns: int, k: int, device):
    """Uninitialized int32 buffers of a reverse index, one allocation:
    (offsets [B, Ns + 1], slots [B, Nq * K], and the kernel's scratch: the
    unsorted slots [B * Nq * K] and the global counters [B * (Ns + 1)],
    used where Ns outgrows shared memory)."""
    rows, n = ns + 1, nq * k
    buf = torch.empty(b * (2 * rows + 2 * n), dtype=torch.int32,
                      device=device)
    return (buf[:b * rows].view(b, rows),
            buf[b * rows:b * (rows + n)].view(b, n),
            buf[b * (rows + n):b * (rows + 2 * n)],
            buf[b * (rows + 2 * n):])


def launch_backward_gather(source: str, what: str, inputs, shape, dy,
                           radius: float, reduction: str, *,
                           name: str = "", scratch=None, out_dtype=None,
                           extra_outputs=()) -> torch.Tensor:
    """Call ``cl3d_<name or source>_bwd`` of ``csrc/<source>.cu``, a
    backward that gathers per support row over a reverse neighbor index
    built in query tiles (``csrc/row_terms.cuh``): ``inputs`` (the points
    and tables, then idx, mask and dy), (B, Nq, Ns, C, K), the tiles a
    cloud (``index_tiles``), radius, avg and is_bf16, then the index
    buffers (``index_buffers``), g (for avg a buffer that the first launch
    fills with dy / max(count, 1), or for the neighborhood max with dy /
    (tying slots); for sum dy itself; ``scratch`` where given, such as the
    point-wise MLP's f32 shares), the output, ``extra_outputs`` and the
    stream. Returns d out / d features [B, Ns, C] in ``out_dtype`` (dy's
    dtype by default), every element written by the gather; raises if the
    launch fails."""
    b, nq, ns, c, k = shape
    kernels.require(nq * k < 2 ** 31 - 1, f"{what}: need Nq * K < 2^31 - 1")
    tiles = index_tiles(b, nq, k, dy.device)
    index = index_buffers(b * tiles, -(-nq // tiles), ns, k, dy.device)
    if scratch is None:
        scratch = torch.empty_like(dy) if reduction == "avg" else dy
    df = torch.empty((b, ns, c), dtype=out_dtype or dy.dtype,
                     device=dy.device)
    outputs = (scratch, df, *extra_outputs)
    lib, fn = kernels.entry(
        source, f"cl3d_{name or source}_bwd", [kernels.P] * len(inputs)
        + [kernels.I] * 6 + [kernels.F] + [kernels.I] * 2
        + [kernels.P] * (len(index) + len(outputs) + 1))
    with torch.cuda.device(dy.device):
        err = fn(*[t.data_ptr() for t in inputs], *shape, tiles, radius,
                 int(reduction == "avg"), int(df.dtype == torch.bfloat16),
                 *[t.data_ptr() for t in (*index, *outputs)],
                 kernels.stream_of(df))
    kernels.check(lib, err, what)
    return df


def reverse_index_cuda(idx, mask, ns: int):
    """Launch ``csrc/reverse_index.cu``: (offsets, slots) as the module
    says; unused entries of ``slots`` are left unwritten. The counters live
    in shared memory where Ns allows (every config of the repo: at most
    15000 rows, 60 KB), else in a global scratch. Raises on anything the
    kernel does not take."""
    what = "reverse_index_cuda"
    b, nq, k = idx.shape
    kernels.require_cuda(what, idx=idx, mask=mask)
    kernels.require(idx.dtype == torch.int32 and mask.dtype == torch.bool,
                    f"{what}: idx must be int32 and mask bool")
    kernels.require(mask.shape == idx.shape,
                    f"{what}: idx and mask must both be [B, Nq, K]")
    kernels.require(1 <= b <= 65535 and ns >= 1 and k >= 1
                    and nq * k < 2 ** 31 - 1,
                    f"{what}: need 1 <= B <= 65535, Ns >= 1, K >= 1 and "
                    f"Nq * K < 2^31 - 1")
    offsets, slots, raw, counters = index_buffers(b, nq, ns, k, idx.device)
    lib, fn = kernels.entry(
        "reverse_index", "cl3d_reverse_index",
        [kernels.P] * 2 + [kernels.I] * 4 + [kernels.P] * 5)
    with torch.cuda.device(idx.device):
        err = fn(idx.data_ptr(), mask.data_ptr(), b, nq, ns, k,
                 offsets.data_ptr(), slots.data_ptr(),
                 raw.data_ptr(), counters.data_ptr(), kernels.stream_of(idx))
    kernels.check(lib, err, what)
    reverse_index_cuda.launches += 1
    return offsets, slots


reverse_index_cuda.launches = 0

