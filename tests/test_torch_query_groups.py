"""The query-group layout of the forward kernels K10f, K5f, K1f, K9f and
K6f (``csrc/query_groups.cuh``, ``csrc/pseudo_grid.cu``,
``csrc/pospool_sincos.cu``, ``csrc/pospool_xyz.cu``, ``csrc/moments.cu``,
``csrc/gather_reduce.cu``), emulated in PyTorch on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them to their plain versions there). Here the
layout and each output element's order of operations are mirrored:

* the ballot compaction (``stage_valid_slots``): lane by lane and round
  by round, the valid slots (mask set, idx >= 0) come out in ascending
  slot order at every group width, so the sums run in the order of the
  parent kernels' loops over all K slots that skip the masked ones;
* the host's choices (``group_lanes_for``, ``split_passes``, the vector
  or scalar units of ``ChannelUnit``) and the unit, pair and slice
  mapping: every output element written exactly once, by the item of its
  own query (K10f's unit of kW channels by kPC kernel points, K5f's
  sin/cos pair, K1f's and K9f's 16 bytes of channels, of one coordinate
  for K1f, K6f's 4 channels of each of its four outputs), Nq off the
  groups a block;
* each element's arithmetic: K10f ``fma(w, f, acc)`` over the compacted
  slots from +0, rounded once (the fma emulated in f64: the product is
  exact there, the sum rounds twice, which can differ from the card's
  one rounding in the last bit); K5f ``acc + f * round_T(sin/cos)`` in
  f32, then avg; K1f ``acc + v * D[d]`` and K9f ``a0 + v``,
  ``a(d+1) + v * D[d]`` in f32, then avg, equal to the bit to their
  parents' loops over all K slots (emulated). The emulations are held to
  the plain versions (``pseudo_grid_plain``, ``pospool_sincos_plain``,
  ``pospool_xyz_plain``, ``neighborhood_moments_plain``) at the
  tolerances of ``chip_smoke.py``, and to the JAX package:
  ``pseudo_grid_fused``, the sin/cos and xyz ``pospool_fused`` and
  ``neighborhood_moments`` run interpreted, as
  ``tests/test_torch_pseudo_grid.py``, ``tests/test_torch_grad.py`` and
  ``tests/test_torch_operators.py`` run them;
* K6f's extrema (the first valid slot sets them, the others update them,
  a NaN wins and stays) and its f64 sums of g and gsq from +0, rounded
  once, over the compacted slots: equal to the bit to its parent's loop
  (NaNs included), to ``pwmlp_minmax_stats_plain`` in value (sums within
  an f32 rounding), and within the JAX package's tolerances of its
  ``pwmlp_minmax_stats`` run interpreted at B·Nq = 128 (the Pallas K6
  kernel, as ``tests/test_torch_pwmlp.py`` runs it).

Edge cases: an all-masked query, K = 64, Kp = 1 and 64, C off the vector
width, duplicated valid indices, idx < 0 under a set mask.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.ops.pallas import gather_reduce as jgather_reduce
from closerlook3d_tpu.ops.pallas import pseudo_grid as jpseudo_grid
from closerlook3d_tpu.ops.pallas.aggregation import (
    pospool_fused as jpospool_fused)
from closerlook3d_tpu.ops.pallas.moments import (
    neighborhood_moments as jmoments)
from closerlook3d_tpu_torch.models import aggregation as agg
from closerlook3d_tpu_torch.ops import (
    aggregation, gather_reduce, moments, pseudo_grid)
from closerlook3d_tpu_torch.ops.grouping import neighbor_offsets
from closerlook3d_tpu_torch.ops.neighbors import MAX_K, ball_query

GROUP_THREADS = 256  # kGroupThreads
FILL_THREADS = 4096  # kFillThreads
H100_SMS = 132


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the host's choices (query_groups.cuh) ---------------------------------

def group_lanes_for(units: int, narrowest: int = 8) -> int:
    """The largest of 32, 16, 8 lanes (down to ``narrowest``) whose passes
    keep >= 85% busy, else the busiest."""
    best, best_busy = 32, 0.0
    for g in (32, 16, 8):
        if g < narrowest:
            break
        busy = units / (math.ceil(units / g) * g)
        if busy >= 0.85:
            return g
        if busy > best_busy:
            best, best_busy = g, busy
    return best


def split_passes(queries: int, passes: int, lanes: int, sms: int = H100_SMS):
    """(slices, passes a slice) of each query's passes."""
    want = sms * FILL_THREADS // lanes
    slices = min(passes, max(1, -(-want // queries)))
    per = -(-passes // slices)
    return -(-passes // per), per


def pgrid_layout(c: int, kpn: int, elem_bytes: int, queries: int):
    """K10f's launch: units of kW channels (16 bytes) x kPC kernel points,
    32 sums a lane where Kp fills a chunk and the units make two passes
    of 32 lanes, else 16."""
    kw = 16 // elem_bytes
    cvs = -(-c // kw)
    sums = 32 if kpn >= 32 // kw and cvs * -(-kpn // (32 // kw)) >= 64 else 16
    kpc = sums // kw
    kpw = -(-kpn // kpc) * kpc
    units = cvs * (kpw // kpc)
    lanes = group_lanes_for(units)
    slices, per = split_passes(queries, -(-units // lanes), lanes)
    return dict(kw=kw, kpc=kpc, kpw=kpw, cvs=cvs, units=units, lanes=lanes,
                slices=slices, per=per, sums=sums)


def sincos_layout(c: int, queries: int):
    """K5f's launch: a (coordinate, frequency) pair a lane and pass."""
    pairs = c // 2
    lanes = group_lanes_for(pairs)
    slices, per = split_passes(queries, -(-pairs // lanes), lanes)
    return dict(pairs=pairs, lanes=lanes, slices=slices, per=per)


# K1f's and K9f's units (kXyzBytes, kMomentsBytes), K6f's (kStatsChannels
# channels of g and gsq: 8 bytes of bf16, 16 of f32) and narrowest groups
# (kXyzLanes; K9f takes 8; kStatsLanes)
UNIT_BYTES = {"xyz": 16, "moments": 8}
STATS_CHANNELS = 4
NARROWEST = {"xyz": 16, "moments": 8, "pwstats": 8}


def unit_layout(op: str, c: int, elem_bytes: int, queries: int,
                aligned: bool = True):
    """K1f's (op "xyz"), K9f's ("moments") or K6f's ("pwstats") launch:
    units of kW channels (16 bytes for K1f, 8 for K9f, 4 channels for
    K6f), vectors where the rows allow them (``runs_ok``: K1f's C/3, K9f's
    and K6f's C a multiple of kW, and pointers aligned to the unit), else
    scalar units of the same channels."""
    kw = (STATS_CHANNELS if op == "pwstats"
          else UNIT_BYTES[op] // elem_bytes)
    vec = aligned and (c // 3 if op == "xyz" else c) % kw == 0
    units = -(-c // kw)
    lanes = group_lanes_for(units, NARROWEST[op])
    slices, per = split_passes(queries, -(-units // lanes), lanes)
    return dict(kw=kw, vec=vec, units=units, lanes=lanes, slices=slices,
                per=per)


def unit_channels(lay: dict, c: int, sl: int, lg: int):
    """The units lane ``lg`` takes in slice ``sl`` (the kernel's loop from
    slice * per * lanes + lg, step lanes, to u_end): [(ch0, channels)]."""
    lanes, kw = lay["lanes"], lay["kw"]
    u_end = min(lay["units"], (sl + 1) * lay["per"] * lanes)
    return [(u * kw, [ch for ch in range(u * kw, u * kw + kw) if ch < c])
            for u in range(sl * lay["per"] * lanes + lg, u_end, lanes)]


def unit_coordinates(lay: dict, c: int, ch0: int):
    """Each channel's coordinate as a unit of K1f reads it: ch0 / g for a
    vector unit, min((ch0 + i) / g, 2) element by element for a scalar
    one (g = C/3)."""
    g = c // 3
    return [ch0 // g if lay["vec"] else min((ch0 + i) // g, 2)
            for i in range(lay["kw"])]


def items_of_block(block: int, lanes: int, items: int, slices: int):
    """``group_item`` of each group of a block: (row, slice) or None."""
    groups = GROUP_THREADS // lanes
    out = []
    for g in range(groups):
        item = block * groups + g
        out.append((item // slices, item % slices) if item < items else None)
    return out


# ---- ballot compaction (stage_valid_slots) -----------------------------------

def ballot_order(idx: torch.Tensor, mask: torch.Tensor, lanes: int):
    """Each query's valid slots as the group's ballots number them: lane lg
    reads slots lg + lanes * h; in round h a valid slot takes place
    n + (valid lanes below it), then n grows by the round's count.
    Returns ([Q, MAX_K] slot numbers, -1 past n; [Q] n)."""
    q, k = idx.shape
    order = torch.full((q, MAX_K), -1, dtype=torch.long)
    n = torch.zeros(q, dtype=torch.long)
    for h in range(MAX_K // lanes):
        t = torch.arange(lanes) + lanes * h
        tt = t.clamp(max=k - 1)
        v = (t < k) & mask[:, tt] & (idx[:, tt] >= 0)
        at = n[:, None] + torch.cumsum(v.long(), 1) - v.long()
        rows, lane = v.nonzero(as_tuple=True)
        order[rows, at[rows, lane]] = t[lane]
        n += v.sum(1)
    return order, n


# ---- emulations of the kernels ----------------------------------------------

def _compacted(idx, mask, lanes):
    b, nq, k = idx.shape
    order, n = ballot_order(idx.reshape(-1, k), mask.reshape(-1, k), lanes)
    return order, n, idx.reshape(-1, k).long()


def pgrid_emulated(q, s, f, idx, mask, kp, radius, extent, mode, lanes):
    """K10f, element by element: fma(w, f, acc) over the compacted valid
    slots from +0 in f32 (the fma through f64), rounded once."""
    b, nq, k = idx.shape
    kpn, c = kp.shape[0], f.shape[-1]
    order, n, flat = _compacted(idx, mask, lanes)
    w_all = pseudo_grid.influence_weights(q, s, idx, mask, kp, radius,
                                          extent, mode).reshape(-1, k, kpn)
    rows = torch.arange(b * nq)
    cloud = rows // nq
    acc = torch.zeros((b * nq, kpn, c), dtype=torch.float32)
    for i in range(int(n.max())):
        t = order[:, i]
        live = t >= 0
        tt = t.clamp(min=0)
        w = w_all[rows, tt].double()
        fj = f.float()[cloud, flat[rows, tt]].double()
        new = (w[:, :, None] * fj[:, None, :] + acc.double()).float()
        acc = torch.where(live[:, None, None], new, acc)
    return acc.reshape(b, nq, kpn * c).to(f.dtype)


def sincos_emulated(q, s, f, idx, mask, radius, reduction, lanes):
    """K5f, element by element: acc + f * round_T(sin/cos of
    (100 * D) / freq) over the compacted valid slots, f32; avg divides by
    max(n, 1)."""
    b, nq, k = idx.shape
    c = f.shape[-1]
    nf = c // 6
    order, n, flat = _compacted(idx, mask, lanes)
    d_all = neighbor_offsets(q, s, idx, radius,
                             torch.float32).reshape(-1, k, 3)
    freq = aggregation.sincos_freq(c, "cpu")
    p = torch.arange(c // 2)
    dd, jj = p // nf, p % nf
    c_sin = dd * 2 * nf + jj
    c_cos = c_sin + nf
    rows = torch.arange(b * nq)
    cloud = rows // nq
    acc = torch.zeros((b * nq, c), dtype=torch.float32)
    for i in range(int(n.max())):
        t = order[:, i]
        live = t >= 0
        tt = t.clamp(min=0)
        ang = (aggregation.SINCOS_ALPHA * d_all[rows, tt][:, dd]) / freq[jj]
        e = torch.empty((b * nq, c), dtype=torch.float32)
        e[:, c_sin] = torch.sin(ang).to(f.dtype).float()
        e[:, c_cos] = torch.cos(ang).to(f.dtype).float()
        fj = f.float()[cloud, flat[rows, tt]]
        acc = torch.where(live[:, None], acc + fj * e, acc)
    if reduction == "avg":
        acc = acc / n.clamp(min=1).float()[:, None]
    return acc.reshape(b, nq, c).to(f.dtype)


def _slot_terms(op, q, s, f, idx, mask, radius):
    """Each slot's f32 terms of K1f (v * D[c / (C/3)]) or K9f (v, then
    v * D[d]) as [Q, K, C] tensors, each product rounded to f32 once, and
    the valid slots [Q, K] (mask set, idx >= 0; other slots name row 0)."""
    b, nq, k = idx.shape
    c = f.shape[-1]
    valid = (mask & (idx >= 0)).reshape(-1, k)
    safe = torch.where(mask & (idx >= 0), idx, torch.zeros_like(idx))
    d = neighbor_offsets(q, s, safe, radius, f.dtype).float()
    d = d.reshape(-1, k, 3)
    cloud = torch.arange(b * nq) // nq
    v = f.float()[cloud[:, None], safe.reshape(-1, k).long()]  # [Q, K, C]
    if op == "xyz":
        return [v * d.repeat_interleave(c // 3, dim=-1)], valid
    return [v] + [v * d[..., j:j + 1] for j in range(3)], valid


def _finish(acc, n, reduction, shape, dtype):
    out = torch.cat(acc, dim=-1)
    if reduction == "avg":
        out = out / n.clamp(min=1).float()[:, None]
    return out.reshape(*shape, -1).to(dtype)


def unit_emulated(op, q, s, f, idx, mask, radius, reduction, lanes):
    """K1f or K9f, element by element: each sum adds its slot's term
    (acc + v * D) over the compacted valid slots, in the group's ballot
    order, in f32 from +0; avg divides by max(n, 1); rounded once."""
    b, nq, k = idx.shape
    order, n, _ = _compacted(idx, mask, lanes)
    terms, _ = _slot_terms(op, q, s, f, idx, mask, radius)
    rows = torch.arange(b * nq)
    acc = [torch.zeros_like(x[:, 0]) for x in terms]
    for i in range(int(n.max())):
        t = order[:, i]
        live = (t >= 0)[:, None]
        acc = [torch.where(live, a + x[rows, t.clamp(min=0)], a)
               for a, x in zip(acc, terms)]
    return _finish(acc, n, reduction, (b, nq), f.dtype)


def parent_loop(op, q, s, f, idx, mask, radius, reduction):
    """The parent kernels' loop: slots t = 0 .. K-1, a slot adding its
    term where its mask is set and its row >= 0 (the staged s_idx[t] >= 0),
    counting it; f32, then avg, rounded once."""
    b, nq, k = idx.shape
    terms, valid = _slot_terms(op, q, s, f, idx, mask, radius)
    acc = [torch.zeros_like(x[:, 0]) for x in terms]
    for t in range(k):
        live = valid[:, t, None]
        acc = [torch.where(live, a + x[:, t], a) for a, x in zip(acc, terms)]
    return _finish(acc, valid.sum(1), reduction, (b, nq), f.dtype)


# ---- inputs -----------------------------------------------------------------

def _case(name, seed=7):
    """(q, s, idx, mask, radius) of a named case on 2 clouds: random slots
    (40% valid) with one all-masked query; "k64" at K = 64; "dup" with
    every query's first valid slots naming one support row; "neg" with
    every fifth slot naming row -1 (mask set: not a valid slot); Nq = 37
    (off the groups a block)."""
    rng = np.random.default_rng(seed)
    k = MAX_K if name == "k64" else 13
    nq, ns = 37, 50
    s = rng.uniform(-1, 1, (2, ns, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (2, nq, 3)).astype(np.float32)
    idx = rng.integers(0, ns, (2, nq, k)).astype(np.int32)
    mask = rng.random((2, nq, k)) < 0.4
    mask[0, 3] = False  # an all-masked query
    if name == "dup":
        idx[..., 1:4] = idx[..., :1]
        mask[:, 4:, :4] = True
    if name == "neg":
        idx[..., ::5] = -1
        mask[:, 4:, ::5] = True
    return (torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(idx),
            torch.from_numpy(mask), 1.5)


def _kernel_points(kpn):
    kp = agg.kernel_point_layout(kpn, "center" if kpn > 1 else "none")
    return torch.from_numpy(kp), (1.2 * agg._typical_spacing(kp)
                                  if kpn > 1 else 0.7)


def _features(seed, shape, dtype):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).to(dtype)


def _pgrid_tol(dtype):
    """``chip_smoke._pgrid_tol``: the same f32 terms summed in another
    order, rounded once; bf16 one ulp where the orders straddle a
    rounding boundary."""
    return (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
            else dict(rtol=8e-3, atol=1e-5))


def _sincos_tol(dtype, reduction):
    """``chip_smoke._pospool_fwd_tol(dtype, reduction, "sincos")``."""
    if dtype == torch.float32:
        return (dict(rtol=1e-5, atol=1e-6) if reduction == "avg"
                else dict(rtol=1e-5, atol=1e-5))
    return (dict(rtol=2e-2, atol=6e-2) if reduction == "sum"
            else dict(rtol=2e-2, atol=2e-2))


# ---- tests: compaction and layout --------------------------------------------

@pytest.mark.parametrize("lanes", [8, 16, 32])
@pytest.mark.parametrize("k", [1, 26, MAX_K])
def test_ballot_compaction_is_ascending_slot_order(lanes, k):
    rng = np.random.default_rng(k + lanes)
    idx = torch.from_numpy(rng.integers(-1, 9, (200, k)).astype(np.int32))
    mask = torch.from_numpy(rng.random((200, k)) < 0.5)
    mask[0] = False
    mask[1] = True
    order, n = ballot_order(idx, mask, lanes)
    valid = mask & (idx >= 0)
    assert torch.equal(n, valid.sum(1))
    for r in range(200):
        want = valid[r].nonzero().flatten()
        assert torch.equal(order[r, :len(want)], want)
        assert (order[r, len(want):] == -1).all()
    assert n[0] == 0


def test_layout_at_the_modelnet40_calls():
    """The choices at ModelNet40's bf16 step (32 clouds; C = 72 ... 1152,
    Kp = 15) on the H100's 132 SMs."""
    calls = [(5000, 72), (1250, 144), (312, 288), (78, 576), (19, 1152)]
    got = [(pgrid_layout(c, 15, 2, 32 * nq), sincos_layout(c, 32 * nq))
           for nq, c in calls]
    # K10f: 16-byte units of 8 channels, 2 kernel points at C = 72 and 4
    # (32 sums) from C = 144
    assert [(g["units"], g["sums"], g["lanes"], g["slices"])
            for g, _ in got] == [
        (72, 16, 16, 1), (72, 32, 16, 1), (144, 32, 32, 2),
        (288, 32, 32, 5), (576, 32, 32, 18)]
    # K5f: a pair a lane; 8 lanes at C = 72 keep 36 of 40 busy
    assert [(s["lanes"], s["slices"]) for _, s in got] == [
        (8, 1), (16, 1), (32, 2), (32, 5), (32, 18)]
    # where the queries alone leave SMs short of kFillThreads lanes, the
    # slices make up for most of them (whole passes a slice)
    for (nq, _), lays in zip(calls, got):
        for lay in lays:
            assert (32 * nq * lay["slices"] * lay["lanes"]
                    >= 0.7 * H100_SMS * FILL_THREADS or lay["per"] == 1)


@pytest.mark.parametrize("b,nq,c,kpn,elem", [
    (2, 37, 72, 15, 2),      # ModelNet40's stage 0 width, Nq off a block
    (2, 37, 72, 15, 4),      # f32: units of 4 channels x 4 kernel points
    (2, 5, 300, 15, 2),      # C off the 16-byte vector
    (2, 9, 13, 64, 4),       # Kp = 64, C off the vector
    (3, 11, 6, 1, 2),        # Kp = 1, one partial unit
    (32, 19, 1152, 15, 2)])  # stage 4: the passes split into slices
def test_pgrid_units_write_every_output_element_once(b, nq, c, kpn, elem):
    lay = pgrid_layout(c, kpn, elem, b * nq)
    lanes, slices, per = lay["lanes"], lay["slices"], lay["per"]
    kw, kpc, cvs = lay["kw"], lay["kpc"], lay["cvs"]
    span = kpn * c
    count = np.zeros(b * nq * span, np.int64)
    items = b * nq * slices
    blocks = -(-items // (GROUP_THREADS // lanes))
    got = [it for blk in range(blocks)
           for it in items_of_block(blk, lanes, items, slices) if it]
    assert len(got) == items
    rows = np.array(got)
    for sl in range(slices):
        # lane lg of pass e takes unit e * lanes + lg, as the kernel's loop
        # from slice * per * lanes + lg, step lanes, to u_end
        u_end = min(lay["units"], (sl + 1) * per * lanes)
        units = np.concatenate([np.arange(sl * per * lanes + lg, u_end, lanes)
                                for lg in range(lanes)])
        pc, ch0 = units // cvs, (units % cvs) * kw
        p = pc[:, None, None] * kpc + np.arange(kpc)[None, :, None]
        ch = ch0[:, None, None] + np.arange(kw)[None, None, :]
        keep = (p < kpn) & (ch < c)
        off = (p * c + ch)[keep]
        assert ((off >= 0) & (off < span)).all()  # the item's own query
        mine = rows[rows[:, 1] == sl, 0]
        np.add.at(count, (mine[:, None] * span + off[None, :]).ravel(), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("b,nq,c", [(2, 37, 72), (2, 37, 144), (3, 7, 6),
                                    (2, 5, 288), (32, 19, 1152)])
def test_sincos_pairs_write_every_output_channel_once(b, nq, c):
    lay = sincos_layout(c, b * nq)
    lanes, slices, per, pairs = (lay["lanes"], lay["slices"], lay["per"],
                                 lay["pairs"])
    nf = c // 6
    count = np.zeros((b * nq, c), np.int64)
    for row in range(b * nq):
        for sl in range(slices):
            p_end = min(pairs, (sl + 1) * per * lanes)
            for lg in range(lanes):
                for p in range(sl * per * lanes + lg, p_end, lanes):
                    d, j = divmod(p, nf)
                    count[row, d * 2 * nf + j] += 1
                    count[row, d * 2 * nf + nf + j] += 1
    assert (count == 1).all()


# ---- tests: each element's arithmetic ----------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["linear", "constant", "gaussian"])
@pytest.mark.parametrize("case,c,kpn", [("plain", 13, 15), ("k64", 8, 64),
                                        ("dup", 24, 1)])
def test_pgrid_emulation_matches_plain(case, c, kpn, mode, dtype):
    q, s, idx, mask, r = _case(case)
    kp, extent = _kernel_points(kpn)
    f = _features(11, (2, s.shape[1], c), dtype)
    lanes = pgrid_layout(c, kpn, f.element_size(), idx.shape[0] *
                         idx.shape[1])["lanes"]
    got = pgrid_emulated(q, s, f, idx, mask, kp, r, extent, mode, lanes)
    ref = pseudo_grid.pseudo_grid_plain(q, s, f, idx, mask, kp, r, extent,
                                        mode)
    assert got.dtype == dtype and got.shape == (2, 37, kpn * c)
    assert (got[0, 3] == 0).all()  # the all-masked query
    assert got.float().abs().max() > 0.1
    torch.testing.assert_close(got.float(), ref.float(), **_pgrid_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("case,c", [("plain", 12), ("k64", 6), ("dup", 30)])
def test_sincos_emulation_matches_plain(case, c, reduction, dtype):
    q, s, idx, mask, r = _case(case)
    f = _features(12, (2, s.shape[1], c), dtype)
    lanes = sincos_layout(c, idx.shape[0] * idx.shape[1])["lanes"]
    got = sincos_emulated(q, s, f, idx, mask, r, reduction, lanes)
    ref = aggregation.pospool_sincos_plain(q, s, f, idx, mask, r, reduction)
    assert got.dtype == dtype and got.shape == (2, 37, c)
    assert (got[0, 3] == 0).all()
    torch.testing.assert_close(got.float(), ref.float(),
                               **_sincos_tol(dtype, reduction))


@pytest.fixture(scope="module")
def cloud():
    """(q, s, idx, mask, radius): 24 queries into a 96-point support, one
    cloud padded, one query masked, neighbors out to |dp| ~ 1."""
    rng = np.random.default_rng(41)
    xyz = rng.uniform(-1, 1, size=(2, 96, 3)).astype(np.float32)
    m = np.ones((2, 96), bool)
    m[1, 70:] = False
    q, qm = xyz[:, :24].copy(), m[:, :24].copy()
    qm[0, 5] = False
    idx, nmask = ball_query(torch.from_numpy(q), torch.from_numpy(xyz), 0.45,
                            12, query_mask=torch.from_numpy(qm),
                            support_mask=torch.from_numpy(m))
    return (torch.from_numpy(q), torch.from_numpy(xyz), idx, nmask, 0.45)


def _j(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


@pytest.mark.parametrize("mode", ["linear", "constant", "gaussian"])
def test_pgrid_emulation_matches_the_pallas_kernel(cloud, mode):
    q, s, idx, mask, r = cloud
    kp, extent = _kernel_points(15)
    f = _features(13, (2, 96, 6), torch.float32)
    got = pgrid_emulated(q, s, f, idx, mask, kp, r, extent, mode, 8)
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp)
        ref = np.asarray(jpseudo_grid.pseudo_grid_fused(
            *_j(q, s, f, idx, mask, kp), r, extent, mode))
    assert np.abs(ref).max() > 1.0 and (ref[0, 5] == 0).all()
    # f32; the same influence arithmetic (exp may differ in its last
    # ulp), the slot sums associate differently
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduction", ["avg", "sum"])
def test_sincos_emulation_matches_the_pallas_kernel(cloud, reduction):
    q, s, idx, mask, r = cloud
    f = _features(14, (2, 96, 12), torch.float32)
    got = sincos_emulated(q, s, f, idx, mask, r, reduction, 8)
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp, ops_impl="jnp")
        ref = np.asarray(jpospool_fused(*_j(q, s, f, idx, mask), r,
                                        "sin_cos", reduction))
    assert (ref[0, 5] == 0).all()
    # the TPU kernel sums sin/cos of absolute angles and recombines them;
    # the JAX package's own tolerance for it (sum: up to 12 slots)
    atol = 2e-4 if reduction == "avg" else 1e-3
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=atol)


# ---- K1f and K9f: units of 16 or 8 bytes of channels ------------------------

def test_unit_layout_at_the_modelnet40_calls():
    """K1f's, K9f's and K6f's choices at ModelNet40's bf16 step (32
    clouds; C = 72 ... 1152) on the H100's 132 SMs: vector units at every
    width (C/3 = 24 * 2^i, a multiple of 8), group widths by the units a
    query has (K1f 16 or 32 lanes, K9f and K6f 8 to 32)."""
    calls = [(5000, 72), (1250, 144), (312, 288), (78, 576), (19, 1152)]
    want = {
        # K1f: 8 bf16 channels a unit; 32 lanes x 1 pass at C = 144
        "xyz": [(9, True, 16, 1, 1), (18, True, 32, 1, 1),
                (36, True, 16, 3, 1), (72, True, 16, 5, 1),
                (144, True, 32, 5, 1)],
        # K9f: 4 bf16 channels a unit; 8 lanes x 3 passes at C = 72
        "moments": [(18, True, 8, 1, 3), (36, True, 8, 2, 3),
                    (72, True, 16, 3, 2), (144, True, 32, 5, 1),
                    (288, True, 32, 9, 1)],
        # K6f: 4 channels a unit, in bf16 and f32 alike: K9f's layout
        "pwstats": [(18, True, 8, 1, 3), (36, True, 8, 2, 3),
                    (72, True, 16, 3, 2), (144, True, 32, 5, 1),
                    (288, True, 32, 9, 1)]}
    for op in ("xyz", "moments", "pwstats"):
        got = [unit_layout(op, c, 2, 32 * nq) for nq, c in calls]
        assert [(g["units"], g["vec"], g["lanes"], g["slices"], g["per"])
                for g in got] == want[op]
        for (nq, _), lay in zip(calls, got):
            assert (32 * nq * lay["slices"] * lay["lanes"]
                    >= 0.7 * H100_SMS * FILL_THREADS or lay["per"] == 1)
    # f32: 4 channels a K1f unit, 2 a K9f unit
    assert [unit_layout("xyz", c, 4, 32 * nq)["units"]
            for nq, c in calls] == [18, 36, 72, 144, 288]
    assert [unit_layout("moments", c, 4, 32 * nq)["units"]
            for nq, c in calls] == [36, 72, 144, 288, 576]
    assert [unit_layout("pwstats", c, 4, 32 * nq)["units"]
            for nq, c in calls] == [18, 36, 72, 144, 288]


@pytest.mark.parametrize("op,b,nq,c,elem,aligned", [
    ("xyz", 3, 7, 6, 2, True),        # C/3 = 2: one scalar unit
    ("xyz", 2, 37, 30, 4, True),      # C/3 = 10 off the vector: scalar
    ("xyz", 2, 37, 72, 2, True),      # stage 0's width, Nq off a block
    ("xyz", 2, 37, 72, 2, False),     # an unaligned view: scalar
    ("xyz", 32, 19, 1152, 2, True),   # stage 4: passes split into slices
    ("moments", 3, 7, 6, 2, True),    # C = 6 off the bf16 vector (4)
    ("moments", 2, 37, 30, 4, True),  # f32 vectors of 2 channels
    ("moments", 2, 37, 30, 4, False),  # an unaligned view: scalar
    ("moments", 2, 37, 72, 2, True),  # 8 lanes x 3 passes
    ("moments", 32, 19, 1152, 2, True),
    ("pwstats", 3, 7, 6, 2, True),    # C = 6 off the 4-channel unit
    ("pwstats", 2, 37, 13, 4, True),  # C = 13: a partial last unit
    ("pwstats", 2, 37, 72, 2, False),  # an unaligned view: scalar
    ("pwstats", 2, 37, 72, 2, True),  # 8 lanes x 3 passes
    ("pwstats", 2, 37, 300, 4, True),  # f32 16-byte units
    ("pwstats", 32, 19, 1152, 2, True)])
def test_units_write_every_output_element_once(op, b, nq, c, elem, aligned):
    lay = unit_layout(op, c, elem, b * nq, aligned)
    lanes, slices = lay["lanes"], lay["slices"]
    width = c * (1 if op == "xyz" else 4)
    count = np.zeros(b * nq * width, np.int64)
    items = b * nq * slices
    blocks = -(-items // (GROUP_THREADS // lanes))
    got = [it for blk in range(blocks)
           for it in items_of_block(blk, lanes, items, slices) if it]
    assert len(got) == items
    rows = np.array(got)
    for sl in range(slices):
        chans = [ch for lg in range(lanes)
                 for _, cs in unit_channels(lay, c, sl, lg) for ch in cs]
        # K9f writes each channel's four moments at m * C + ch, K6f its
        # four outputs (the m-th output as the span m * C ..)
        off = np.array([m * c + ch for ch in chans
                        for m in range(width // c)], np.int64)
        assert ((off >= 0) & (off < width)).all()  # the item's own query
        mine = rows[rows[:, 1] == sl, 0]
        np.add.at(count, (mine[:, None] * width + off[None, :]).ravel(), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("c", [6, 24, 30, 72, 78, 144, 1152])
def test_unit_coordinates(c, elem):
    """A K1f unit's channels read D of their own coordinate c / (C/3):
    vector units only where C/3 is a multiple of kW (then the unit's
    channels share one coordinate), scalar units element by element."""
    lay = unit_layout("xyz", c, elem, 100)
    kw, g = lay["kw"], c // 3
    assert lay["vec"] == (g % kw == 0)
    if c in (72, 144, 1152):  # the widths the models run
        assert lay["vec"]
    for ch0 in range(0, c, kw):
        got = unit_coordinates(lay, c, ch0)
        want = [ch // g for ch in range(ch0, min(ch0 + kw, c))]
        assert got[:len(want)] == want
        if lay["vec"]:
            assert len(set(got)) == 1


UNIT_CASES = [("plain", 12), ("k64", 6), ("dup", 30), ("neg", 24)]


@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,c", UNIT_CASES)
@pytest.mark.parametrize("op", ["xyz", "moments"])
def test_unit_emulation_equals_the_parent_loop(op, case, c, dtype,
                                               reduction):
    """Each element's sum over the compacted valid slots gives the bits of
    the parent's loop over all K slots."""
    q, s, idx, mask, r = _case(case)
    f = _features(15, (2, s.shape[1], c), dtype)
    lanes = unit_layout(op, c, f.element_size(), 74)["lanes"]
    got = unit_emulated(op, q, s, f, idx, mask, r, reduction, lanes)
    ref = parent_loop(op, q, s, f, idx, mask, r, reduction)
    assert got.dtype == dtype
    assert got.shape == (2, 37, c * (1 if op == "xyz" else 4))
    assert (got[0, 3] == 0).all()  # the all-masked query
    assert got.float().abs().max() > 0.1
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       ref.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32))


def _unit_tol(dtype, reduction):
    """As ``tests/test_torch_cuda.py`` holds the K1 and K9 forwards to
    their plain versions: f32 the same products summed in another order;
    bf16 the plain version rounds each product and the sum (of up to 64
    slots here, so a sum's rounding reaches further than an average's)."""
    if dtype == torch.float32:
        return (dict(rtol=1e-5, atol=1e-6) if reduction == "avg"
                else dict(rtol=1e-5, atol=1e-5))
    return dict(rtol=2e-2, atol=2e-2 if reduction == "avg" else 6e-2)


UNIT_PLAIN = {"xyz": aggregation.pospool_xyz_plain,
              "moments": moments.neighborhood_moments_plain}


@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,c", UNIT_CASES)
@pytest.mark.parametrize("op", ["xyz", "moments"])
def test_unit_emulation_matches_plain(op, case, c, dtype, reduction):
    """The plain versions take slots naming row -1 as valid (a gather
    wraps it): they are given the kernels' mask, set only where idx >= 0."""
    q, s, idx, mask, r = _case(case)
    f = _features(16, (2, s.shape[1], c), dtype)
    lanes = unit_layout(op, c, f.element_size(), 74)["lanes"]
    got = unit_emulated(op, q, s, f, idx, mask, r, reduction, lanes)
    valid = mask & (idx >= 0)
    ref = UNIT_PLAIN[op](q, s, f, idx.clamp(min=0), valid, r, reduction)
    assert got.shape == ref.shape and (got[0, 3] == 0).all()
    torch.testing.assert_close(got.float(), ref.float(),
                               **_unit_tol(dtype, reduction))


@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("op", ["xyz", "moments"])
def test_unit_emulation_matches_the_pallas_kernel(cloud, op, reduction):
    q, s, idx, mask, r = cloud
    c = 12
    f = _features(17, (2, 96, c), torch.float32)
    lanes = unit_layout(op, c, 4, 48)["lanes"]
    got = unit_emulated(op, q, s, f, idx, mask, r, reduction, lanes)
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp)
        args = _j(q, s, f, idx, mask)
        ref = np.asarray(jpospool_fused(*args, r, "xyz", reduction)
                         if op == "xyz" else jmoments(*args, r, reduction))
    assert ref.shape == got.shape and (ref[0, 5] == 0).all()
    assert np.abs(ref).max() > 0.1
    # the TPU kernels multiply by 1/r and sum through MXU matmuls; the
    # JAX package's own tolerance (tests/test_pallas_moments.py)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


# ---- K6f: units of 4 channels of g and gsq, f64 slot sums -------------------

def _minmax_add(hi, lo, x):
    """The update of running extrema by x after the first value
    (``group_extrema`` in gather_reduce.cu): a NaN wins and stays."""
    up = (hi == hi) & ((x != x) | (x > hi))
    dn = (lo == lo) & ((x != x) | (x < lo))
    return torch.where(up, x, hi), torch.where(dn, x, lo)


def pwstats_emulated(g, gsq, idx, mask, lanes):
    """K6f, element by element: over the compacted valid slots in the
    group's ballot order, the first sets hi and lo, the others update them
    (``_minmax_add``); s1 and s2 add g and gsq in f64 from +0 and round
    once to f32; 0 where no slot is valid. (gmax, gmin, s1, s2) f32."""
    b, nq, k = idx.shape
    c = g.shape[-1]
    order, n, flat = _compacted(idx, mask, lanes)
    rows = torch.arange(b * nq)
    cloud = rows // nq
    hi = torch.zeros((b * nq, c))
    lo = torch.zeros((b * nq, c))
    a1 = torch.zeros((b * nq, c), dtype=torch.float64)
    a2 = torch.zeros((b * nq, c), dtype=torch.float64)
    for i in range(int(n.max())):
        t = order[:, i]
        live = (t >= 0)[:, None]
        j = flat[rows, t.clamp(min=0)].clamp(min=0)  # past n: unused
        x, xq = g.float()[cloud, j], gsq.float()[cloud, j]
        nhi, nlo = (x, x) if i == 0 else _minmax_add(hi, lo, x)
        hi, lo = torch.where(live, nhi, hi), torch.where(live, nlo, lo)
        a1 = torch.where(live, a1 + x.double(), a1)
        a2 = torch.where(live, a2 + xq.double(), a2)
    return tuple(o.float().reshape(b, nq, c) for o in (hi, lo, a1, a2))


def pwstats_parent_loop(g, gsq, idx, mask):
    """The parent kernel's loop: slots t = 0 .. K-1, a slot counting where
    its mask is set and its row >= 0 (the staged s_idx[t] >= 0); the
    first such value sets the extrema, the others update them
    (``_minmax_add``); the sums add in f64 from +0
    and round once; ``any ? hi : 0``."""
    b, nq, k = idx.shape
    c = g.shape[-1]
    valid = (mask & (idx >= 0)).reshape(-1, k)
    safe = torch.where(mask & (idx >= 0), idx, torch.zeros_like(idx))
    safe = safe.reshape(-1, k).long()
    cloud = torch.arange(b * nq)[:, None] // nq
    v, vq = g.float()[cloud, safe], gsq.float()[cloud, safe]  # [Q, K, C]
    hi = torch.zeros((b * nq, c))
    lo = torch.zeros((b * nq, c))
    a1 = torch.zeros((b * nq, c), dtype=torch.float64)
    a2 = torch.zeros((b * nq, c), dtype=torch.float64)
    seen = torch.zeros((b * nq, 1), dtype=torch.bool)
    for t in range(k):
        live = valid[:, t, None]
        x = v[:, t]
        nhi, nlo = _minmax_add(hi, lo, x)
        hi = torch.where(live & ~seen, x, torch.where(live, nhi, hi))
        lo = torch.where(live & ~seen, x, torch.where(live, nlo, lo))
        seen = seen | live
        a1 = torch.where(live, a1 + x.double(), a1)
        a2 = torch.where(live, a2 + vq[:, t].double(), a2)
    hi, lo = torch.where(seen, hi, 0.0), torch.where(seen, lo, 0.0)
    return tuple(o.float().reshape(b, nq, c) for o in (hi, lo, a1, a2))


def _stats_inputs(case, c, dtype, seed=18):
    """(g, gsq, idx, mask) of a named ``_case``; "nan" (the plain slots)
    puts NaNs in g at a few support rows that queries name."""
    _, s, idx, mask, _ = _case("plain" if case == "nan" else case)
    g32 = _features(seed, (2, s.shape[1], c), torch.float32)
    if case == "nan":
        g32[0, idx[0, 5:9, 0].long(), ::3] = float("nan")
    return g32.to(dtype), (g32 * g32).to(dtype), idx, mask


STATS_CASES = UNIT_CASES + [("nan", 12), ("plain", 13)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,c", STATS_CASES)
def test_pwstats_emulation_equals_the_parent_loop(case, c, dtype):
    """K6f's four outputs over the compacted valid slots give the bits of
    the parent's loop over all K slots (NaNs included)."""
    g, gsq, idx, mask = _stats_inputs(case, c, dtype)
    lanes = unit_layout("pwstats", c, g.element_size(), 74)["lanes"]
    got = pwstats_emulated(g, gsq, idx, mask, lanes)
    ref = pwstats_parent_loop(g, gsq, idx, mask)
    for o, r in zip(got, ref):
        assert o.dtype == torch.float32 and o.shape == (2, 37, c)
        assert (o[0, 3] == 0).all()  # the all-masked query
        assert torch.equal(o.view(torch.int32), r.view(torch.int32))
    assert got[2].abs().nan_to_num().max() > 0.1
    assert got[0].isnan().any() == (case == "nan")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,c", UNIT_CASES + [("plain", 13)])
def test_pwstats_emulation_matches_plain(case, c, dtype):
    """Against ``pwmlp_minmax_stats_plain`` (given the kernel's mask, set
    only where idx >= 0): the extrema equal in value, the sums within one
    f32 rounding (both f64, rounded once; ATen sums in its own order).
    Not on NaNs: the plain sums multiply masked slots by 0, which keeps a
    masked slot's NaN."""
    g, gsq, idx, mask = _stats_inputs(case, c, dtype)
    lanes = unit_layout("pwstats", c, g.element_size(), 74)["lanes"]
    got = pwstats_emulated(g, gsq, idx, mask, lanes)
    valid = mask & (idx >= 0)
    ref = gather_reduce.pwmlp_minmax_stats_plain(g, gsq, idx.clamp(min=0),
                                                 valid)
    for o, r in zip(got[:2], ref[:2]):
        assert torch.equal(o, r)
    for o, r in zip(got[2:], ref[2:]):
        torch.testing.assert_close(o, r, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def pw_cloud():
    """(idx, mask) of 2 clouds x 64 points (one padded from point 50 on):
    B·Nq = 128, so that JAX's ``pwmlp_minmax_stats`` runs its Pallas K6
    kernel, not the K13 + K7 route (``tests/test_torch_pwmlp.py``)."""
    rng = np.random.default_rng(19)
    xyz = rng.uniform(-1, 1, size=(2, 64, 3)).astype(np.float32)
    m = np.ones((2, 64), bool)
    m[0, 50:] = False
    pm = torch.from_numpy(m)
    idx, nmask = ball_query(torch.from_numpy(xyz), torch.from_numpy(xyz),
                            0.5, 12, query_mask=pm, support_mask=pm)
    assert (~nmask.any(-1)).any() and (nmask.sum(-1) > 1).any()
    return idx, nmask


def test_pwstats_emulation_matches_the_pallas_kernel(pw_cloud):
    idx, mask = pw_cloud
    g = _features(20, (2, 64, 8), torch.float32)
    gsq = g * g
    lanes = unit_layout("pwstats", 8, 4, 128)["lanes"]
    got = pwstats_emulated(g, gsq, idx, mask, lanes)
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp)
        ref = jgather_reduce.pwmlp_minmax_stats(*_j(g, gsq, idx, mask))
    empty = ~mask.any(-1)
    for i, (o, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert r.shape == o.shape and (r[empty.numpy()] == 0).all()
        # the JAX package's own tolerances (tests/test_pallas_pwmlp.py):
        # extrema, then sums
        tol = dict(rtol=1e-5) if i < 2 else dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(o.numpy(), r, **tol)
    assert np.abs(np.asarray(ref[2])).max() > 0.1
