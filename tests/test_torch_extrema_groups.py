"""The query-group layout of the extrema forwards K8f (the neighborhood
max, ``csrc/neighborhood_max.cu``) and K7f (the point-wise MLP's
gather-subtract min/max, ``csrc/gather_reduce.cu``), emulated in PyTorch
on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them to their plain versions there). Here the
layout and each output element's order of operations are mirrored, as
``tests/test_torch_query_groups.py`` mirrors the other forwards (whose
helpers this file shares):

* the host's choices (``group_lanes_for`` from 8 lanes, ``split_passes``,
  ``ChannelUnit``'s units: K8f 16 bytes of channels, K7f 4 channels of g
  and of each f32 output) and the item and unit mapping: every output
  element written exactly once, by the item of its own query, at the
  ModelNet40 calls (K8f's strided calls at C = 144 ... 1152, K7f's calls
  at C = 72 ... 1152 and the K13 route's), with C off the vector and Nq
  off the groups a block;
* each element's extrema over the valid slots compacted in ballot order
  (``stage_valid_rows``): the first sets the extremum, each later one
  replaces it where hi == hi and (v != v or v > hi) (lo alike), so a NaN
  wins and stays and of -0 and +0 the first slot's stays; K7f over v =
  f32(g) - f32(d) in f32; 0 where no slot is valid. Equal to the bit to
  the parents' loops over all K slots, to the plain versions
  (``neighborhood_max_plain``, ``gather_sub_minmax_plain``) in value,
  and to the JAX package's ``neighborhood_max`` and ``gather_sub_minmax``
  run interpreted.

Edge cases: NaNs, -0 beside +0, all-masked queries, K = 64, duplicated
rows, slots naming row -1 under a set mask and under a clear one.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.ops.pallas import gather_reduce as jgather_reduce
from closerlook3d_tpu_torch.ops import gather_reduce, grouping
from closerlook3d_tpu_torch.ops.neighbors import ball_query
from test_torch_query_groups import (
    FILL_THREADS, GROUP_THREADS, H100_SMS, _case, _compacted, _j,
    _minmax_add, group_lanes_for, items_of_block, split_passes,
    unit_channels)

MAX_BYTES = 16      # kMaxBytes: K8f's unit, in bytes of channels
STATS_CHANNELS = 4  # kStatsChannels: K7f's unit, in channels
NARROWEST = 8       # kMaxLanes, kStatsLanes


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def extrema_layout(op: str, c: int, elem_bytes: int, queries: int,
                   aligned: bool = True) -> dict:
    """K8f's (op "max") or K7f's ("minmax") launch: units of kW channels
    (16 bytes for K8f, 4 channels for K7f), vectors where C is a multiple
    of kW and the pointers allow them (``runs_ok``), else scalar units of
    the same channels; lanes and slices as the host picks them."""
    kw = MAX_BYTES // elem_bytes if op == "max" else STATS_CHANNELS
    units = -(-c // kw)
    lanes = group_lanes_for(units, NARROWEST)
    slices, per = split_passes(queries, -(-units // lanes), lanes)
    return dict(kw=kw, vec=aligned and c % kw == 0, units=units, lanes=lanes,
                slices=slices, per=per)


# ---- emulations -------------------------------------------------------------

def extrema_emulated(f, idx, mask, lanes, d=None):
    """K8f (d None) or K7f, element by element, over the compacted valid
    slots in the group's ballot order: v = f32(f) (K8f) or f32(g) -
    f32(d) (K7f); the first valid slot sets hi and lo, the others update
    them (``_minmax_add``); 0 where no slot is valid. (hi, lo) f32,
    [B, Nq, C]."""
    b, nq, k = idx.shape
    c = f.shape[-1]
    order, n, flat = _compacted(idx, mask, lanes)
    rows = torch.arange(b * nq)
    cloud = rows // nq
    hi = torch.zeros((b * nq, c))
    lo = torch.zeros((b * nq, c))
    for i in range(int(n.max())):
        t = order[:, i]
        live = (t >= 0)[:, None]
        j = flat[rows, t.clamp(min=0)].clamp(min=0)  # past n: unused
        x = f.float()[cloud, j]
        if d is not None:
            x = x - d.float().reshape(b * nq, c)
        nhi, nlo = (x, x) if i == 0 else _minmax_add(hi, lo, x)
        hi, lo = torch.where(live, nhi, hi), torch.where(live, nlo, lo)
    return hi.reshape(b, nq, c), lo.reshape(b, nq, c)


def extrema_parent_loop(f, idx, mask, d=None):
    """The loops of the kernels these layouts replaced (a block per 4
    queries, a thread a channel): slots t = 0 .. K-1, a slot counting where
    its mask is set and its row >= 0 (the staged s_idx[t] >= 0); the first
    such value sets the extrema, the others update them; ``any ? hi :
    0``."""
    b, nq, k = idx.shape
    c = f.shape[-1]
    valid = (mask & (idx >= 0)).reshape(-1, k)
    safe = torch.where(mask & (idx >= 0), idx, torch.zeros_like(idx))
    cloud = torch.arange(b * nq)[:, None] // nq
    v = f.float()[cloud, safe.reshape(-1, k).long()]  # [Q, K, C]
    if d is not None:
        v = v - d.float().reshape(b * nq, 1, c)
    hi = torch.zeros((b * nq, c))
    lo = torch.zeros((b * nq, c))
    seen = torch.zeros((b * nq, 1), dtype=torch.bool)
    for t in range(k):
        live = valid[:, t, None]
        x = v[:, t]
        nhi, nlo = _minmax_add(hi, lo, x)
        hi = torch.where(live & ~seen, x, torch.where(live, nhi, hi))
        lo = torch.where(live & ~seen, x, torch.where(live, nlo, lo))
        seen = seen | live
    hi, lo = torch.where(seen, hi, 0.0), torch.where(seen, lo, 0.0)
    return hi.reshape(b, nq, c), lo.reshape(b, nq, c)


def k8f(f, idx, mask, emulate=True):
    """K8f's output in f's dtype, emulated or by the parent's loop."""
    lanes = extrema_layout("max", f.shape[-1], f.element_size(),
                           idx.shape[0] * idx.shape[1])["lanes"]
    hi = (extrema_emulated(f, idx, mask, lanes) if emulate
          else extrema_parent_loop(f, idx, mask))[0]
    return hi.to(f.dtype)


def k7f(g, d, idx, mask, emulate=True):
    """K7f's (hmax, hmin), emulated or by the parent's loop."""
    lanes = extrema_layout("minmax", g.shape[-1], g.element_size(),
                           idx.shape[0] * idx.shape[1])["lanes"]
    return (extrema_emulated(g, idx, mask, lanes, d) if emulate
            else extrema_parent_loop(g, idx, mask, d))


def _values(case, c, dtype, nan, seed=30):
    """(f, d, idx, mask) of a named ``_case`` (2 clouds of 37 queries into
    50 points; query 3 all masked): f and d on a 0.5 grid (ties; a
    rounding from below gives -0), channel 0 of f -0 at even rows and +0
    at odd ones and channel 0 of d +0, so that the first valid slot's zero
    must win; with ``nan`` f NaN at every third channel from channel 1 (0
    where C = 1) of the rows of cloud 0's first valid slots."""
    _, s, idx, mask, _ = _case(case)
    rng = np.random.default_rng(seed)
    ns, nq = s.shape[1], idx.shape[1]
    f = torch.from_numpy(np.round(2 * rng.normal(size=(2, ns, c))) / 2)
    d = torch.from_numpy(np.round(2 * rng.normal(size=(2, nq, c))) / 2)
    f, d = f.float(), d.float()
    f[..., 0] = torch.where(torch.arange(ns) % 2 == 0, -0.0, 0.0)
    d[..., 0] = 0.0
    if nan:
        valid = mask[0] & (idx[0] >= 0)
        f[0, idx[0][valid][:4].long(), min(1, c - 1)::3] = float("nan")
    return f.to(dtype), d.to(dtype), idx, mask


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _nan_equal(got, ref):
    """NaNs at the same places; elsewhere the same values (-0 == +0)."""
    nan = got.isnan()
    assert torch.equal(nan, ref.isnan())
    assert torch.equal(got.masked_fill(nan, 0), ref.masked_fill(nan, 0))


# ---- tests: layout ------------------------------------------------------------

def test_extrema_layout_at_the_modelnet40_calls():
    """The choices at ModelNet40's bf16 calls (32 clouds) on the H100's 132
    SMs: K8f at the strided calls (Nq, C), 8 bf16 channels a unit; K7f at
    the point-wise MLP's widths, 4 channels a unit (K6f's layout), and at
    the K13 route's call (8 clouds x 8 queries, C = 1152)."""
    def layout(op, calls, elem):
        return [tuple(extrema_layout(op, c, elem, q)[key]
                      for key in ("units", "vec", "lanes", "slices", "per"))
                for q, c in calls]

    strided = [(32 * 1250, 144), (32 * 312, 288), (32 * 78, 576),
               (32 * 19, 1152)]
    assert layout("max", strided, 2) == [
        (18, True, 8, 2, 2), (36, True, 8, 5, 1), (72, True, 16, 5, 1),
        (144, True, 32, 5, 1)]
    assert [u for u, *_ in layout("max", strided, 4)] == [36, 72, 144, 288]
    pwmlp = [(32 * 5000, 72), (32 * 1250, 144), (32 * 312, 288),
             (32 * 78, 576), (32 * 19, 1152), (64, 1152)]
    assert layout("minmax", pwmlp, 2) == layout("minmax", pwmlp, 4) == [
        (18, True, 8, 1, 3), (36, True, 8, 2, 3), (72, True, 16, 3, 2),
        (144, True, 32, 5, 1), (288, True, 32, 9, 1), (288, True, 32, 9, 1)]
    for op, calls in (("max", strided), ("minmax", pwmlp)):
        for (q, c), (_, _, lanes, slices, per) in zip(calls,
                                                     layout(op, calls, 2)):
            assert (q * slices * lanes >= 0.7 * H100_SMS * FILL_THREADS
                    or per == 1)


@pytest.mark.parametrize("op,b,nq,c,elem,aligned", [
    ("max", 32, 1250, 144, 2, True),   # ModelNet40's strided calls
    ("max", 32, 312, 288, 2, True),
    ("max", 32, 78, 576, 2, True),
    ("max", 32, 19, 1152, 2, True),
    ("max", 2, 37, 13, 2, True),       # C off the vector: scalar units
    ("max", 2, 37, 13, 4, True),
    ("max", 2, 37, 144, 2, False),     # an unaligned view: scalar units
    ("max", 1, 3, 1152, 4, True),      # 1-4 queries at C = 1152
    ("minmax", 32, 5000, 72, 2, True),  # the point-wise MLP's calls
    ("minmax", 32, 1250, 144, 2, True),
    ("minmax", 32, 312, 288, 4, True),
    ("minmax", 32, 19, 1152, 2, True),
    ("minmax", 8, 8, 1152, 2, True),   # the K13 route's call
    ("minmax", 2, 37, 13, 2, True),    # a partial last unit
    ("minmax", 3, 7, 6, 4, False)])
def test_extrema_units_write_every_output_element_once(op, b, nq, c, elem,
                                                       aligned):
    """Each item (query, slice) comes from exactly one group of one block,
    and a query's slices cover its channels of every output (K7f's hmax
    at ch, hmin at C + ch) exactly once between them: so every output
    element is written exactly once, by the item of its own query."""
    lay = extrema_layout(op, c, elem, b * nq, aligned)
    lanes, slices = lay["lanes"], lay["slices"]
    items = b * nq * slices
    blocks = -(-items // (GROUP_THREADS // lanes))
    seen = np.zeros((b * nq, slices), np.int64)
    for blk in range(blocks):
        for it in items_of_block(blk, lanes, items, slices):
            if it:
                seen[it] += 1
    assert (seen == 1).all()
    outputs = 1 if op == "max" else 2
    count = np.zeros(outputs * c, np.int64)
    for sl in range(slices):
        for lg in range(lanes):
            for _, chans in unit_channels(lay, c, sl, lg):
                for m in range(outputs):
                    np.add.at(count, [m * c + ch for ch in chans], 1)
    assert (count == 1).all()


# ---- tests: arithmetic ----------------------------------------------------------

EXTREMA_CASES = [("plain", 12), ("k64", 6), ("dup", 30), ("neg", 24),
                 ("plain", 13), ("neg", 1)]


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,c", EXTREMA_CASES)
@pytest.mark.parametrize("op", ["max", "minmax"])
def test_extrema_emulation_equals_the_parent_loop(op, case, c, dtype, nan):
    """The extrema over the compacted valid slots give the bits of the
    parent's loop over all K slots: NaNs, -0 and +0, empty queries."""
    f, d, idx, mask = _values(case, c, dtype, nan)
    if op == "max":
        got, ref = (k8f(f, idx, mask),), (k8f(f, idx, mask, emulate=False),)
    else:
        got, ref = k7f(f, d, idx, mask), k7f(f, d, idx, mask, emulate=False)
    for o, r in zip(got, ref):
        assert o.dtype == (dtype if op == "max" else torch.float32)
        assert o.shape == (2, 37, c)
        assert (o[0, 3] == 0).all()  # the all-masked query
        assert torch.equal(_bits(o), _bits(r))
    assert got[0].isnan().any() == nan
    # channel 0 is +-0 at every valid slot: the first valid slot's sign
    first = mask & (idx >= 0)
    has = first.any(-1)
    rows = torch.gather(idx, 2, first.long().argmax(-1, keepdim=True))[..., 0]
    z = got[0][..., 0].float()
    num = has & ~z.isnan()
    assert torch.equal(torch.signbit(z) & num, num & (rows % 2 == 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,c", EXTREMA_CASES)
@pytest.mark.parametrize("op", ["max", "minmax"])
def test_extrema_emulation_matches_plain(op, case, c, dtype):
    """Against ``neighborhood_max_plain`` and ``gather_sub_minmax_plain``
    (given the kernels' mask, set only where idx >= 0): equal in value, NaNs
    at the same places (amax may pick either zero)."""
    f, d, idx, mask = _values(case, c, dtype, nan=True)
    valid = mask & (idx >= 0)
    safe = idx.clamp(min=0)
    if op == "max":
        got = (k8f(f, idx, mask),)
        ref = (grouping.neighborhood_max_plain(f, safe, valid),)
    else:
        got = k7f(f, d, idx, mask)
        ref = gather_reduce.gather_sub_minmax_plain(f, d, safe, valid)
    for o, r in zip(got, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        _nan_equal(o, r)
        assert o.float().nan_to_num().abs().max() > (0.4 if c > 1 else -1)


@pytest.fixture(scope="module")
def jax_extrema():
    """JAX's ``neighborhood_max`` and ``gather_sub_minmax``, Pallas
    kernels interpreted, on 2 clouds x 64 points (one padded from point
    50 on; B·Nq = 128, so that neither folds its batch), f32, one compile
    each: (inputs, K8f's out, K7f's (hmax, hmin))."""
    rng = np.random.default_rng(31)
    xyz = rng.uniform(-1, 1, size=(2, 64, 3)).astype(np.float32)
    m = np.ones((2, 64), bool)
    m[0, 50:] = False
    pm = torch.from_numpy(m)
    idx, mask = ball_query(torch.from_numpy(xyz), torch.from_numpy(xyz),
                           0.5, 12, query_mask=pm, support_mask=pm)
    assert (~mask.any(-1)).any() and (mask.sum(-1) > 1).any()
    f = torch.from_numpy(rng.normal(size=(2, 64, 8)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(2, 64, 8)).astype(np.float32))
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp)
        out = np.asarray(jgather_reduce.neighborhood_max(*_j(f, idx, mask)))
        mm = [np.asarray(o) for o in jgather_reduce.gather_sub_minmax(
            *_j(f, d, idx, mask))]
    return (f, d, idx, mask), out, mm


def test_extrema_emulation_matches_the_pallas_kernels(jax_extrema):
    (f, d, idx, mask), out, mm = jax_extrema
    empty = (~mask.any(-1)).numpy()
    # the one-hot gathers at HIGHEST precision are exact: the max equal
    got = k8f(f, idx, mask).numpy()
    assert out.shape == got.shape and (out[empty] == 0).all()
    np.testing.assert_array_equal(got, out)
    # the JAX package's own tolerance for K7's extrema
    # (tests/test_pallas_pwmlp.py)
    for o, r in zip(k7f(f, d, idx, mask), mm):
        assert r.shape == o.shape and (r[empty] == 0).all()
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5)
    assert np.abs(mm[1]).max() > 0.5 and math.isfinite(float(out.max()))
