"""The point-wise MLP's gather-subtract min/max backward (K7b) as the CUDA
kernel computes it (``csrc/gather_reduce.cu``: two launches over a
reverse neighbor index), emulated in PyTorch on the CPU.

Launch 1 builds the reverse index in query tiles and, beside it, writes
per query and channel, with h = g[idx] - d in f32 over the query's valid
slots (mask set, index >= 0), the counts n_hi and n_lo of the slots whose
h equals hmax and hmin, the shares dmax / max(n_hi, 1) and dmin /
max(n_lo, 1) in f32, and dd = -(dmax + dmin) in d's dtype (0 where the
query has no valid slot); launch 2 adds, for each support row and
channel, over the row's entries (q, t) tile after tile and in each tile
in the index's order, the term sh_hi * [h == hmax] + sh_lo * [h == hmin]
where h ties either, in f32 from +0, and rounds once. ``mm_bwd_gather``
does the same with the plain reverse index (``reverse_index_plain``) and
is held to

* ``gather_sub_minmax_bwd_plain`` to the bit (bit patterns, zero signs
  included), f32 and bf16, 1 to 3 tiles, C = 6, 13 (off the 4-channel
  unit) and 72, on ties (duplicated points and values on a grid, so that
  one slot can tie both the max and the min), all-masked queries, support
  rows no query reaches, one row named by every slot and strided shapes;
* the VJP of the JAX package's ``gather_sub_minmax`` (its Pallas kernels
  run interpreted, on distinct values, where its every-tying-slot rule
  equals the even split) and of the jnp composition the JAX models' gather
  path uses (max and min of g[idx] - d under the mask), f32, at the
  tolerance of ``tests/test_torch_pwmlp.py``.

The kernel is held to the twin on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.ops.pallas import gather_reduce as jgather_reduce
from closerlook3d_tpu_torch.ops import gather_reduce
from closerlook3d_tpu_torch.ops.grouping import group_features
from closerlook3d_tpu_torch.ops.neighbors import ball_query
from closerlook3d_tpu_torch.ops.reverse_index import reverse_index_plain

CASES = ("ties", "masked_queries", "unreached", "one_row", "strided")


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    """The port's CPU math on one ATen thread, as the other port tests
    run it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(name: str):
    """(support xyz, query xyz, idx, mask) of a named case, two clouds
    (the second padded to 70%): "ties" (points on a 0.25 grid, the first
    eighth duplicated), "masked_queries" (every third query of cloud 0
    masked), "unreached" (12 queries over 160 supports), "one_row" (every
    slot names row 3) and "strided" (24 queries over 96 supports)."""
    nq, ns, k, r = {"ties": (48, 48, 16, 0.45),
                    "masked_queries": (48, 48, 12, 0.4),
                    "unreached": (12, 160, 12, 0.3),
                    "one_row": (20, 40, 10, 0.5),
                    "strided": (24, 96, 12, 0.45)}[name]
    rng = np.random.default_rng(CASES.index(name) + 370)
    s = rng.uniform(-1, 1, size=(2, ns, 3)).astype(np.float32)
    if name == "ties":
        s = np.round(s * 4) / 4
        s[:, ns // 8:ns // 4] = s[:, :ns // 4 - ns // 8]
    smask = np.ones((2, ns), bool)
    smask[1, ns * 7 // 10:] = False
    q, qmask = ((s, smask) if nq == ns
                else (s[:, ::ns // nq][:, :nq].copy(),
                      smask[:, ::ns // nq][:, :nq].copy()))
    st, qt = torch.from_numpy(s), torch.from_numpy(np.ascontiguousarray(q))
    idx, mask = ball_query(qt, st, r, k, query_mask=torch.from_numpy(qmask),
                           support_mask=torch.from_numpy(smask))
    if name == "masked_queries":
        mask[0, ::3] = False
    if name == "one_row":
        idx = torch.full_like(idx, 3)
    assert mask.any() and (~mask.any(-1)).any()
    return st, qt, idx, mask


def _values(x, c, seed, ties=True):
    """Per-point rows: values on a 0.5 grid that are a function of the
    point's position (duplicated points carry equal rows, and a
    neighborhood's h often ties), or distinct normal values."""
    rng = np.random.default_rng(seed)
    if ties:
        w = torch.from_numpy(rng.normal(size=(3, c)).astype(np.float32))
        return torch.round(2 * (x @ w)) / 2
    return torch.from_numpy(rng.normal(size=(*x.shape[:2], c))
                            .astype(np.float32))


def _inputs(name, c, dtype, ties=True, seed=400):
    """(g, d, idx, mask, hmax, hmin, dmax, dmin) of a case: g on the
    supports and d on the queries in ``dtype``, the forward's extrema
    (``gather_sub_minmax_plain``) and f32 normal cotangents."""
    s, q, idx, mask = _case(name)
    g = _values(s, c, seed + c, ties).to(dtype)
    d = _values(q, c, seed + 1 + c, ties).to(dtype)
    hmax, hmin = gather_reduce.gather_sub_minmax_plain(g, d, idx, mask)
    rng = np.random.default_rng(seed + 2 + c)
    cot = [torch.from_numpy(rng.normal(size=hmax.shape).astype(np.float32))
           for _ in range(2)]
    return g, d, idx, mask, hmax, hmin, *cot


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def shares(g, d, idx, mask, hmax, hmin, dmax, dmin):
    """Launch 1's query groups: (sh_hi, sh_lo) [B, Nq, C] f32 and dd in
    d's dtype, as the module says."""
    valid = mask & (idx >= 0)
    h = group_features(g.float(), idx.clamp(min=0)) - d.float()[:, :, None]
    v = valid[..., None]
    n_hi = ((h == hmax[:, :, None]) & v).sum(dim=2)
    n_lo = ((h == hmin[:, :, None]) & v).sum(dim=2)
    sh_hi = dmax / n_hi.clamp(min=1)
    sh_lo = dmin / n_lo.clamp(min=1)
    dd = torch.where(valid.any(-1, keepdim=True), -(dmax + dmin),
                     torch.zeros(())).to(d.dtype)
    return sh_hi, sh_lo, dd


def mm_bwd_gather(g, d, idx, mask, hmax, hmin, dmax, dmin, tiles=1):
    """The two launches: the index in ``tiles`` tiles of consecutive
    queries, each entry holding its query, read tile after tile; per
    support row the f32 sum from +0 of each tying entry's term, one add a
    step; rounded to g's dtype. Returns (dg, dd)."""
    b, nq, k = idx.shape
    ns, c = g.shape[1], g.shape[2]
    sh_hi, sh_lo, dd = shares(g, d, idx, mask, hmax, hmin, dmax, dmin)
    per = -(-nq // tiles)
    cloud = torch.arange(b)[:, None]
    gf = g.float()
    acc = torch.zeros((b, ns, c))
    for q0 in range(0, nq, per):
        offsets, slots = reverse_index_plain(idx[:, q0:q0 + per],
                                             mask[:, q0:q0 + per], ns)
        counts = offsets[:, 1:] - offsets[:, :-1]
        for pos in range(int(counts.max())):
            has = counts > pos
            at = torch.where(has, offsets[:, :-1] + pos, 0).long()
            qi = q0 + torch.where(has, torch.gather(slots, 1, at),
                                  0).long() // k
            h = gf - d.float()[cloud, qi]
            th = h == hmax[cloud, qi]
            tl = h == hmin[cloud, qi]
            term = sh_hi[cloud, qi] * th + sh_lo[cloud, qi] * tl
            acc = torch.where(has[..., None] & (th | tl), acc + term, acc)
    return acc.to(g.dtype), dd


@pytest.mark.parametrize("tiles", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [6, 13, 72])
@pytest.mark.parametrize("name", CASES)
def test_gather_equals_twin_to_the_bit(name, c, dtype, tiles):
    args = _inputs(name, c, dtype)
    got = mm_bwd_gather(*args, tiles=tiles)
    ref = gather_reduce.gather_sub_minmax_bwd_plain(*args)
    for o, r in zip(got, ref):
        assert o.dtype == r.dtype == dtype and o.shape == r.shape
        assert torch.equal(_bits(o), _bits(r))
    assert got[0].float().abs().max() > 0.1


def test_ties_of_both_extrema_add_the_grouped_shares():
    """A slot that ties the max and the min (one valid slot, or equal h)
    takes sh_hi + sh_lo, rounded once; a query with no valid slot sends
    nothing and gets dd = 0."""
    g = torch.tensor([[[1.0], [1.0], [0.5], [3.0]]])
    d = torch.tensor([[[0.0], [0.5], [1.0]]])
    idx = torch.tensor([[[0, 1, 2], [3, 3, 0], [3, 1, 0]]], dtype=torch.int32)
    mask = torch.tensor([[[True, True, False], [False, False, False],
                          [True, False, False]]])
    hmax, hmin = gather_reduce.gather_sub_minmax_plain(g, d, idx, mask)
    dmax = torch.tensor([[[6.0], [5.0], [0.1]]])
    dmin = torch.tensor([[[2.0], [7.0], [0.2]]])
    dg, dd = mm_bwd_gather(g, d, idx, mask, hmax, hmin, dmax, dmin)
    want = torch.tensor(0.1, dtype=torch.float32) + torch.tensor(0.2)
    assert dg.flatten().tolist() == [4.0, 4.0, 0.0, float(want)]
    assert dd.flatten().tolist() == [-8.0, 0.0, -float(want)]
    for o, r in zip((dg, dd), gather_reduce.gather_sub_minmax_bwd_plain(
            g, d, idx, mask, hmax, hmin, dmax, dmin)):
        assert torch.equal(_bits(o), _bits(r))


def _jnp_minmax(g, d, idx, mask):
    """The jnp composition of the JAX models' gather path: max and min of
    h = g[idx] - d over the valid slots, 0 for an empty neighborhood."""
    h = jax.vmap(lambda a, i: a[i])(g, idx) - d[:, :, None, :]
    m = mask[..., None]
    any_ = mask.any(-1)[..., None]
    hmax = jnp.where(any_, jnp.max(jnp.where(m, h, -jnp.inf), axis=2), 0.0)
    hmin = jnp.where(any_, jnp.min(jnp.where(m, h, jnp.inf), axis=2), 0.0)
    return hmax, hmin


@pytest.mark.parametrize("values", ["ties", "distinct"])
@pytest.mark.parametrize("name", CASES)
def test_gather_matches_jnp_vjp(name, values):
    g, d, idx, mask, hmax, hmin, dmax, dmin = _inputs(
        name, 10, torch.float32, values == "ties", seed=420)
    got = mm_bwd_gather(g, d, idx, mask, hmax, hmin, dmax, dmin, tiles=2)
    jo, vjp = jax.vjp(lambda a, b: _jnp_minmax(
        a, b, jnp.asarray(idx.numpy()), jnp.asarray(mask.numpy())),
        jnp.asarray(g.numpy()), jnp.asarray(d.numpy()))
    for o, r in zip((hmax, hmin), jo):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # both split each cotangent evenly over ties; the sums associate
    # differently (tests/test_torch_pwmlp.py's tolerance for gradients)
    for o, r in zip(got, vjp((jnp.asarray(dmax.numpy()),
                              jnp.asarray(dmin.numpy())))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def pallas_vjp():
    """The JAX package's ``gather_sub_minmax`` (Pallas kernels,
    interpreted) and its VJP on the "strided" case at C = 8, distinct
    values (B·Nq = 48: the package folds the batch), one compile:
    (inputs, (hmax, hmin), (dg, dd))."""
    args = _inputs("strided", 8, torch.float32, ties=False, seed=440)
    g, d, idx, mask, _, _, dmax, dmin = args
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp)
        out, vjp = jax.vjp(lambda a, b: jgather_reduce.gather_sub_minmax(
            a, b, jnp.asarray(idx.numpy()), jnp.asarray(mask.numpy())),
            jnp.asarray(g.numpy()), jnp.asarray(d.numpy()))
        grads = vjp((jnp.asarray(dmax.numpy()), jnp.asarray(dmin.numpy())))
    return (args, [np.asarray(o) for o in out],
            [np.asarray(o) for o in grads])


@pytest.mark.parametrize("tiles", [1, 2])
def test_gather_matches_pallas_kernel(pallas_vjp, tiles):
    """Against the TPU kernels run interpreted, on distinct values (their
    every-tying-slot routing equals the even split there)."""
    args, out, grads = pallas_vjp
    for o, r in zip(args[4:6], out):  # the JAX tests' extrema tolerance
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5)
    got = mm_bwd_gather(*args, tiles=tiles)
    for o, r in zip(got, grads):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4, atol=1e-5)
    assert np.abs(grads[0]).max() > 0.1


def test_gather_variants_still_apply():
    """``tools/variants/k7b_gather.json`` (the gather at 3 or 6 blocks an
    SM, launch 1 at 3): each edit finds its text in
    ``csrc/gather_reduce.cu`` once."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "tools", "variants",
                           "k7b_gather.json")) as f:
        spec = json.load(f)
    with open(os.path.join(repo, "closerlook3d_tpu_torch", "csrc",
                           "gather_reduce.cu")) as f:
        src = f.read()
    assert spec["occ4"] == {} and "kGatherBlocks = 4;" in src
    for name, edits in spec.items():
        text = src
        for old, new in edits.get("gather_reduce.cu", []):
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
