"""The neighborhood max's backward as the CUDA kernel computes it
(``csrc/neighborhood_max.cu``: two launches over a reverse neighbor
index), emulated in PyTorch on the CPU.

Launch 1 builds the reverse index in query tiles and, beside it, writes
per query and channel the tie count n over the query's valid slots (mask
set, index >= 0) and g = dy / n rounded to the features' dtype (0 where n
= 0); launch 2 adds, for each support row and channel, g of the row's
entries (q, t) whose out[q] the row's value ties, tile after tile and in
each tile in the index's order, in f32 from +0, and rounds once.
``nmax_bwd_gather`` does the same with the plain reverse index
(``reverse_index_plain``) and is held to

* ``neighborhood_max_bwd_plain`` to the bit (bit patterns, zero signs
  included), f32 and bf16, 1 to 4 tiles, C = 6, 13 (off the 8-channel
  unit) and 72, on ties (duplicated points and post-ReLU values on a
  grid), all-masked queries, support rows no query reaches, one row named
  by every slot and strided shapes;
* the VJP of the JAX package's jnp ``neighborhood_max`` and of its Pallas
  pair run interpreted (distinct values, where the Pallas pair's
  first-winner rule equals the even split), f32, at the tolerance of the
  port's other tests of it (``tests/test_torch_grad.py``).

The kernel is held to the twin on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.ops import grouping as jgrouping
from closerlook3d_tpu_torch.ops import grouping
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
    """(support xyz, idx, mask) of a named case, two clouds (the second
    padded to 70%): "ties" (points on a 0.25 grid, the first eighth
    duplicated), "masked_queries" (every third query of cloud 0 masked),
    "unreached" (12 queries over 160 supports), "one_row" (every slot
    names row 3) and "strided" (24 queries over 96 supports)."""
    nq, ns, k, r = {"ties": (48, 48, 16, 0.45),
                    "masked_queries": (48, 48, 12, 0.4),
                    "unreached": (12, 160, 12, 0.3),
                    "one_row": (20, 40, 10, 0.5),
                    "strided": (24, 96, 12, 0.45)}[name]
    rng = np.random.default_rng(CASES.index(name) + 170)
    s = rng.uniform(-1, 1, size=(2, ns, 3)).astype(np.float32)
    if name == "ties":
        s = np.round(s * 4) / 4
        s[:, ns // 8:ns // 4] = s[:, :ns // 4 - ns // 8]
    smask = np.ones((2, ns), bool)
    smask[1, ns * 7 // 10:] = False
    q, qmask = ((s, smask) if nq == ns
                else (s[:, ::ns // nq][:, :nq].copy(),
                      smask[:, ::ns // nq][:, :nq].copy()))
    st = torch.from_numpy(s)
    idx, mask = ball_query(torch.from_numpy(np.ascontiguousarray(q)), st, r,
                           k, query_mask=torch.from_numpy(qmask),
                           support_mask=torch.from_numpy(smask))
    if name == "masked_queries":
        mask[0, ::3] = False
    if name == "one_row":
        idx = torch.full_like(idx, 3)
    assert mask.any()
    return st, idx, mask


def _features(s, c, seed, ties=True):
    """Post-ReLU values on a 0.25 grid that are a function of the point's
    position (duplicated points carry equal rows, exact ties), or distinct
    normal values."""
    rng = np.random.default_rng(seed)
    if ties:
        w = torch.from_numpy(rng.normal(size=(3, c)).astype(np.float32))
        return torch.relu(torch.round(4 * (s @ w)) / 4)
    return torch.from_numpy(rng.normal(size=(*s.shape[:2], c))
                            .astype(np.float32))


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def tie_quotients(f, idx, mask, out, dy):
    """Launch 1's query groups: g [B, Nq, C] f32 of dtype values, n > 0
    ? round(dy / n) : 0, n the valid slots (index >= 0) tying out."""
    valid = mask & (idx >= 0)
    rows = grouping.group_features(f, idx.clamp(min=0))
    n = ((rows == out[:, :, None, :]) & valid[..., None]).sum(dim=2)
    g = (dy.float() / n.clamp(min=1)).to(dy.dtype).float()
    return torch.where(n > 0, g, 0.0)


def nmax_bwd_gather(f, idx, mask, out, dy, tiles=1):
    """The two launches: the index in ``tiles`` tiles of consecutive
    queries, each entry holding its query, read tile after tile; per
    support row the f32 sum from +0 of g[q] over its entries where the
    row ties out[q], one add a step; rounded to dy's dtype."""
    b, nq, _ = idx.shape
    ns, c = f.shape[1], f.shape[2]
    g = tie_quotients(f, idx, mask, out, dy)
    per = -(-nq // tiles)
    cloud = torch.arange(b)[:, None]
    acc = torch.zeros((b, ns, c))
    for q0 in range(0, nq, per):
        offsets, slots = reverse_index_plain(idx[:, q0:q0 + per],
                                             mask[:, q0:q0 + per], ns)
        counts = offsets[:, 1:] - offsets[:, :-1]
        k = idx.shape[2]
        for pos in range(int(counts.max())):
            has = counts > pos
            at = torch.where(has, offsets[:, :-1] + pos, 0).long()
            qi = q0 + torch.where(has, torch.gather(slots, 1, at),
                                  0).long() // k
            tie = f.float() == out.float()[cloud, qi]
            add = has[..., None] & tie
            acc = torch.where(add, acc + g[cloud, qi], acc)
    return acc.to(dy.dtype)


@pytest.mark.parametrize("tiles", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [6, 13, 72])
@pytest.mark.parametrize("name", CASES)
def test_gather_equals_twin_to_the_bit(name, c, dtype, tiles):
    s, idx, mask = _case(name)
    f = _features(s, c, 200 + c).to(dtype)
    out = grouping.neighborhood_max_plain(f, idx, mask)
    rng = np.random.default_rng(210 + c)
    dy = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32)).to(
        dtype)
    got = nmax_bwd_gather(f, idx, mask, out, dy, tiles)
    ref = grouping.neighborhood_max_bwd_plain(f, idx, mask, out, dy)
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    assert torch.equal(_bits(got), _bits(ref))
    assert got.abs().max() > 0.1


def test_ties_split_evenly_and_empty_queries_send_nothing():
    """Where n slots tie, each of their rows takes dy / n; a query with no
    valid slot sends nothing, and its g is never read."""
    f = torch.tensor([[[1.0], [1.0], [0.5], [3.0]]])
    idx = torch.tensor([[[0, 1, 2], [3, 3, 0], [2, 1, 0]]], dtype=torch.int32)
    mask = torch.tensor([[[True, True, True], [False, False, False],
                          [True, False, False]]])
    out = grouping.neighborhood_max_plain(f, idx, mask)
    dy = torch.tensor([[[6.0], [5.0], [2.0]]])
    got = nmax_bwd_gather(f, idx, mask, out, dy)
    assert got.flatten().tolist() == [3.0, 3.0, 2.0, 0.0]
    assert torch.equal(got, grouping.neighborhood_max_bwd_plain(
        f, idx, mask, out, dy))


@pytest.mark.parametrize("values", ["ties", "distinct"])
@pytest.mark.parametrize("name", CASES)
def test_gather_matches_jax_vjp(name, values):
    s, idx, mask = _case(name)
    f = _features(s, 10, 220, values == "ties")
    out = grouping.neighborhood_max_plain(f, idx, mask)
    dy = np.random.default_rng(221).normal(size=out.shape).astype(np.float32)
    got = nmax_bwd_gather(f, idx, mask, out, torch.from_numpy(dy), tiles=2)
    _, vjp = jax.vjp(lambda x: jgrouping.neighborhood_max(
        x, jnp.asarray(idx.numpy()), jnp.asarray(mask.numpy())),
        jnp.asarray(f.numpy()))
    # both split dy evenly over ties; the sums associate differently
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["masked_queries", "strided"])
def test_gather_matches_pallas_kernel(name, monkeypatch):
    """Against the TPU kernel pair run interpreted, on distinct values
    (its first-winner routing equals the even split there)."""
    from closerlook3d_tpu.ops.pallas.gather_reduce import (
        neighborhood_max as jmax_pallas)

    s, idx, mask = _case(name)
    f = _features(s, 8, 230, ties=False)
    out = grouping.neighborhood_max_plain(f, idx, mask)
    dy = np.random.default_rng(231).normal(size=out.shape).astype(np.float32)
    conftest.pallas_test_mode(monkeypatch)
    jout, vjp = jax.vjp(lambda x: jmax_pallas(x, jnp.asarray(idx.numpy()),
                                              jnp.asarray(mask.numpy())),
                        jnp.asarray(f.numpy()))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    got = nmax_bwd_gather(f, idx, mask, out, torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]),
                               rtol=1e-6, atol=1e-6)
