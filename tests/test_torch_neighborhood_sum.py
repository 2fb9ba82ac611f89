"""The port's masked neighborhood sum (K13) and the point-wise MLP's route
through it, on the CPU, against the JAX package.

Seeded numpy inputs go through both packages:

* ``neighborhood_sum`` forward and VJP (the plain version on CPU tensors)
  against JAX's ``ops/pallas/gather_reduce.py::neighborhood_sum`` run in
  interpret mode and against the jnp reference (masked sum of a gather),
  in f32 and bf16, with a padded cloud, an all-masked cloud, a query with
  no valid slot and support indices that repeat within a neighborhood;
* the plain version's slot order and the backward twin against autograd
  of the plain forward, and the ``autograd.Function`` that carries the
  CUDA kernels, driven with counting plain twins in place of its
  launchers;
* the route of ``pwmlp_minmax_stats``: at B·Nq = 64, 65, 127 and 128 the
  port calls K13 + K7 or K6 exactly where JAX's ``pwmlp_minmax_stats``
  does (K13 + K7 up to 64 queries: JAX's query tile pads 65-127 to 128),
  and gives JAX's four outputs and gradients, in f32 and bf16;
* ``LocalAggregation``'s factorized point-wise MLP in train mode at B·Nq
  = 64 against JAX's factorized path (its K13 and K7 interpreted).

The CUDA kernels themselves are held to the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.ops.pallas import gather_reduce as jgather_reduce
from closerlook3d_tpu_torch.ops import gather_reduce
from closerlook3d_tpu_torch.ops.neighbors import ball_query
from test_torch_operator_models import _one_aten_thread  # noqa: F401
from test_torch_pwmlp import (  # noqa: F401  (kernel_route is a fixture)
    _agg_cfg, _check_agg, _run_both, kernel_route)


B, NQ, NS, K, C = 3, 40, 50, 9, 12


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _neighborhoods(seed, b=B, nq=NQ, ns=NS, k=K):
    """(idx, mask): random slots with repeats; cloud 1 keeps the first
    two thirds of its queries, cloud b-1 has no valid slot, query 0 of
    cloud 0 none either, and in every row of cloud 0 slot 1 repeats slot
    0's support index."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, ns, size=(b, nq, k)).astype(np.int32)
    idx[0, :, 1] = idx[0, :, 0]
    mask = rng.random((b, nq, k)) < 0.7
    mask[0, :, :2] = True
    mask[0, 0] = False
    if b > 2:
        mask[1, nq * 2 // 3:] = False
    mask[-1] = False
    return idx, mask


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16"
                                 else jnp.float32)


def _port_dtype(dtype):
    return torch.bfloat16 if dtype == "bf16" else torch.float32


def _jnp_sum(f, idx, mask):
    """The jnp reference: gather, mask, sum over the slots."""
    rows = jnp.take_along_axis(f, idx.reshape(idx.shape[0], -1)[..., None],
                               axis=1).reshape(*idx.shape, f.shape[-1])
    return jnp.sum(rows * mask[..., None].astype(f.dtype), axis=2)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def jax_sums(request):
    """JAX's neighborhood_sum (Pallas, interpreted) and the jnp reference,
    forward and VJP, on one seeded set of inputs. The jnp reference runs
    in f32 on the inputs as rounded to the dtype: the exact sums that
    the kernels round once."""
    dtype = request.param
    idx, mask = _neighborhoods(1)
    f, dy = _normal(2, B, NS, C), _normal(3, B, NQ, C)
    ji, jm = jnp.asarray(idx), jnp.asarray(mask)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp)
        for name, fn, cast in (
                ("pallas", jgather_reduce.neighborhood_sum, lambda x: x),
                ("jnp", _jnp_sum, lambda x: x.astype(jnp.float32))):
            y, vjp = jax.vjp(lambda a, fn=fn: fn(a, ji, jm),
                             cast(_to_jax(f, dtype)))
            (df,) = vjp(cast(_to_jax(dy, dtype)))
            out[name] = (np.asarray(y.astype(jnp.float32)),
                         np.asarray(df.astype(jnp.float32)))
    return dtype, idx, mask, f, dy, out


# f32: the same f32 terms summed in another order (slot by slot here, a
# multi-hot matmul there). bf16: the port and the Pallas kernel both
# accumulate in f32 and round once to bf16, so they differ by one bf16
# ulp (2^-7 of the value at most) where the two f32 sums straddle a
# rounding boundary (JAX's backward also rounds each query tile's
# partial, one tile at these shapes); against the exact f32 sums of the
# jnp reference the port is within half an ulp.
SUM_TOL = {"f32": dict(rtol=1e-5, atol=1e-6),
           "bf16": dict(rtol=2.0 ** -7, atol=1e-6)}


def test_neighborhood_sum_and_vjp_match_jax(jax_sums):
    dtype, idx, mask, f0, dy0, ref = jax_sums
    pdt = _port_dtype(dtype)
    f = torch.from_numpy(f0).to(pdt).requires_grad_(True)
    dy = torch.from_numpy(dy0).to(pdt)
    it, mt = torch.from_numpy(idx), torch.from_numpy(mask)
    out = gather_reduce.neighborhood_sum(f, it, mt)
    (df,) = torch.autograd.grad(out, f, dy)
    assert out.dtype == df.dtype == pdt
    assert out.shape == (B, NQ, C) and df.shape == (B, NS, C)
    got = out.detach().float().numpy()
    assert np.all(got[~mask.any(-1)] == 0.0)  # empty neighborhoods
    assert np.all(df[-1].float().numpy() == 0.0)  # the all-masked cloud
    for name in ("pallas", "jnp"):
        y, dref = ref[name]
        np.testing.assert_allclose(got, y, **SUM_TOL[dtype], err_msg=name)
        np.testing.assert_allclose(df.float().numpy(), dref,
                                   **SUM_TOL[dtype], err_msg=name)


def test_repeated_index_counts_once_per_slot():
    f = torch.tensor([[[1.0, 2.0], [10.0, 20.0]]])
    idx = torch.tensor([[[1, 1, 0, 1]]], dtype=torch.int32)
    mask = torch.tensor([[[True, True, True, False]]])
    assert gather_reduce.neighborhood_sum_plain(f, idx, mask).tolist() == [
        [[21.0, 42.0]]]
    df = gather_reduce.neighborhood_sum_bwd_plain(
        idx, mask, torch.ones((1, 1, 2)), 2)
    assert df.tolist() == [[[1.0, 1.0], [2.0, 2.0]]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_sums_in_slot_order_and_twin_matches_autograd(dtype):
    """The plain version is the f32 running sum over t = 0..K-1, rounded
    once, to the bit; the twin equals autograd of the plain forward."""
    idx, mask = _neighborhoods(4)
    it, mt = torch.from_numpy(idx), torch.from_numpy(mask)
    f = torch.from_numpy(_normal(5, B, NS, C) * 1e3).to(dtype)
    acc = torch.zeros((B, NQ, C))
    for t in range(K):
        for b in range(B):
            rows = f[b, it[b, :, t].long()].float()
            acc[b] += torch.where(mt[b, :, t, None], rows, 0.0)
    got = gather_reduce.neighborhood_sum_plain(f, it, mt)
    assert torch.equal(got, acc.to(dtype))
    x = f.clone().requires_grad_(True)
    dy = torch.from_numpy(_normal(6, B, NQ, C)).to(dtype)
    (ref,) = torch.autograd.grad(gather_reduce.neighborhood_sum_plain(
        x, it, mt), x, dy)
    twin = gather_reduce.neighborhood_sum_bwd_plain(it, mt, dy, NS)
    assert twin.dtype == dtype
    # f32: the same terms scattered in another order; bf16: both sum in
    # f32 and round once
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=2.0 ** -7, atol=1e-6))
    torch.testing.assert_close(twin.float(), ref.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_twin_sums_in_query_slot_order(dtype):
    """The backward twin on CPU tensors is, for each support row, the f32
    running sum of dy[b, q] over the valid slots (q, t) that hold the row,
    in (b, q, t) order, rounded once: the order the backward kernel adds
    in, so that the two are equal to the bit. Rows that a neighborhood
    lists twice (cloud 0's slots 0 and 1) add twice; magnitudes spread
    over six decades so that another order would round otherwise."""
    idx, mask = _neighborhoods(10)
    scale = 10.0 ** np.random.default_rng(12).uniform(-3, 3, (B, NQ, 1))
    dy = torch.from_numpy((_normal(11, B, NQ, C) * scale).astype(
        np.float32)).to(dtype)
    dyf = dy.float().numpy()
    acc = np.zeros((B, NS, C), np.float32)
    for b in range(B):
        for q in range(NQ):
            for t in range(K):
                if mask[b, q, t]:
                    acc[b, idx[b, q, t]] += dyf[b, q]
    got = gather_reduce.neighborhood_sum_bwd_plain(
        torch.from_numpy(idx), torch.from_numpy(mask), dy, NS)
    assert got.dtype == dtype
    assert torch.equal(got, torch.from_numpy(acc).to(dtype))


def test_autograd_function_routes_through_the_kernels(kernel_route):
    idx, mask = _neighborhoods(7)
    it, mt = torch.from_numpy(idx), torch.from_numpy(mask)
    f0 = torch.from_numpy(_normal(8, B, NS, C))
    dy = torch.from_numpy(_normal(9, B, NQ, C))
    f = f0.clone().requires_grad_(True)
    out = gather_reduce.neighborhood_sum(f, it, mt)
    (df,) = torch.autograd.grad(out, f, dy)
    assert torch.equal(out, gather_reduce.neighborhood_sum_plain(f0, it, mt))
    assert torch.equal(df, gather_reduce.neighborhood_sum_bwd_plain(
        it, mt, dy, NS))
    assert kernel_route["neighborhood_sum_cuda"].calls == 1
    assert kernel_route["neighborhood_sum_bwd_cuda"].calls == 1
    with torch.no_grad():  # no backward, no record
        gather_reduce.neighborhood_sum(f, it, mt)
    assert kernel_route["neighborhood_sum_bwd_cuda"].calls == 1


# ---- the route of pwmlp_minmax_stats -------------------------------------------

def _counting(fn, calls, name):
    def wrapped(*args):
        calls[name] += 1
        return fn(*args)
    return wrapped


@pytest.fixture(scope="module", params=[(8, 8), (5, 13), (1, 127), (2, 64)],
                ids=["BNq64", "BNq65", "BNq127", "BNq128"])
def jax_route(request):
    """JAX's pwmlp_minmax_stats (interpreted) at one (B, Nq), f32 and bf16:
    which primitives it called, its outputs and its VJP."""
    b, nq = request.param
    ns = 2 * nq
    rng = np.random.default_rng(10 + nq)
    xyz = rng.uniform(-1, 1, size=(b, ns, 3)).astype(np.float32)
    smask = np.ones((b, ns), bool)
    smask[-1, ns * 2 // 3:] = False  # a padded cloud
    pm = torch.from_numpy(smask)
    idx, nmask = ball_query(torch.from_numpy(xyz[:, :nq]),
                            torch.from_numpy(xyz), 0.6, K,
                            query_mask=pm[:, :nq], support_mask=pm)
    idx, nmask = idx.numpy(), nmask.numpy()
    # no ties in either dtype: per cloud and channel a permutation of
    # distinct multiples of 1/8, exact in bf16 (the Pallas K6 and K7 route
    # a tied extremum's cotangent otherwise than each other and the port)
    g = np.stack([np.stack([rng.permutation(ns) for _ in range(C)], -1)
                  for _ in range(b)]).astype(np.float32)
    g = (g - ns / 2) / 8
    cot = [_normal(12 + i, b, nq, C) for i in range(4)]
    runs = {}
    for dtype in ("f32", "bf16"):
        calls = {"neighborhood_sum": 0, "gather_sub_minmax": 0,
                 "_pwstats_vjp": 0}
        with pytest.MonkeyPatch.context() as mp:
            conftest.pallas_test_mode(mp)
            for name in calls:
                mp.setattr(jgather_reduce, name, _counting(
                    getattr(jgather_reduce, name), calls, name))
            jg = _to_jax(g, dtype)
            outs, vjp = jax.vjp(
                lambda a, s: jgather_reduce.pwmlp_minmax_stats(
                    a, s, jnp.asarray(idx), jnp.asarray(nmask)),
                jg, (jg.astype(jnp.float32) ** 2).astype(jg.dtype))
            grads = vjp(tuple(jnp.asarray(c).astype(o.dtype)
                              for c, o in zip(cot, outs)))
        runs[dtype] = (dict(calls), [np.asarray(o.astype(jnp.float32))
                                     for o in outs],
                       [np.asarray(x.astype(jnp.float32)) for x in grads])
    return b, nq, idx, nmask, g, cot, runs


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pwmlp_route_follows_jax(jax_route, kernel_route, dtype):
    b, nq, idx, nmask, g0, cot, runs = jax_route
    jcalls, jouts, jgrads = runs[dtype]
    small = b * nq <= 64
    assert jcalls == {"neighborhood_sum": int(small),
                      "gather_sub_minmax": int(small),
                      "_pwstats_vjp": int(not small)}
    pdt = _port_dtype(dtype)
    g = torch.from_numpy(g0).to(pdt).requires_grad_(True)
    gsq = (g.detach().float() ** 2).to(pdt).requires_grad_(True)
    outs = gather_reduce.pwmlp_minmax_stats(g, gsq, torch.from_numpy(idx),
                                            torch.from_numpy(nmask))
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cot])
    calls = {k: f.calls for k, f in kernel_route.items()}
    assert calls == {
        "neighborhood_sum_cuda": int(small),
        "neighborhood_sum_bwd_cuda": int(small),
        "gather_sub_minmax_cuda": int(small),
        "gather_sub_minmax_bwd_cuda": int(small),
        "pwmlp_minmax_stats_cuda": int(not small),
        "pwmlp_minmax_stats_bwd_cuda": int(not small)}
    assert all(o.dtype == torch.float32 for o in outs)
    if small and dtype == "bf16":  # s1, s2 rounded to g's dtype, as JAX
        for o in outs[2:]:
            assert torch.equal(o, o.to(torch.bfloat16).float())
    for i, (o, r) in enumerate(zip(outs, jouts)):
        if i < 2:  # max and min are exact
            np.testing.assert_array_equal(o.detach().numpy(), r)
        elif dtype == "bf16" and small:
            np.testing.assert_allclose(o.detach().numpy(), r,
                                       **SUM_TOL["bf16"])
        else:
            # f32 sums (K6's f64 sums against JAX's f32 ones; f32 in both
            # on the K13 route)
            np.testing.assert_allclose(o.detach().numpy(), r, rtol=1e-5,
                                       atol=1e-5)
    # gradients: f32 scatters in another order. bf16: K13's backward
    # equals JAX's, but JAX's K7 backward rounds its bf16 scatter
    # otherwise than the port's (one ulp of the K7 term) and the K13 and
    # K7 terms add in bf16, so where they cancel the gap is one bf16 ulp
    # of the largest gradient, not of the element
    for x, r in zip((g, gsq), jgrads):
        tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "f32"
               else dict(rtol=2.0 ** -7,
                         atol=2.0 ** -7 * float(np.abs(r).max())))
        np.testing.assert_allclose(x.grad.float().numpy(), r, **tol)


def test_pwmlp_local_aggregation_on_the_k13_route_matches_jax():
    """Train mode at B·Nq = 64: JAX's factorized path composes its K13 and
    K7 (interpreted), the port the plain versions of the same route."""
    rng = np.random.default_rng(30)
    xyz = rng.uniform(-1, 1, size=(2, 32, 3)).astype(np.float32)
    mask = np.ones((2, 32), bool)
    mask[1, 24:] = False
    pm = torch.from_numpy(mask)
    idx, nmask = ball_query(torch.from_numpy(xyz), torch.from_numpy(xyz),
                            0.5, 6, query_mask=pm, support_mask=pm)
    cloud = (xyz, idx.numpy(), nmask.numpy())
    assert (~cloud[2].any(-1)).any()
    port, ref, la = _run_both(_agg_cfg(), cloud, True, flag="always")
    assert la.factorized
    _check_agg(port, ref, True)
