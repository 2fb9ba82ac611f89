"""The reverse neighbor index and the backward gathers over it, on the CPU.

The backward kernels of the point-wise MLP's statistics (K6b,
``csrc/gather_reduce.cu``) and of the pseudo-grid (K10b,
``csrc/pseudo_grid.cu``) gather with no float atomics: a first launch
builds the reverse (CSR) index of idx/mask, support row -> the slots
(q, t) naming it in (q, t) order, beside a query-major pass that writes
each valid slot's f32 term; a second adds each row's terms in that order
from +0 and writes the row once. The backward kernels of PosPool sin/cos
(K5b, ``csrc/pospool_sincos.cu``) and of the neighborhood moments (K9b,
``csrc/moments.cu``) write no terms: their first launch builds the index,
one block a tile of consecutive queries (and, for avg, g = dy /
max(count, 1) by query), and their gather recomputes each entry's term
from g[q] and D, which it takes from the row's own position
(``csrc/row_terms.cuh``), as does the backward of PosPool xyz (K1b,
``csrc/pospool_xyz.cu``). Here the plain index
(``reverse_index_plain``) and a plain emulation of each gather (the same
terms, one f32 add at a time in the index's order, one rounding) are held
to the port's twins and to JAX:

* K6b's emulation equals ``pwmlp_minmax_stats_bwd_plain`` to the bit, in
  f32 and bf16, zero signs included: the twin's ``index_add_`` adds in
  (q, t) order on CPU tensors, and its masked slots add +-0, which never
  changes a sum started at +0 under round-to-nearest (so the comparison
  is of bit patterns, ``_bits``);
* K10b's emulation is within the pseudo-grid tolerance of
  ``pseudo_grid_bwd_plain`` (which sums over kernel points by a matmul)
  and of the VJP of JAX's Pallas ``pseudo_grid_fused`` run interpreted;
* the tiled index, read tile after tile, is the index;
* K1b's, K5b's and K9b's emulations equal ``pospool_xyz_bwd_plain``,
  ``pospool_sincos_bwd_plain`` and ``neighborhood_moments_bwd_plain`` to
  the bit (bit patterns), f32 and bf16, sum and avg, and are within the
  JAX package's tolerances of the VJPs of its Pallas ``pospool_fused``
  (xyz, sin/cos) and ``neighborhood_moments`` run interpreted;

on ties (duplicated points), all-masked queries, support rows no query
reaches, one row named by every valid slot, strided shapes, and C = 1, 7
and 72 (6 and 72 for K1b, K5b and K9b). The kernels themselves are held
to the twins on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.ops.pallas import aggregation as jaggregation
from closerlook3d_tpu.ops.pallas import moments as jmoments
from closerlook3d_tpu.ops.pallas import pseudo_grid as jpseudo_grid
from closerlook3d_tpu_torch.models import aggregation as agg
from closerlook3d_tpu_torch.ops import (
    aggregation, gather_reduce, moments, pseudo_grid)
from closerlook3d_tpu_torch.ops.grouping import (
    group_features, reduction_grad)
from closerlook3d_tpu_torch.ops.neighbors import ball_query
from closerlook3d_tpu_torch.ops.reverse_index import reverse_index_plain

KPN = 15
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
    """(query xyz, support xyz, idx, mask, radius) of a named case, two
    clouds (the second padded to 70%): "ties" (points on a 0.25 grid, the
    first eighth duplicated: equal features, exact ties), "masked_queries"
    (every third query of cloud 0 masked), "unreached" (12 queries over 160
    supports: most rows unnamed), "one_row" (every slot names row 3) and
    "strided" (24 queries over 96 supports)."""
    nq, ns, k, r = {"ties": (48, 48, 16, 0.45),
                    "masked_queries": (48, 48, 12, 0.4),
                    "unreached": (12, 160, 12, 0.3),
                    "one_row": (20, 40, 10, 0.5),
                    "strided": (24, 96, 12, 0.45)}[name]
    rng = np.random.default_rng(CASES.index(name) + 70)
    s = rng.uniform(-1, 1, size=(2, ns, 3)).astype(np.float32)
    if name == "ties":
        s = np.round(s * 4) / 4
        s[:, ns // 8:ns // 4] = s[:, :ns // 8]
    smask = np.ones((2, ns), bool)
    smask[1, ns * 7 // 10:] = False
    q, qmask = ((s, smask) if nq == ns
                else (s[:, ::ns // nq][:, :nq].copy(),
                      smask[:, ::ns // nq][:, :nq].copy()))
    st, qt = torch.from_numpy(s), torch.from_numpy(np.ascontiguousarray(q))
    idx, nmask = ball_query(qt, st, r, k, query_mask=torch.from_numpy(qmask),
                            support_mask=torch.from_numpy(smask))
    if name == "masked_queries":
        nmask[0, ::3] = False
    if name == "one_row":
        idx = torch.full_like(idx, 3)
    assert nmask.any()
    return qt, st, idx, nmask, r


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def gather_rows(offsets, slots, terms, ns: int):
    """The gathers' arithmetic: per support row, the f32 sum from +0 of
    terms[b, slot] [B, Nq * K, C] over the row's slots in the index's
    order, one add (one rounding) at a time: [B, Ns, C] f32."""
    b, c = terms.shape[0], terms.shape[2]
    counts = offsets[:, 1:] - offsets[:, :-1]
    acc = torch.zeros((b, ns, c), dtype=torch.float32)
    cloud = torch.arange(b)[:, None]
    for pos in range(int(counts.max())):
        has = counts > pos
        at = torch.where(has, offsets[:, :-1] + pos, 0).long()
        slot = torch.where(has, torch.gather(slots, 1, at), 0).long()
        acc = torch.where(has[..., None], acc + terms[cloud, slot], acc)
    return acc


def pwmlp_bwd_gather(g, idx, mask, gmax, gmin, dmax, dmin, ds1, ds2):
    """K6b's two launches emulated: each valid slot's term ds1 + (dmax / n
    [g == gmax] + dmin / m [g == gmin]), grouped as the twin groups it
    (n, m: the query's valid slots at the max, the min), gathered over the
    reverse index with ds2 beside it; (dg, dgsq) in g's dtype."""
    b, nq, k = idx.shape
    ns, c = g.shape[1:]
    gf = group_features(g.float(), idx)
    at_hi = gf == gmax[:, :, None, :]
    at_lo = gf == gmin[:, :, None, :]
    valid = mask[..., None]
    sh_hi = dmax / (at_hi & valid).sum(dim=2).clamp(min=1)
    sh_lo = dmin / (at_lo & valid).sum(dim=2).clamp(min=1)
    terms = ds1[:, :, None, :] + (sh_hi[:, :, None, :] * at_hi
                                  + sh_lo[:, :, None, :] * at_lo)
    offsets, slots = reverse_index_plain(idx, mask, ns)
    dg = gather_rows(offsets, slots, terms.reshape(b, nq * k, c), ns)
    per_slot = ds2[:, :, None, :].expand(b, nq, k, c).reshape(b, nq * k, c)
    dgsq = gather_rows(offsets, slots, per_slot, ns)
    return dg.to(g.dtype), dgsq.to(g.dtype)


def pgrid_bwd_gather(q, s, idx, mask, kp, dy, radius, extent, mode):
    """K10b's two launches emulated: each valid slot's f32 sum over the
    kernel points of w[p] dy[q, p*C + c] (one product and one add at a
    time, p in order), gathered over the reverse index; in dy's dtype."""
    b, nq, k = idx.shape
    kpn, ns = kp.shape[0], s.shape[1]
    w = pseudo_grid.influence_weights(q, s, idx, mask, kp, radius, extent,
                                      mode)
    dyr = dy.float().reshape(b, nq, kpn, -1)
    sums = torch.zeros((b, nq, k, dyr.shape[-1]), dtype=torch.float32)
    for p in range(kpn):
        sums = sums + w[..., p, None] * dyr[:, :, None, p, :]
    offsets, slots = reverse_index_plain(idx, mask, ns)
    return gather_rows(offsets, slots, sums.reshape(b, nq * k, -1),
                       ns).to(dy.dtype)


def _pgrid_tol(dtype):
    """The same f32 slot terms summed over kernel points and slots in
    other orders (a matmul and index_add_, or JAX's kernel), each rounded
    once; in bf16 one ulp where the orders straddle a rounding
    boundary."""
    return (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
            else dict(rtol=8e-3, atol=1e-5))


def _kernel_points():
    kp = agg.kernel_point_layout(KPN, "center")
    return torch.from_numpy(kp), agg._typical_spacing(kp)


def test_reverse_index_plain_on_a_hand_made_case():
    # cloud 0: row 0 <- slots (0,0), (1,1); row 1 <- (0,1); row 2 <- (1,0);
    # masked slots left out; cloud 1: row 1 <- (0,0), (0,2); row 0 <- (1,0)
    idx = torch.tensor([[[0, 1, 1], [2, 0, 0]], [[1, 1, 1], [0, 0, 2]]],
                       dtype=torch.int32)
    mask = torch.tensor([[[1, 1, 0], [1, 1, 0]], [[1, 0, 1], [1, 0, 0]]],
                        dtype=torch.bool)
    offsets, slots = reverse_index_plain(idx, mask, 3)
    assert offsets.tolist() == [[0, 2, 3, 4], [0, 1, 3, 3]]
    assert slots.tolist() == [[0, 4, 1, 3, -1, -1], [3, 0, 2, -1, -1, -1]]


@pytest.mark.parametrize("name", CASES)
def test_reverse_index_plain_lists_each_valid_slot_once_in_order(name):
    _, s, idx, mask, _ = _case(name)
    ns = s.shape[1]
    offsets, slots = reverse_index_plain(idx, mask, ns)
    b, nq, k = idx.shape
    assert offsets.dtype == slots.dtype == torch.int32
    assert offsets.shape == (b, ns + 1) and slots.shape == (b, nq * k)
    for cloud in range(b):
        off, sl = offsets[cloud].long(), slots[cloud].long()
        n = int(mask[cloud].sum())
        assert off[0] == 0 and off[-1] == n and (off[1:] >= off[:-1]).all()
        assert (sl[n:] == -1).all()
        listed = sl[:n]
        # each valid slot once, under the row its idx names
        assert torch.equal(listed.sort().values,
                           torch.nonzero(mask[cloud].reshape(-1))[:, 0])
        rows = torch.repeat_interleave(torch.arange(ns), off[1:] - off[:-1])
        assert torch.equal(idx[cloud].reshape(-1)[listed].long(), rows)
        for r in range(ns):  # ascending within a row: (q, t) order
            seg = listed[off[r]:off[r + 1]]
            assert (seg[1:] > seg[:-1]).all()
    if name == "unreached":
        assert (offsets[:, 1:] == offsets[:, :-1]).any()
    if name == "one_row":
        assert (offsets[:, 4] - offsets[:, 3] == mask.sum((1, 2))).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 7, 72])
@pytest.mark.parametrize("name", CASES)
def test_pwmlp_gather_equals_twin_to_the_bit(name, c, dtype):
    _, s, idx, mask, _ = _case(name)
    rng = np.random.default_rng(80 + c)
    ns, nq = s.shape[1], idx.shape[1]
    # values on a 0.5 grid, a function of the point: ties within
    # neighborhoods, equal rows at duplicated points
    proj = torch.from_numpy(rng.normal(size=(3, c)).astype(np.float32))
    g32 = torch.round(2 * (s @ proj)) / 2
    g, gsq = g32.to(dtype), (g32 * g32).to(dtype)
    gmax, gmin, _, _ = gather_reduce.pwmlp_minmax_stats_plain(g, gsq, idx,
                                                              mask)
    cot = [torch.from_numpy(rng.normal(size=(2, nq, c)).astype(np.float32))
           for _ in range(4)]
    args = (g, idx, mask, gmax, gmin, *cot)
    got = pwmlp_bwd_gather(*args)
    twin = gather_reduce.pwmlp_minmax_stats_bwd_plain(*args)
    for o, r in zip(got, twin):
        assert o.dtype == r.dtype == dtype and o.shape == g.shape
        assert torch.equal(_bits(o), _bits(r))
    assert (gmax == gmin).any()  # ties: several slots share the extremum


def test_pwmlp_gather_and_twin_never_end_on_minus_zero():
    """Two slots of one row whose terms cancel: both sums come out +0 (a
    sum started at +0 in round-to-nearest is never -0), so bit patterns,
    zero signs included, are the comparison."""
    idx = torch.tensor([[[0, 1], [0, 1]]], dtype=torch.int32)
    mask = torch.tensor([[[True, False], [True, False]]])
    g = torch.tensor([[[1.0], [2.0]]])
    zero = torch.zeros((1, 2, 1))
    ds1 = torch.tensor([[[0.5], [-0.5]]])
    args = (g, idx, mask, g[:, :1].expand(1, 2, 1), g[:, :1].expand(1, 2, 1),
            zero, zero, ds1, -zero)
    for dg, dgsq in (pwmlp_bwd_gather(*args),
                     gather_reduce.pwmlp_minmax_stats_bwd_plain(*args)):
        assert dg[0, 0, 0] == 0 and not torch.signbit(dg[0, 0, 0])
        assert not torch.signbit(dgsq).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 7, 72])
@pytest.mark.parametrize("name", CASES)
def test_pgrid_gather_matches_twin(name, c, dtype):
    q, s, idx, mask, r = _case(name)
    kp, extent = _kernel_points()
    rng = np.random.default_rng(90 + c)
    dy = torch.from_numpy(rng.normal(size=(2, idx.shape[1], KPN * c))
                          .astype(np.float32)).to(dtype)
    for mode in ("linear", "gaussian"):
        args = (q, s, idx, mask, kp, dy, r, extent, mode)
        got = pgrid_bwd_gather(*args)
        twin = pseudo_grid.pseudo_grid_bwd_plain(*args)
        assert got.dtype == dtype and got.shape == (2, s.shape[1], c)
        torch.testing.assert_close(got.float(), twin.float(),
                                   **_pgrid_tol(dtype))


@pytest.mark.parametrize("name", ["ties", "strided", "one_row"])
def test_pgrid_gather_matches_pallas_kernel(name, monkeypatch):
    """Against the VJP of JAX's Pallas ``pseudo_grid_fused`` (its
    ``_bwd_kernel``) run interpreted, f32, linear influence."""
    q, s, idx, mask, r = _case(name)
    kp, extent = _kernel_points()
    c = 6
    rng = np.random.default_rng(95)
    feats = rng.normal(size=(2, s.shape[1], c)).astype(np.float32)
    dy = rng.normal(size=(2, idx.shape[1], KPN * c)).astype(np.float32)
    conftest.pallas_test_mode(monkeypatch)
    _, vjp = jax.vjp(lambda f: jpseudo_grid.pseudo_grid_fused(
        jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), f,
        jnp.asarray(idx.numpy()), jnp.asarray(mask.numpy()),
        jnp.asarray(kp.numpy()), r, extent, "linear"), jnp.asarray(feats))
    (ref,) = vjp(jnp.asarray(dy))
    got = pgrid_bwd_gather(q, s, idx, mask, kp, torch.from_numpy(dy), r,
                           extent, "linear")
    assert np.abs(np.asarray(ref)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def recompute_rows(q, s, idx, mask, c: int, term):
    """The arithmetic of K5b's and K9b's gathers: per support row, the f32
    sum from +0 over the row's entries (q, t) in the reverse index's order
    of term(qi, diff) [B, Ns, C], recomputed per entry from the entry's
    query qi [B, Ns] and diff = s[row] - q[qi] [B, Ns, 3], the row's own
    position (rows past their count take query 0 and are left as they
    were), one add (one rounding) at a time: [B, Ns, C] f32."""
    b, _, k = idx.shape
    ns = s.shape[1]
    offsets, slots = reverse_index_plain(idx, mask, ns)
    counts = offsets[:, 1:] - offsets[:, :-1]
    cloud = torch.arange(b)[:, None]
    acc = torch.zeros((b, ns, c))
    for pos in range(int(counts.max())):
        has = counts > pos
        at = torch.where(has, offsets[:, :-1] + pos, 0).long()
        qi = torch.where(has, torch.gather(slots, 1, at), 0).long() // k
        acc = torch.where(has[..., None], acc + term(qi, s - q[cloud, qi]),
                          acc)
    return acc


def _dp(diff, radius, dtype):
    """(s - q) / r in f32, rounded to ``dtype``, as ``neighbor_offsets``
    forms it."""
    return (diff / torch.full((), radius, dtype=torch.float32)).to(dtype)


def xyz_bwd_gather(q, s, idx, mask, dy, radius, reduction):
    """K1b's two launches emulated: g as for K5b; each entry's term
    g[q, c] * dp[c / (C/3)], dp rounded to dy's dtype, the product rounded
    once; gathered over the reverse index; in dy's dtype."""
    g = reduction_grad(dy, mask, reduction)
    cloud = torch.arange(idx.shape[0])[:, None]
    c = dy.shape[-1]

    def term(qi, diff):
        dp = _dp(diff, radius, dy.dtype).float()
        return g[cloud, qi] * dp.repeat_interleave(c // 3, dim=-1)

    return recompute_rows(q, s, idx, mask, c, term).to(dy.dtype)


def sincos_bwd_gather(q, s, idx, mask, dy, radius, reduction):
    """K5b's two launches emulated: g = dy, or dy / max(count, 1) rounded
    to dy's dtype (avg); each entry's term g[q, c] * E(dp)[c], E the
    embedding of f32 dp rounded to dy's dtype; gathered over the reverse
    index; in dy's dtype."""
    g = reduction_grad(dy, mask, reduction)
    cloud = torch.arange(idx.shape[0])[:, None]
    c = dy.shape[-1]

    def term(qi, diff):
        emb = aggregation.sinusoidal_embedding(
            _dp(diff, radius, torch.float32), c).to(dy.dtype).float()
        return g[cloud, qi] * emb

    return recompute_rows(q, s, idx, mask, c, term).to(dy.dtype)


def moments_bwd_gather(q, s, idx, mask, dy, radius, reduction):
    """K9b's two launches emulated: g as for K5b, [B, Nq, 4C]; each
    entry's term ((g0 + g1 dp_x) + g2 dp_y) + g3 dp_z, dp rounded to dy's
    dtype, one rounding a step; gathered over the reverse index; in dy's
    dtype."""
    g = reduction_grad(dy, mask, reduction)
    cloud = torch.arange(idx.shape[0])[:, None]
    c = dy.shape[-1] // 4

    def term(qi, diff):
        dp = _dp(diff, radius, dy.dtype).float()
        gq = g[cloud, qi]
        v = gq[..., :c]
        for d in range(3):
            v = v + gq[..., (d + 1) * c:(d + 2) * c] * dp[..., d:d + 1]
        return v

    return recompute_rows(q, s, idx, mask, c, term).to(dy.dtype)


@pytest.mark.parametrize("tiles", [1, 2, 3, 4])
@pytest.mark.parametrize("name", CASES)
def test_tiled_index_read_tile_after_tile_is_the_index(name, tiles):
    """K5b's and K9b's index (``csrc/row_terms.cuh``): each of a cloud's
    ``tiles`` tiles of ceil(Nq / tiles) consecutive queries indexed alone,
    an entry holding its tile-local query; a row's entries, tile after
    tile with the tile's first query added, are the queries of the row's
    entries in the whole cloud's index, in its order."""
    _, s, idx, mask, _ = _case(name)
    ns, (b, nq, k) = s.shape[1], idx.shape
    per = -(-nq // tiles)
    offsets, slots = reverse_index_plain(idx, mask, ns)
    parts = [reverse_index_plain(idx[:, q0:q0 + per], mask[:, q0:q0 + per],
                                 ns) + (q0,)
             for q0 in range(0, nq, per)]
    for cloud in range(b):
        for row in range(ns):
            tiled = [int(sl[cloud, e]) // k + q0 for off, sl, q0 in parts
                     for e in range(off[cloud, row], off[cloud, row + 1])]
            whole = slots[cloud, offsets[cloud, row]:offsets[cloud, row + 1]]
            assert tiled == (whole // k).tolist()


# K1b, K5b and K9b: (emulation, twin, JAX's Pallas op, dy channels per
# input channel, the JAX package's tolerance for its kernel's VJP; see
# tests/test_pallas_aggregation.py and tests/test_pallas_moments.py)
RECOMPUTED = {
    "xyz": (xyz_bwd_gather, aggregation.pospool_xyz_bwd_plain,
            lambda *a: jaggregation.pospool_fused(*a[:6], "xyz", a[6]),
            1, dict(rtol=1e-4, atol=1e-5)),
    "sincos": (sincos_bwd_gather, aggregation.pospool_sincos_bwd_plain,
               lambda *a: jaggregation.pospool_fused(*a[:6], "sin_cos",
                                                     a[6]),
               1, dict(rtol=1e-3, atol=5e-4)),
    "moments": (moments_bwd_gather, moments.neighborhood_moments_bwd_plain,
                jmoments.neighborhood_moments, 4,
                dict(rtol=1e-4, atol=1e-5)),
}


@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [6, 72])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("op", sorted(RECOMPUTED))
def test_recomputed_gather_equals_twin_to_the_bit(op, name, c, dtype,
                                                  reduction):
    """K1b's, K5b's and K9b's gathers, which recompute each entry's term
    from the row's own position, equal their twins (per-slot terms from the
    gathered positions, scattered by ``index_add_`` in (q, t) order) bit
    for bit, zero signs included."""
    gather, twin, _, widen, _ = RECOMPUTED[op]
    q, s, idx, mask, r = _case(name)
    rng = np.random.default_rng(100 + c)
    dy = torch.from_numpy(rng.normal(size=(2, idx.shape[1], c * widen))
                          .astype(np.float32)).to(dtype)
    args = (q, s, idx, mask, dy, r, reduction)
    got, ref = gather(*args), twin(*args)
    assert got.dtype == ref.dtype == dtype
    assert got.shape == ref.shape == (2, s.shape[1], c)
    assert torch.equal(_bits(got), _bits(ref))
    assert got.abs().max() > 0.1


@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("op", sorted(RECOMPUTED))
def test_recomputed_gather_matches_pallas_kernel(op, name, reduction,
                                                 monkeypatch):
    """Against the VJP of JAX's Pallas kernel (``_xyz_bwd_kernel`` or
    ``_sc_bwd_kernel`` through ``pospool_fused``, or
    ``neighborhood_moments``' ``_bwd_kernel``) run interpreted, f32, C =
    6, within the JAX package's tolerance for it."""
    gather, _, jop, widen, tol = RECOMPUTED[op]
    q, s, idx, mask, r = _case(name)
    c = 6
    rng = np.random.default_rng(110)
    feats = rng.normal(size=(2, s.shape[1], c)).astype(np.float32)
    dy = rng.normal(size=(2, idx.shape[1], c * widen)).astype(np.float32)
    conftest.pallas_test_mode(monkeypatch)
    _, vjp = jax.vjp(lambda f: jop(
        jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), f,
        jnp.asarray(idx.numpy()), jnp.asarray(mask.numpy()), r, reduction),
        jnp.asarray(feats))
    (ref,) = vjp(jnp.asarray(dy))
    got = gather(q, s, idx, mask, torch.from_numpy(dy), r, reduction)
    assert np.abs(np.asarray(ref)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
