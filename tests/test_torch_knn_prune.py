"""The decoder's 1-NN as the CUDA kernel computes it, emulated on the CPU.

``closerlook3d_tpu_torch/csrc/knn.cu`` takes k = 1 over ``PRUNE_MIN``
supports or more (S3DIS's 4096 and 1152 grid points) through the ball
query's preparation and nearest search (``csrc/support_tiles.cuh``): the
supports packed in input order (the decoder's are grid_subsample's, in
Morton order), tiles of 32 and chunks of 32 tiles boxed over their valid
supports, then for each query (a warp, queries in input order) the
nearest chunk's nearest tile first, every chunk and tile whose bound is
<= the best d2 so far next, the smallest 64-bit key (f32 bits of d2) <<
32 | index winning, and a scan of every support where the best is >=
1e10 (masked supports, biased by +1e10, tie there; a cloud with no valid
support). Below ``PRUNE_MIN`` supports, and for k > 1, it keeps its
all-pairs kernels. ``emulate_knn1`` repeats the pruned search in numpy
with ``tests/test_torch_ball_query.py``'s boxes, bounds and keys (its
``_nearest`` gives the same index), and records which tiles each
query scans. The tests hold

* the emulation at every support count (the plan is exact at any Ns,
  pruned or not) to ``knn_plain`` bit for bit (indices and d2) and to the
  JAX package's jnp ``knn`` (indices equal, d2 within 2 ulp: XLA's CPU
  code may contract a square and its sum), on Morton-sorted rooms with
  masked padding, voxel-ordered (``grid_subsample``) and FPS-ordered
  supports, 0.25-grid clouds whose duplicated points tie across tiles, an
  all-masked cloud, a cloud whose only valid supports lie 2e5 away (a
  masked support is nearest), and Ns of 1, 96, 97, ``PRUNE_MIN`` - 1,
  ``PRUNE_MIN`` and 4096;
* every skipped tile to hold no key below the winner (the pruning drops
  nothing the plain version keeps), and the sorted rooms to prune most
  tiles;
* the emulation against the JAX package's Pallas 1-NN run interpreted at
  ``PRUNE_MIN`` supports (clouds with valid supports: it moves masked
  supports to 1e6 coordinates where the jnp path adds 1e10);
* the route (``route``: pruned from ``PRUNE_MIN`` supports at k = 1, 2
  device ops; else 1) and ``PRUNE_MIN`` itself read from ``knn.cu``.

The CUDA kernel itself is held to ``knn_plain`` on the card at every Ns
from 1 to 16384 by ``tests/test_torch_cuda.py`` and at every upsample
call by ``chip_smoke.py``.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.ops.neighbors import knn as jknn
from closerlook3d_tpu.ops.pallas.neighbors import knn1_pallas_chunked
from closerlook3d_tpu_torch.ops.neighbors import (
    KNN1_CHUNKED_MIN_SUPPORT, knn_plain)
from test_torch_ball_query import (
    BIG, NO_KEY, TILE, _fps, _grid, _nearest, _room, _shapes, _subsample,
    biased_d2, boxes, chunk_boxes, face_bounds, key_d2, keys_of)
from test_torch_operator_models import _one_aten_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNN_CU = os.path.join(REPO, "closerlook3d_tpu_torch", "csrc", "knn.cu")


def _constant(name: str) -> int:
    with open(KNN_CU) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


PRUNE_MIN = _constant("kPruneMinSupport")


@pytest.fixture(autouse=True)
def _jnp_reference(monkeypatch):
    conftest.pallas_test_mode(monkeypatch, ops_impl="jnp")


# ---- the emulation ---------------------------------------------------------

def route(ns: int, k: int):
    """(kernel, device ops a call) that ``cl3d_knn`` takes."""
    if k == 1 and ns >= PRUNE_MIN:
        return "knn1_pruned", 2
    return ("knn1" if k == 1 else "knn"), 1


def _nearest_key(keys, valid, cb, tb, ns, scanned):
    """``nearest_key``: the smallest key over every support, by the
    search of the module's note; the tiles it scans go to ``scanned``."""
    def tile_min(t):
        scanned.add(t)
        sl = slice(t * TILE, min(ns, (t + 1) * TILE))
        ks = keys[sl][valid[sl]]
        return int(ks.min()) if ks.size else NO_KEY

    best = NO_KEY
    if np.isfinite(cb).any():
        # the nearest chunk box, then its nearest tile box (first lowest)
        c0 = int(np.argmin(cb))
        t0 = c0 * 32 + int(np.argmin(tb[c0 * 32:(c0 + 1) * 32]))
        best = tile_min(t0)
        for c in range(cb.shape[0]):  # chunks, then their tiles, in order
            if cb[c] <= key_d2(best):
                for t in range(c * 32, (c + 1) * 32):
                    if t != t0 and tb[t] <= key_d2(best):
                        best = min(best, tile_min(t))
    if best == NO_KEY or key_d2(best) >= BIG:
        scanned.update(range(-(-ns // TILE)))
        best = int(keys[:ns].min())
    return best


def emulate_knn1(q, s, smask):
    """The pruned 1-NN on numpy clouds: (idx [B, Nq, 1] int32, d2 [B, Nq,
    1] f32, scanned tiles per (cloud, query), tiles per cloud)."""
    b, nq, _ = q.shape
    ns = s.shape[1]
    perm = np.tile(np.arange(ns), (b, 1))  # supports kept in input order
    sp = np.take_along_axis(s, perm[..., None], 1)
    vp = np.take_along_axis(smask, perm, 1)
    tlo, thi = boxes(sp, vp, TILE)
    clo, chi = chunk_boxes(tlo, thi)
    tb_all = face_bounds(q, tlo, thi)
    cb_all = face_bounds(q, clo, chi)
    d2 = np.take_along_axis(biased_d2(q, s, smask), perm[:, None, :], 2)
    keys = keys_of(d2, perm[:, None, :])
    idx = np.zeros((b, nq, 1), np.int32)
    dist = np.zeros((b, nq, 1), np.float32)
    scans = np.zeros((b, nq), np.int64)
    for bi in range(b):
        for qi in range(nq):
            scanned = set()
            tb, cb = tb_all[bi, qi], cb_all[bi, qi]
            key = _nearest_key(keys[bi, qi], vp[bi], cb, tb, ns, scanned)
            idx[bi, qi, 0] = key & 0xFFFFFFFF
            dist[bi, qi, 0] = key_d2(key)
            # the ball query's nearest pass picks the same support
            assert _nearest(keys[bi, qi], vp[bi], cb, tb, ns) == key & (
                0xFFFFFFFF)
            # no skipped tile holds a valid key below the winner
            for t in set(range(-(-ns // TILE))) - scanned:
                sl = slice(t * TILE, min(ns, (t + 1) * TILE))
                ks = keys[bi, qi, sl][vp[bi, sl]]
                assert not ks.size or int(ks.min()) > key
            scans[bi, qi] = len(scanned)
    return idx, dist, scans, -(-ns // TILE)


# ---- clouds ----------------------------------------------------------------

def _cloud(n, b=3, seed=11, masked_frac=0.2, grid=False):
    """Uniform (or 0.25-grid) points, a fifth of the supports masked,
    the last cloud all masked."""
    rng = np.random.default_rng(seed)
    if grid:
        xyz = rng.integers(-4, 5, size=(b, n, 3)).astype(np.float32) * 0.25
    else:
        xyz = rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32)
    mask = rng.random((b, n)) >= masked_frac
    mask[-1] = False
    return xyz, mask


def case(name):
    """(q, s, smask) of a named case."""
    if name == "room_morton":  # Morton-sorted, the second padded to 70%
        r = _room(4096, b=2)
        q = _room(6000, b=2, seed=6)
        return q["xyz"][:, ::25], r["xyz"], r["mask"]
    if name == "room_voxels":  # grid_subsample's budgets and voxel order
        r = _room(6000, b=2)
        s, sm = _subsample(r["xyz"], r["mask"], 0.08, PRUNE_MIN + 128)
        q, _ = _subsample(r["xyz"], r["mask"], 0.16, 300)
        return q, s, sm
    if name == "fps_supports":  # FPS picks: repacked by Morton cell
        c = _shapes(2000)
        s, sm = _fps(c["xyz"], c["mask"], 1200)
        return c["xyz"][:, ::10], s, sm
    if name == "grid_ties":  # duplicated points tie across tiles
        g = _grid(1500)
        s, sm = g["xyz"].copy(), g["mask"].copy()
        s[:, 1000:1200] = s[:, 0:200]
        return g["xyz"][:, ::15], s, sm
    if name == "all_masked_far":  # an all-masked cloud, one whose
        # nearest support is masked, and a plain one
        s, sm = _cloud(PRUNE_MIN, b=3, seed=12)
        sm[0] = False  # cloud 0 all masked too
        sm[1, :] = False
        sm[1, -5:] = True
        s[1, -5:] += np.float32(2e5)  # its valid supports 2e5 away
        sm[2] = np.random.default_rng(19).random(PRUNE_MIN) >= 0.2
        q, _ = _cloud(60, b=3, seed=13)
        return q, s, sm
    n = int(name.split("_")[1])  # "ns_<n>": uniform clouds of n supports
    s, sm = _cloud(n, seed=14 + n)
    q, _ = _cloud(80, seed=15)
    return q, s, sm


SIZES = [1, 96, 97, PRUNE_MIN - 1, PRUNE_MIN, 4096]
CASES = (["room_morton", "room_voxels", "fps_supports", "grid_ties",
          "all_masked_far"] + [f"ns_{n}" for n in SIZES])


@pytest.mark.parametrize("name", CASES)
def test_emulation_equals_plain_and_jnp(name):
    q, s, sm = case(name)
    idx, d2, scans, ntiles = emulate_knn1(q, s, sm)
    pi, pd = knn_plain(torch.from_numpy(q), torch.from_numpy(s), 1,
                       torch.from_numpy(sm))
    np.testing.assert_array_equal(idx, pi.numpy())
    np.testing.assert_array_equal(d2.view(np.int32), pd.numpy().view(np.int32))
    ji, jd = jknn(q, s, 1, support_mask=sm)
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_allclose(d2, np.asarray(jd), rtol=2.4e-7, atol=0)
    assert scans.max() <= ntiles


def test_sorted_rooms_prune_most_tiles():
    """On S3DIS-like Morton-sorted rooms a query scans a few of the 128
    tiles (its own and its neighbours'); the all-masked cloud and the one
    whose nearest support is masked scan every tile."""
    q, s, sm = case("room_morton")
    _, _, scans, ntiles = emulate_knn1(q, s, sm)
    assert ntiles == 128 and np.median(scans) <= 8, np.median(scans)
    q, s, sm = case("all_masked_far")
    idx, d2, scans, ntiles = emulate_knn1(q, s, sm)
    assert (scans[:2] == ntiles).all() and (d2[:2] >= BIG).all()
    assert (d2[2] < BIG).all() and (scans[2] < ntiles).any()


def test_emulation_matches_the_pallas_1nn():
    """The JAX package's chunked 1-NN (K11), interpreted, at ``PRUNE_MIN``
    supports on clouds that have valid supports: the same index and d2."""
    s, sm = _cloud(PRUNE_MIN, b=2, seed=16)
    sm[1] = np.random.default_rng(17).random(PRUNE_MIN) > 0.4
    q, _ = _cloud(100, b=2, seed=18)
    ref_idx, ref_d2 = knn1_pallas_chunked(q, s, support_mask=sm)
    idx, d2, _, _ = emulate_knn1(q, s, sm)
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    np.testing.assert_allclose(d2, np.asarray(ref_d2), rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("ns,k,want", [
    (PRUNE_MIN - 1, 1, ("knn1", 1)), (PRUNE_MIN, 1, ("knn1_pruned", 2)),
    (4096, 1, ("knn1_pruned", 2)), (4096, 3, ("knn", 1)), (1, 1, ("knn1", 1))])
def test_route_by_support_count(ns, k, want):
    assert route(ns, k) == want


def test_prune_threshold_is_the_k11_route():
    """The 1-NN prunes exactly where the JAX package routes k = 1 to its
    chunked 1-NN (K11), so the K11 route runs 2 device ops a call and the
    K12 route 1 (the threshold the card measured, ``PERF.md``)."""
    assert PRUNE_MIN == KNN1_CHUNKED_MIN_SUPPORT
    with open(KNN_CU) as f:
        src = f.read()
    assert "k == 1 && ns >= kPruneMinSupport" in src


def test_layout_variants_still_apply():
    """``tools/variants/knn_layout.json`` (the 1-NN with clouds of 97-2048
    supports repacked by Morton cell, 1 or 8 queries a warp): each edit
    finds its text in its source under ``csrc/`` once."""
    with open(os.path.join(REPO, "tools", "variants",
                           "knn_layout.json")) as f:
        variants = json.load(f)
    assert variants["base"] == {}
    for edits in variants.values():
        for fn, pairs in edits.items():
            with open(os.path.join(os.path.dirname(KNN_CU), fn)) as f:
                src = f.read()
            for old, new in pairs:
                assert src.count(old) == 1, old
                src = src.replace(old, new)


def test_threshold_variants_still_apply():
    """``tools/variants/knn_prune.json`` (the 1-NN pruned from other
    support counts, for ``tools/time_variants.py``): each variant's edit
    finds ``PRUNE_MIN`` in ``knn.cu`` once and sets the count its name
    gives."""
    with open(os.path.join(REPO, "tools", "variants", "knn_prune.json")) as f:
        spec = json.load(f)
    with open(KNN_CU) as f:
        src = f.read()
    assert spec[f"p{PRUNE_MIN}"] == {}
    for name, edits in spec.items():
        text = src
        for old, new in edits.get("knn.cu", []):
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        assert f"constexpr int kPruneMinSupport = {name[1:]};" in text
