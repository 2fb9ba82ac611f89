"""The CUDA ball query's pruning rule, emulated on the CPU.

``closerlook3d_tpu_torch/csrc/ball_query.cu`` packs the supports (clouds
of 97 to 2048 supports by Morton cell, others in input order), cuts them
into tiles of 32 and chunks of 32 tiles, and boxes each tile's and
chunk's valid supports. A block of consecutive queries lists the tiles
whose bound against the group's box is within r2 (or, past 96 tiles,
each query sweeps chunk and tile boxes itself); a query skips a tile
whose bound (its rounded differences to the nearer box faces, squared
and summed as ``dist2_rn`` does) exceeds the reach: r2, then the d2 of
the K-th key once K are held. Candidates are 64-bit keys, (f32 bits of
d2) << 32 | original index, buffered 128 a query and cut to the K
smallest when the buffer would overflow. A row with no in-radius
support takes slot 0 from a branch-and-bound over the chunks and tiles
(the nearest chunk's nearest tile first), and from a scan of every
support when the best valid d2 is >= 1e10 (masked supports' +1e10 bias
could tie or win); at r2 >= 1e10 nothing is pruned. The kernel runs only on the card; here
``emulate_ball_query`` repeats that algorithm step by step in numpy, and
the tests hold

* the bounds to what they bound, as f32 values compared exactly: a
  tile's never above the ``pairwise_dist2`` of any valid member, a
  chunk's never above its tiles', a group's never above any member
  query's; equal where a query is itself a member, and equal to r2 for
  some tile of the 0.25-grid clouds (a box that touches the radius);
* the emulation, at groups of 8 and of 64 queries, to
  ``ball_query_plain`` and to JAX's jnp ``ball_query``, idx and mask
  equal, on Morton-sorted shape clouds, FPS-ordered queries and supports
  (repacked), an unsorted cloud past 2048 supports (kept in input order,
  exact, and pruning less), FPS queries whose group lists over 96 tiles,
  grid ties, neighborhoods dense enough to overflow the buffer,
  grid-subsampled rooms whose padding sits at the origin (near the
  floor, or far from every point), an all-masked cloud, a cloud with
  only masked supports in reach, one whose valid supports all lie at d2
  >= 1e10 (a masked one is nearest), K > Ns, and r >= 1e5.

The CUDA kernel itself is held to ``ball_query_plain`` on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.ops.neighbors import ball_query as jball_query
from closerlook3d_tpu_torch.data.spatial_host import morton_sort_batch
from closerlook3d_tpu_torch.data.synthetic import (
    SyntheticClassification, SyntheticSceneSegmentation)
from closerlook3d_tpu_torch.ops.neighbors import (
    _r2, ball_query_plain, pairwise_dist2)
from closerlook3d_tpu_torch.ops.sampling import (
    furthest_point_sample_plain, grid_subsample)
from test_torch_operator_models import _one_aten_thread  # noqa: F401

TILE = 32       # supports per tile (a warp's lanes)
CAP = 128       # keys buffered per query
MAX_CAND = 96   # tiles a block's list holds
SORT_MAX = 2048  # clouds the one-block preparation pass takes
BIG = np.float32(1e10)
NO_KEY = (1 << 64) - 1


@pytest.fixture(autouse=True)
def _jnp_reference(monkeypatch):
    conftest.pallas_test_mode(monkeypatch, ops_impl="jnp")


# ---- the emulation ---------------------------------------------------------

def _padded(n, size):
    """n rounded up to a multiple of size."""
    return -(-n // size) * size


def boxes(xyz, valid, size):
    """[B, G, 3] lo and hi over the valid points of each run of ``size``
    positions, G rounded up to a multiple of 32; empty: +inf and -inf."""
    b, n, _ = xyz.shape
    g = _padded(-(-n // size), 32)
    pad = g * size - n
    xp = np.concatenate([xyz, np.zeros((b, pad, 3), np.float32)], 1)
    vp = np.concatenate([valid, np.zeros((b, pad), bool)], 1)
    xp = xp.reshape(b, g, size, 3)
    vp = vp.reshape(b, g, size, 1)
    return (np.where(vp, xp, np.float32(np.inf)).min(2),
            np.where(vp, xp, np.float32(-np.inf)).max(2))


def chunk_boxes(lo, hi):
    """Boxes of 32 tiles each from tile boxes, rounded up to 32 chunks."""
    b, t, _ = lo.shape
    c = _padded(t // 32, 32)
    pad = c * 32 - t
    lo = np.concatenate([lo, np.full((b, pad, 3), np.inf, np.float32)], 1)
    hi = np.concatenate([hi, np.full((b, pad, 3), -np.inf, np.float32)], 1)
    return (lo.reshape(b, c, 32, 3).min(2), hi.reshape(b, c, 32, 3).max(2))


def _sum_sq(g):
    g = g.astype(np.float32)
    sq = g * g
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def face_bounds(q, lo, hi):
    """[B, Nq, G] f32 lower bounds: per axis the rounded difference to the
    nearer face (0 inside), then ((gx*gx + gy*gy) + gz*gz), each step
    rounded to f32 as the kernel's intrinsics round it."""
    qq = q[:, :, None, :]
    lo, hi = lo[:, None], hi[:, None]
    with np.errstate(invalid="ignore"):
        return _sum_sq(np.where(qq < lo, qq - lo,
                                np.where(qq > hi, qq - hi, np.float32(0))))


def group_bounds(glo, ghi, lo, hi):
    """[G] f32 bounds for every query in the box [glo, ghi] at once: the
    difference from the group box's nearer face."""
    with np.errstate(invalid="ignore"):
        return _sum_sq(np.where(ghi < lo, ghi - lo,
                                np.where(glo > hi, glo - hi, np.float32(0))))


def biased_d2(q, s, smask):
    """The plain version's d2 with the +1e10 bias of masked supports."""
    d2 = pairwise_dist2(torch.from_numpy(q), torch.from_numpy(s))
    bias = torch.where(torch.from_numpy(smask), 0.0, 1e10).float()
    return (d2 + bias[:, None, :]).numpy()


def keys_of(d2, index):
    """(f32 bits of d2) << 32 | support index, as uint64."""
    bits = d2.view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | index.astype(np.uint64)


def key_d2(key) -> float:
    return float(np.array([int(key) >> 32], np.uint32).view(np.float32)[0])


def _spread4(x):
    x = x & 0xF
    x = (x | (x << 4)) & 0x0C3
    return (x | (x << 2)) & 0x249


def pack_order(s, smask, seed=0):
    """[B, Ns] original index at each packed position: clouds of 97 to
    2048 supports are packed by Morton cell (16 an axis over the valid
    box, masked supports last), in a random order within a cell (the
    kernel's follows atomics); other clouds keep their order."""
    b, ns, _ = s.shape
    perm = np.tile(np.arange(ns), (b, 1))
    if not 3 * TILE < ns <= SORT_MAX:
        return perm
    rng = np.random.default_rng(seed)
    for i in range(b):
        v = s[i][smask[i]]
        cmin = v.min(0) if v.size else np.zeros(3, np.float32)
        ext = (v.max(0) - cmin).max() if v.size else np.float32(-np.inf)
        scale = np.float32(16) / np.maximum(ext, np.float32(1e-9))
        cell = np.minimum((s[i] - cmin) * scale, np.float32(15))
        cell = np.maximum(cell, 0).astype(np.int64)
        code = (_spread4(cell[:, 0]) | (_spread4(cell[:, 1]) << 1)
                | (_spread4(cell[:, 2]) << 2))
        code = np.where(smask[i], code, 4096)
        shuffle = rng.permutation(ns)
        perm[i] = shuffle[np.argsort(code[shuffle], kind="stable")]
    return perm


class _Row:
    """One query's running candidates, as a warp holds them."""

    def __init__(self, keys, d2, ns, k, r2):
        self.keys, self.d2, self.ns, self.k, self.r2 = keys, d2, ns, k, r2
        self.buf, self.kth, self.reach = [], NO_KEY, r2

    def scan_tile(self, t):
        sl = slice(t * TILE, min(self.ns, (t + 1) * TILE))
        keys = self.keys[sl]
        hits = keys[(self.d2[sl] <= self.r2)
                    & (keys < np.uint64(self.kth))].tolist()
        if not hits:
            return
        if len(self.buf) + len(hits) > CAP:
            self.buf = sorted(self.buf)[:self.k]
            self.kth = self.buf[-1]
            self.reach = key_d2(self.kth)
            hits = [x for x in hits if x < self.kth]
        self.buf += hits

    def scan_set(self, tiles, bounds):
        """Tiles in lane order, each if its bound is within the reach as
        it stands then (a NaN bound never is)."""
        for t, bound in zip(tiles, bounds):
            if bound <= self.reach:
                self.scan_tile(t)


def _nearest(keys, valid, cb, tb, ns):
    """Slot 0 of a row with no in-radius key: the nearest chunk's nearest
    tile, then every chunk and tile whose bound is <= the best d2 so far,
    over valid supports; every support if the best is >= 1e10."""
    def tile_min(t):
        sl = slice(t * TILE, min(ns, (t + 1) * TILE))
        ks = keys[sl][valid[sl]]
        return int(ks.min()) if ks.size else NO_KEY

    best = NO_KEY
    if np.isfinite(cb).any():
        c0 = int(np.argmin(cb))  # the first of the smallest bounds
        t0 = c0 * 32 + int(np.argmin(tb[c0 * 32:(c0 + 1) * 32]))
        best = tile_min(t0)
        for c in range(cb.shape[0]):
            if cb[c] <= key_d2(best):
                for t in range(c * 32, (c + 1) * 32):
                    if tb[t] <= key_d2(best):
                        best = min(best, tile_min(t))
    if best == NO_KEY or key_d2(best) >= BIG:
        best = int(keys[:ns].min())
    return best & 0xFFFFFFFF


def emulate_ball_query(q, s, radius, k, qmask, smask, group=8):
    """The CUDA kernel's algorithm on numpy clouds, ``group`` consecutive
    queries a block: (idx, mask) numpy."""
    b, nq, _ = q.shape
    ns = s.shape[1]
    r2 = _r2(radius)
    prune = r2 < BIG
    perm = pack_order(s, smask)
    sp = np.take_along_axis(s, perm[..., None], 1)
    vp = np.take_along_axis(smask, perm, 1)
    tlo, thi = boxes(sp, vp, TILE)
    clo, chi = chunk_boxes(tlo, thi)
    tb_all = face_bounds(q, tlo, thi)
    cb_all = face_bounds(q, clo, chi)
    d2 = np.take_along_axis(biased_d2(q, s, smask), perm[:, None, :], 2)
    keys = keys_of(d2, perm[:, None, :])
    ntiles, nchunks = -(-ns // TILE), tlo.shape[1] // 32
    idx = np.zeros((b, nq, k), np.int32)
    valid = np.zeros((b, nq, k), bool)
    for bi in range(b):
        for q0 in range(0, nq, group):
            rows = range(q0, min(nq, q0 + group))
            glo, ghi = q[bi, rows].min(0), q[bi, rows].max(0)
            listed = None
            if prune:
                gb = group_bounds(glo, ghi, tlo[bi], thi[bi])
                listed = np.nonzero(gb <= r2)[0]
                listed = None if listed.size > MAX_CAND else listed
            for qi in rows:
                tb, cb = tb_all[bi, qi], cb_all[bi, qi]
                row = _Row(keys[bi, qi], d2[bi, qi], ns, k, r2)
                if listed is not None:
                    for i in range(0, listed.size, 32):
                        row.scan_set(listed[i:i + 32], tb[listed[i:i + 32]])
                else:
                    for c in range(cb.shape[0]):
                        if (cb[c] <= row.reach if prune else c < nchunks):
                            tiles = range(c * 32, (c + 1) * 32)
                            row.scan_set(tiles, [
                                tb[t] if prune else
                                (0.0 if t < ntiles else np.nan)
                                for t in tiles])
                kept = sorted(row.buf)[:k]
                first = (kept[0] & 0xFFFFFFFF if kept else
                         _nearest(keys[bi, qi], vp[bi], cb, tb, ns))
                slot_valid = np.array([
                    s_ < len(kept) or (s_ >= ns and BIG <= r2)
                    for s_ in range(k)])
                idx[bi, qi] = [kept[s_] & 0xFFFFFFFF if s_ < len(kept)
                               else first for s_ in range(k)]
                valid[bi, qi] = slot_valid & qmask[bi, qi]
    return idx, valid


# ---- clouds ----------------------------------------------------------------

def _shapes(n, b=2, seed=3):
    ds = SyntheticClassification(b, n, num_classes=8, seed=seed)
    xyz = np.stack([ds[i]["xyz"] for i in range(b)]).astype(np.float32)
    return morton_sort_batch({"xyz": xyz, "mask": np.ones((b, n), bool)})


def _room(n, shift=0.0, b=2, seed=5):
    """Morton-sorted synthetic rooms, the second padded to 70%."""
    ds = SyntheticSceneSegmentation(b, n, seed=seed)
    xyz = np.stack([ds[i]["xyz"] for i in range(b)]).astype(np.float32)
    xyz[..., 0] += np.float32(shift)
    mask = np.ones((b, n), bool)
    mask[1, n * 7 // 10:] = False
    return morton_sort_batch({"xyz": xyz, "mask": mask})


def _grid(n, b=2, seed=9):
    """Morton-sorted points on a 0.25 grid: duplicates, exact ties, and
    neighbors at exactly the radius."""
    rng = np.random.default_rng(seed)
    xyz = rng.integers(-4, 5, size=(b, n, 3)).astype(np.float32) * 0.25
    xyz[:, 20:40] = xyz[:, :20]
    return morton_sort_batch({"xyz": xyz, "mask": np.ones((b, n), bool)})


def _fps(xyz, mask, npoint):
    idx, m = furthest_point_sample_plain(torch.from_numpy(xyz), npoint,
                                         torch.from_numpy(mask))
    pick = np.take_along_axis(xyz, idx.long().numpy()[..., None], 1)
    return np.ascontiguousarray(pick), m.numpy()


def _subsample(xyz, mask, cell, budget):
    gx, gm = grid_subsample(torch.from_numpy(xyz), cell, budget,
                            torch.from_numpy(mask))
    return gx.numpy(), gm.numpy()


def case(name):
    """(q, qmask, s, smask, radius, k) of a named case."""
    if name in ("morton", "fps_queries", "fps_supports", "unsorted"):
        c = _shapes(600)
        s, sm = c["xyz"], c["mask"]
        if name == "morton":
            return s, sm, s, sm, 0.1, 26
        q, qm = _fps(s, sm, 150)
        if name == "fps_queries":
            return q, qm, s, sm, 0.2, 26
        if name == "fps_supports":
            return q, qm, q, qm, 0.2, 31
        # beyond the one-block pass, packed in its (random) input order
        c = _shapes(3000)
        perm = np.random.default_rng(1).permutation(3000)
        return q, qm, c["xyz"][:, perm], c["mask"][:, perm], 0.2, 26
    if name == "list_overflow":  # 64 FPS picks span > 96 tiles
        c = _shapes(4000)
        q, qm = _fps(c["xyz"], c["mask"], 128)
        return q, qm, c["xyz"], c["mask"], 0.1, 16
    if name == "grid_ties":
        c = _grid(400)
        return c["xyz"], c["mask"], c["xyz"], c["mask"], 0.5, 16
    if name == "dense_overflow":  # > 128 keys in radius: cuts at 128
        c = _grid(500)
        return c["xyz"], c["mask"], c["xyz"], c["mask"], 1.0, 64
    if name in ("room_origin", "room_far_origin"):
        # grid-subsampled queries padded at the origin: on the floor, or
        # (shifted room) far from every point: the nearest pass
        c = _room(900, shift=0.0 if name == "room_origin" else 6.0)
        q, qm = _subsample(c["xyz"], c["mask"], 0.4, 300)
        assert not qm.all() and (q[~qm] == 0).all()
        return q, qm, c["xyz"], c["mask"], 0.3, 26
    if name == "room_subsampled":
        c = _room(900, shift=6.0)
        q, qm = _subsample(c["xyz"], c["mask"], 0.4, 300)
        return q, qm, q, qm, 0.5, 31
    if name in ("all_masked", "masked_in_reach"):
        c = _shapes(300)
        s, sm = c["xyz"], c["mask"].copy()
        if name == "all_masked":
            sm[1] = False
        else:  # every support near cloud 0's first 40 queries is masked
            near = ((s[0, :, None] - s[0, None, :40]) ** 2).sum(-1).min(1)
            sm[0] = near > 0.3 ** 2
        return s, c["mask"], s, sm, 0.1, 16
    if name == "far_valid":
        # the valid supports sit 2e5 away (d2 >= 1e10) and the near ones
        # are masked: a masked support's biased d2 (rounded to 1e10) wins
        c = _shapes(300)
        s, sm = c["xyz"].copy(), c["mask"].copy()
        sm[:, :150] = False
        s[:, 150:, 0] += np.float32(2e5)
        return c["xyz"], c["mask"], s, sm, 0.1, 16
    if name == "k_gt_ns":
        c = _shapes(300)
        sm = c["mask"][:, :5].copy()
        sm[0, 3] = False
        return c["xyz"], c["mask"], c["xyz"][:, :5].copy(), sm, 0.8, 12
    if name in ("huge_radius", "huge_radius_k_gt_ns"):
        # masked supports (every other one) are in radius at r2 >= 1e10
        c = _room(64, shift=6.0)
        s, qm = c["xyz"], c["mask"]
        sm = qm.copy()
        sm[:, ::2] = False
        if name == "huge_radius":
            return s, qm, s, sm, 1e5, 40
        return s, qm, s[:, :9].copy(), sm[:, :9].copy(), 2e5, 12
    raise ValueError(name)


CASES = ["morton", "fps_queries", "fps_supports", "unsorted",
         "list_overflow", "grid_ties", "dense_overflow", "room_origin",
         "room_far_origin", "room_subsampled", "all_masked",
         "masked_in_reach", "far_valid", "k_gt_ns", "huge_radius",
         "huge_radius_k_gt_ns"]


def packed(q, s, sm):
    """The packed cloud's tile and chunk boxes, each query's bounds to
    them, and the biased d2 in packed order."""
    perm = pack_order(s, sm)
    sp = np.take_along_axis(s, perm[..., None], 1)
    vp = np.take_along_axis(sm, perm, 1)
    tlo, thi = boxes(sp, vp, TILE)
    clo, chi = chunk_boxes(tlo, thi)
    d2 = np.take_along_axis(biased_d2(q, s, sm), perm[:, None, :], 2)
    return (perm, vp, tlo, thi, face_bounds(q, tlo, thi),
            face_bounds(q, clo, chi), d2)


# ---- tests -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["morton", "fps_queries", "fps_supports",
                                  "unsorted", "grid_ties", "room_origin",
                                  "room_far_origin", "masked_in_reach"])
def test_bounds_never_exceed_a_member(name):
    """Tile bound <= the d2 of every valid member, chunk bound <= its
    tiles' bounds, group bound <= each member query's tile bound, all as
    f32 values compared exactly."""
    q, _, s, sm, radius, _ = case(name)
    _, vp, tlo, thi, tb, cb, d2 = packed(q, s, sm)
    b, nq, ns = d2.shape
    ntp = tb.shape[-1]
    pad = ntp * TILE - ns
    mp = np.concatenate([vp, np.zeros((b, pad), bool)], 1)
    d2p = np.concatenate([d2, np.full((b, nq, pad), np.inf, np.float32)], -1)
    member = np.where(mp[:, None], d2p, np.float32(np.inf)).reshape(
        b, nq, ntp, TILE)
    low = member.min(-1)  # the tile's smallest valid d2 (inf: none)
    assert (tb <= low).all()
    assert np.isinf(tb[np.isinf(low)]).all()  # empty tiles never match
    tiles_of_chunk = tb.reshape(b, nq, -1, 32).min(-1)
    assert (cb[..., :tiles_of_chunk.shape[-1]] <= tiles_of_chunk).all()
    for group in (8, 64):
        for bi in range(b):
            for q0 in range(0, nq, group):
                g = q[bi, q0:q0 + group]
                gb = group_bounds(g.min(0), g.max(0), tlo[bi], thi[bi])
                assert (gb <= tb[bi, q0:q0 + group]).all()
    if not name.startswith("room"):
        # tight where the query is itself a member (bound and d2 both 0)
        assert (tb == low).any()
    if name == "grid_ties":
        # some box touches the radius exactly, and is kept
        assert (tb == np.float32(_r2(radius))).any()


@pytest.mark.parametrize("group", [8, 64])
@pytest.mark.parametrize("name", CASES)
def test_emulation_equals_plain_and_jnp(name, group):
    q, qm, s, sm, radius, k = case(name)
    ei, em = emulate_ball_query(q, s, radius, k, qm, sm, group)
    pi, pm = ball_query_plain(torch.from_numpy(q), torch.from_numpy(s),
                              radius, k, torch.from_numpy(qm),
                              torch.from_numpy(sm))
    ji, jm = jball_query(jnp.asarray(q), jnp.asarray(s), radius, k,
                         query_mask=jnp.asarray(qm),
                         support_mask=jnp.asarray(sm))
    np.testing.assert_array_equal(ei, pi.numpy())
    np.testing.assert_array_equal(em, pm.numpy())
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


def test_cases_reach_every_branch():
    """The cases above take the paths they are named for: rows with no
    in-radius support (the nearest pass, and its full scan), buffer cuts,
    no pruning at r >= 1e5, a repacked cloud of FPS picks and clouds
    kept in input order, a list over 96 tiles, a group of padding rows
    at the origin, and
    pruning that skips most tiles on sorted clouds but fewer on unsorted
    ones."""
    def stats(name):
        q, qm, s, sm, radius, k = case(name)
        perm, _, _, _, tb, _, d2 = packed(q, s, sm)
        r2 = _r2(radius)
        return (d2 <= r2).sum(-1), (tb <= r2).mean(), perm, q, sm

    inr = stats("dense_overflow")[0]
    assert inr.max() > CAP
    inr = stats("room_far_origin")[0]
    assert (inr == 0).any()
    inr, _, _, _, sm = stats("all_masked")
    assert (inr[1] == 0).all() and not sm[1].any()
    inr = stats("masked_in_reach")[0]
    assert (inr[0, :40] == 0).all()
    q, _, s, sm, _, _ = case("far_valid")
    assert (biased_d2(q, s, sm)[:, :, 150:] >= BIG).all()
    assert _r2(case("huge_radius")[4]) >= BIG
    perm = stats("fps_supports")[2]
    assert (perm != np.arange(perm.shape[1])).any()  # repacked
    assert (stats("unsorted")[2] == np.arange(3000)).all()  # kept
    assert (stats("k_gt_ns")[2] == np.arange(5)).all()  # kept
    q, _, s, sm, radius, _ = case("list_overflow")
    _, _, tlo, thi, _, _, _ = packed(q, s, sm)
    g = q[0, :64]
    gb = group_bounds(g.min(0), g.max(0), tlo[0], thi[0])
    assert (gb <= _r2(radius)).sum() > MAX_CAND
    q = case("room_origin")[0]
    assert (q[:, -8:] == 0).all()  # a group of 8 padding rows
    assert stats("fps_queries")[1] < 0.5 * stats("unsorted")[1]
