"""Furthest point sampling's CUDA design (``csrc/fps.cu``), mirrored in
numpy on the CPU.

The kernel cannot run here, so ``fps_mirror`` replays its arithmetic and
its reductions step for step: the launch plan (``plan_for``: points a
thread, threads a CTA), each thread's PPT consecutive
points, the pruning test against each thread's bounding box (each step
rounded as the distances are), each warp's max of the order-preserving
uint32 key and its first lane, the slots of the warps of every CTA and the
max over them. The mirror checks at every pick that a warp it lets skip
would not have changed, and is held to ``furthest_point_sample_plain`` and
to the JAX package's jnp ``furthest_point_sample``: the picks and the
sample mask equal, on clouds with duplicated points (exact ties), masked
points, an all-masked cloud, npoint > nvalid, N off the warp, 1, 2 and 4
CTAs a cloud (the kernel takes one; ``tools/variants/fps_cluster.json``
rebuilds it over the 2 or 4 CTAs of a cluster) and several splits over
warps. The kernel itself, and its launch plan against the plans held
here, are tested on the card by ``tests/test_torch_cuda.py``; it is held
to the plain version there and by ``chip_smoke.py``.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from closerlook3d_tpu.ops.sampling import furthest_point_sample as jfps
from closerlook3d_tpu_torch.data.spatial_host import morton_sort_batch
from closerlook3d_tpu_torch.ops.sampling import furthest_point_sample_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FPS_CU = os.path.join(REPO, "closerlook3d_tpu_torch", "csrc", "fps.cu")
# csrc/fps.cu's constants
MAX_THREADS, WARP_POINTS, MIN_PPT, PRUNE_WARPS = 1024, 128, 8, 16


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    """The port's CPU math on one ATen thread, as the other port tests
    run it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def plan_for(n, cs, min_ppt=MIN_PPT):
    """``plan_for`` of the kernel's host code at cs = 1, and of the cluster
    variant's at 2 and 4: (points a CTA, points a thread, threads a
    CTA)."""
    per = -(-n // cs)
    ppt = 1
    if cs == 1 and per <= WARP_POINTS:
        while 32 * ppt < per:
            ppt *= 2
        return per, ppt, 32
    ppt = min_ppt
    while ppt * (MAX_THREADS // cs) < per:
        ppt *= 2
    return per, ppt, -(-per // (32 * ppt)) * 32


def order_key(v):
    """Sign-clear floats above 0x80000000 in their order, negative ones
    below it in reverse order."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def dist2(px, py, pz, s):
    """((dx^2 + dy^2) + dz^2), every step rounded to f32, d = p - s."""
    dx, dy, dz = px - s[0], py - s[1], pz - s[2]
    return (dx * dx + dy * dy) + dz * dz


def gap(s, lo, hi):
    """The distance from s to [lo, hi] along an axis, rounded as a
    point's difference is: max(lo - s, s - hi, 0)."""
    return np.maximum(np.maximum(lo - s, s - hi), np.float32(0))


def fps_mirror(xyz, mask, npoint, cs=1, min_ppt=MIN_PPT,
               prune_warps=PRUNE_WARPS, stats=None):
    """One cloud ([N, 3] f32, [N] bool) through the kernel's algorithm:
    (picks [npoint] int32, sample mask [npoint] bool). ``stats`` (a dict)
    collects the warps' skips."""
    n = len(xyz)
    per, ppt, threads = plan_for(n, cs, min_ppt)
    nw = threads // 32
    local = (np.arange(threads)[:, None] * ppt + np.arange(ppt))[None]
    index = np.arange(cs)[:, None, None] * per + local  # [cs, T, PPT]
    mine = (local < per) & (index < n)
    at = np.where(mine, index, 0)
    px, py, pz = (np.where(mine, xyz[at, d], np.float32(0))
                  for d in range(3))
    md = np.where(mine, np.where(mask[at], np.float32(1e10),
                                 np.float32(-1)), np.float32(-np.inf))
    box = [(np.where(mine, c, np.inf).min(-1).astype(np.float32),
            np.where(mine, c, -np.inf).max(-1).astype(np.float32))
           for c in (px, py, pz)]
    valid = np.flatnonzero(mask)
    cur = int(valid[0]) if len(valid) else 0
    s = xyz[cur]
    bv = np.full((cs, threads), np.inf, np.float32)
    bi = np.zeros((cs, threads), np.int64)
    wkey = np.zeros((cs, nw), np.uint32)
    wlane = np.zeros((cs, nw), np.int64)
    prune = nw >= prune_warps
    out = np.zeros(npoint, np.int32)
    for it in range(npoint):
        out[it] = cur
        if it + 1 == npoint:
            break
        new = np.minimum(md, dist2(px, py, pz, s))
        skip = np.zeros((cs, nw), bool)
        if prune:
            g = [gap(s[d], *box[d]) for d in range(3)]
            bound = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]
            skip = (bound >= bv).reshape(cs, nw, 32).all(-1)
            lanes = np.repeat(skip, 32, axis=1)
            # a skipped warp's points would not have changed
            assert np.array_equal(new[lanes].view(np.uint32),
                                  md[lanes].view(np.uint32))
            if stats is not None:
                stats["skipped"] = stats.get("skipped", 0) + int(skip.sum())
                stats["warps"] = stats.get("warps", 0) + skip.size
        upd = ~np.repeat(skip, 32, axis=1)
        md = np.where(upd[..., None], new, md)
        best = md.max(-1)
        first = np.argmax(md == best[..., None], axis=-1)  # the first holder
        bv = np.where(upd, best, bv)
        bi = np.where(upd, first, bi)
        key = order_key(bv).reshape(cs, nw, 32)
        k = key.max(-1)
        lane = np.argmax(key == k[..., None], axis=-1)
        wkey = np.where(skip, wkey, k)
        wlane = np.where(skip, wlane, lane)
        # the slots, in (CTA, warp) order: at most 32 (one warp alone
        # skips them in the kernel, with the same pick)
        slot_key = wkey.reshape(-1)
        assert len(slot_key) <= 32
        r, w = divmod(int(np.argmax(slot_key == slot_key.max())), nw)
        t = w * 32 + int(wlane[r, w])
        cur = int(index[r, t, bi[r, t]])
        s = np.array([px[r, t, bi[r, t]], py[r, t, bi[r, t]],
                      pz[r, t, bi[r, t]]], np.float32)
    return out, np.arange(npoint) < len(valid)


def _cloud(case):
    """(xyz [B, N, 3] f32, mask [B, N] bool, npoint) of a named case, two
    or three clouds Morton-sorted as the loader sorts them: "grid" (points
    on a 0.25 grid, the first eighth duplicated: exact ties), "masked" (a
    third of the points masked, cloud 1 all masked), "sparse" (4 valid
    points of 300, npoint > nvalid), "small" (33 points, npoint 40),
    "tiny" (1 point), "shape" (1000 points of a sphere's surface)."""
    rng = np.random.default_rng(["grid", "masked", "sparse", "small", "tiny",
                                 "shape"].index(case) + 30)
    b, n, npoint = {"grid": (2, 300, 120), "masked": (3, 777, 200),
                    "sparse": (2, 300, 16), "small": (2, 33, 40),
                    "tiny": (2, 1, 3), "shape": (2, 1000, 250)}[case]
    xyz = rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32)
    if case == "grid":
        xyz = np.round(xyz * 4) / 4
        xyz[:, n // 8:n // 4] = xyz[:, :n // 4 - n // 8]
    if case == "shape":
        xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    mask = np.ones((b, n), bool)
    if case == "masked":
        mask = rng.random((b, n)) > 0.33
        mask[1] = False
    if case == "sparse":
        mask[:] = False
        mask[:, rng.choice(n, 4, replace=False)] = True
    sorted_ = morton_sort_batch({"xyz": xyz.astype(np.float32),
                                 "mask": mask, "features": xyz})
    return sorted_["xyz"], sorted_["mask"], npoint


CASES = ["grid", "masked", "sparse", "small", "tiny", "shape"]
_REFS = {}


def _references(case):
    """(the plain version's, the JAX package's) picks and sample mask."""
    if case not in _REFS:
        xyz, mask, npoint = _cloud(case)
        pi, pm = furthest_point_sample_plain(torch.from_numpy(xyz), npoint,
                                             torch.from_numpy(mask))
        ji, jm = jfps(jnp.asarray(xyz), npoint, jnp.asarray(mask))
        _REFS[case] = ((pi.numpy(), pm.numpy()),
                       (np.asarray(ji), np.asarray(jm)))
    return _REFS[case]


@pytest.mark.parametrize("split", [(1, MIN_PPT, PRUNE_WARPS),
                                   (1, 1, 1), (1, MIN_PPT, 1),
                                   (2, MIN_PPT, PRUNE_WARPS), (2, 1, 1),
                                   (4, MIN_PPT, PRUNE_WARPS), (4, 2, 1)])
@pytest.mark.parametrize("case", CASES)
def test_mirror_equals_plain_and_jax(case, split):
    """(CTAs a cloud, points a thread at least, warps from which a CTA
    prunes): the kernel's own plan, and splits over more warps with
    pruning in every CTA."""
    cs, min_ppt, prune_warps = split
    xyz, mask, npoint = _cloud(case)
    (pi, pm), (ji, jm) = _references(case)
    assert np.array_equal(pi, ji) and np.array_equal(pm, jm)
    for b in range(len(xyz)):
        got, gm = fps_mirror(xyz[b], mask[b], npoint, cs, min_ppt,
                             prune_warps)
        assert np.array_equal(got, pi[b]), (b, got[:12], pi[b][:12])
        assert np.array_equal(gm, pm[b])


def test_all_masked_cloud_picks_zero():
    xyz, mask, npoint = _cloud("masked")
    got, gm = fps_mirror(xyz[1], mask[1], npoint)
    assert not mask[1].any() and (got == 0).all() and not gm.any()


def test_pruning_skips_most_warps_on_a_sorted_shape():
    """On a Morton-sorted surface of 1000 points in 32 warps of one point
    each, most warps skip most picks, and the picks stay the plain
    version's."""
    xyz, mask, npoint = _cloud("shape")
    stats = {}
    got, _ = fps_mirror(xyz[0], mask[0], npoint, 1, 1, 1, stats)
    assert np.array_equal(got, _references("shape")[0][0][0])
    assert stats["skipped"] > 0.5 * stats["warps"], stats


def test_order_key_is_float_order():
    v = np.array([-np.inf, -1e10, -1.0, -0.0, 0.0, 1e-40, 0.5, 1.0, 1e10,
                  np.inf], np.float32)
    k = order_key(v)
    assert (np.diff(k.astype(np.int64)) >= 0).all()
    assert k[3] < k[4]  # -0 below +0: mindist is never -0
    assert k.min() > 0  # a real key beats an empty lane's 0


def test_plans_at_the_models_calls():
    """The kernel's plans at the ModelNet40 step's and the flagship's FPS
    calls: one CTA a cloud; 20 warps of 8 points at 5000 (pruned), 5 at
    1250, 2 at 312, one warp for 78 and fewer points."""
    assert plan_for(5000, 1) == (5000, 8, 640)
    assert plan_for(1250, 1) == (1250, 8, 160)
    assert plan_for(1024, 1) == (1024, 8, 128)
    assert plan_for(312, 1) == (312, 8, 64)
    assert plan_for(78, 1) == (78, 4, 32)
    assert plan_for(16384, 1) == (16384, 16, 1024)
    assert plan_for(16384, 4) == (4096, 16, 256)
    for n in (1, 33, 5000, 16384):
        for cs in (1, 2, 4):
            per, ppt, threads = plan_for(n, cs)
            assert ppt * threads >= per and cs * threads // 32 <= 32


def test_mirror_constants_are_the_kernels():
    """The mirror's constants are ``csrc/fps.cu``'s."""
    with open(FPS_CU) as f:
        src = f.read()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert (got["kMaxThreads"], got["kWarpPoints"], got["kMinPPT"],
            got["kPruneWarps"]) == (MAX_THREADS, WARP_POINTS, MIN_PPT,
                                    PRUNE_WARPS)


@pytest.mark.parametrize("variant", ["cs2", "cs4"])
def test_cluster_variant_applies_to_the_kernel(variant):
    """``tools/variants/fps_cluster.json``'s edits each find their text in
    ``csrc/fps.cu`` once, so ``tools/time_variants.py`` can rebuild the
    cluster split, and make a launch of that many CTAs a cloud."""
    with open(os.path.join(REPO, "tools", "variants",
                           "fps_cluster.json")) as f:
        spec = json.load(f)
    with open(FPS_CU) as f:
        src = f.read()
    assert spec["cs1"] == {}
    for old, new in spec[variant]["fps.cu"]:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    cs = int(variant[2:])
    assert f"constexpr int kCluster = {cs};" in src
    assert "cudaLaunchKernelEx" in src and "__syncthreads();\n    const" \
        not in src
