"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips without a CUDA device. On a machine
with one:

    python -m pytest tests/test_torch_cuda.py -q

``chip_smoke.py`` checks the kernels at the shapes of the flagship
forward and of the ModelNet40 train step; these cases cover what those
paths do not reach: FPS beyond 1024 points (several points per thread)
and up to 16384 at 1 and 32 clouds, on ties, masked and all-masked
clouds and npoint > nvalid, and its launch plan,
query counts off the block size, supports across shared-memory tile
edges, K at its bound and above Ns, channel counts off the thread block
(C = 3, 8, 300, 1152), masked queries and empty neighborhoods, f32 and
bf16, the backward kernels (PosPool xyz and sin/cos, the neighborhood
moments, the neighborhood max and the point-wise MLP's min/max kernels,
ties included; the gathers equal to their CPU twins to the bit), the masked neighborhood sum (K13, repeated support rows)
and the point-wise MLP's route through it on either side of 64 queries, the pseudo-grid kernels at every influence mode with Kp
beyond one register chunk, the k-NN kernel (k = 1 and above, k > Ns,
ties, all-masked supports) and its routing, the grid subsampling on the
card against the CPU, the autograd wiring, the wrappers' refusals, and
the ``cl3d`` ops (their fake implementations against the kernels'
outputs, one launch a call).
The ball query is held to its plain version, to the bit, on Morton-sorted
clouds at the ModelNet40 and S3DIS step sizes (FPS-ordered queries and
supports, grid-subsampled queries padded at the origin), on grid clouds
whose tile boxes touch the radius, and at its edge cases; each call runs
its two device kernels once.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from closerlook3d_tpu_torch.data.spatial_host import morton_sort_batch
from closerlook3d_tpu_torch.data.synthetic import (
    SyntheticClassification, SyntheticSceneSegmentation)
from closerlook3d_tpu_torch.models.aggregation import (
    _typical_spacing, kernel_point_layout)
from closerlook3d_tpu_torch.ops import (
    aggregation, gather_reduce, grouping, moments, neighbors, pseudo_grid)
from closerlook3d_tpu_torch.ops.aggregation import (
    pospool_sincos_bwd_cuda, pospool_sincos_bwd_plain, pospool_sincos_cuda,
    pospool_sincos_plain, pospool_xyz_bwd_cuda, pospool_xyz_bwd_plain,
    pospool_xyz_cuda, pospool_xyz_plain)
from closerlook3d_tpu_torch.ops.grouping import (
    neighborhood_max_bwd_cuda, neighborhood_max_bwd_plain,
    neighborhood_max_cuda, neighborhood_max_plain)
from closerlook3d_tpu_torch.ops.moments import (
    neighborhood_moments_bwd_cuda, neighborhood_moments_bwd_plain,
    neighborhood_moments_cuda, neighborhood_moments_plain)
from closerlook3d_tpu_torch.ops.neighbors import (
    MAX_K, MAX_KNN, ball_query_cuda, ball_query_plain, knn1_cuda, knn_cuda,
    knn_plain)
from closerlook3d_tpu_torch.ops.pseudo_grid import (
    pseudo_grid_bwd_cuda, pseudo_grid_bwd_plain, pseudo_grid_cuda,
    pseudo_grid_plain)
from closerlook3d_tpu_torch.ops.reverse_index import (
    reverse_index_cuda, reverse_index_plain)
from closerlook3d_tpu_torch.ops.sampling import (
    furthest_point_sample_cuda, furthest_point_sample_plain, grid_subsample)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _cloud(seed, b, n, masked_frac=0.0, grid=False):
    rng = np.random.default_rng(seed)
    if grid:  # duplicates, exact ties and exact-radius neighbors
        xyz = rng.integers(-4, 5, size=(b, n, 3)).astype(np.float32) * 0.25
    else:
        xyz = rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32)
    mask = rng.random((b, n)) >= masked_frac
    if b > 1:
        mask[-1] = False  # an all-masked cloud
    return (torch.from_numpy(xyz).cuda(), torch.from_numpy(mask).cuda())


@pytest.mark.parametrize("nq,ns,r,k,grid", [
    (100, 300, 0.3, 16, False),   # nq off the block, ns across tiles
    (64, 1500, 0.25, MAX_K, False),  # K at its bound
    (37, 5, 0.9, 12, False),      # K > Ns: padded slots
    (200, 200, 0.5, 20, True),    # ties and points at exactly r
    (1, 1, 0.1, 1, False),
])
def test_ball_query_kernel_equals_plain(nq, ns, r, k, grid):
    s, smask = _cloud(1, 3, ns, masked_frac=0.2, grid=grid)
    q, qmask = _cloud(2, 3, nq, masked_frac=0.1, grid=grid)
    ki, km = ball_query_cuda(q, s, r, k, qmask, smask)
    pi, pm = ball_query_plain(q, s, r, k, qmask, smask)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(km, pm)
    # no masks: the wrapper supplies all-valid ones
    ki, km = ball_query_cuda(q, s, r, k)
    pi, pm = ball_query_plain(q, s, r, k)
    assert torch.equal(ki, pi) and torch.equal(km, pm)


def _bq_equal(q, s, r, k, qmask, smask):
    """Kernel equal to the plain version (in query chunks of 512) in idx
    and mask; returns the kernel's mask."""
    ki, km = ball_query_cuda(q, s, r, k, qmask, smask)
    pi, pm = ball_query_plain(q, s, r, k, qmask, smask, 512)
    torch.cuda.synchronize()
    bad = (ki != pi) | (km != pm)
    assert not bad.any(), (int(bad.sum()), bad.nonzero()[:4].tolist())
    return km


def _sorted_clouds(make, b, n, shift=0.0, padded=()):
    """Morton-sorted synthetic clouds (``make``: a dataset class of
    ``data/synthetic.py``), on the card; clouds in ``padded`` keep 70%."""
    ds = make(b, n, seed=11)
    xyz = np.stack([ds[i]["xyz"] for i in range(b)]).astype(np.float32)
    xyz[..., 0] += np.float32(shift)
    mask = np.ones((b, n), bool)
    for i in padded:
        mask[i, n * 7 // 10:] = False
    out = morton_sort_batch({"xyz": xyz, "mask": mask})
    return (torch.from_numpy(out["xyz"]).cuda(),
            torch.from_numpy(out["mask"]).cuda())


@pytest.mark.parametrize("radius", [0.05, 0.1])
def test_ball_query_kernel_on_sorted_shapes(radius):
    """The ModelNet40 step's sizes: 32 Morton-sorted clouds of 5000 points,
    queried by themselves and by 1250 FPS-ordered points of each."""
    x, m = _sorted_clouds(SyntheticClassification, 32, 5000, padded=(3,))
    _bq_equal(x, x, radius, 26, m, m)
    fidx, fm = furthest_point_sample_cuda(x, 1250, m)
    fq = torch.gather(x, 1, fidx.long()[..., None].expand(-1, -1, 3))
    _bq_equal(fq, x, radius, 26, fm, m)
    _bq_equal(fq, fq, radius * 2, 31, fm, fm)  # FPS-ordered supports


@pytest.mark.parametrize("shift", [0.0, 6.0])
def test_ball_query_kernel_on_subsampled_rooms(shift):
    """The S3DIS step's sizes: 8 rooms of 15000 points, and their grid
    subsampling to 4096 slots whose padding sits at the origin: on the
    floor, or (rooms shifted by 6 m) far from every point, where a padded
    row has no support in radius and takes the nearest one."""
    x, m = _sorted_clouds(SyntheticSceneSegmentation, 8, 15000, shift,
                          padded=(2,))
    q, qm = grid_subsample(x, 0.16, 4096, m)
    assert (q[~qm] == 0).all() and (~qm).sum() > 1000
    _bq_equal(x, x, 0.1, 26, m, m)
    _bq_equal(q, x, 0.2, 26, qm, m)
    _bq_equal(q, q, 0.2, 31, qm, qm)
    if shift:  # padded rows, unmasked: no support in radius
        km = _bq_equal(q, x, 0.2, 26, torch.ones_like(qm), m)
        assert not km[~qm].any()


@pytest.mark.parametrize("radius,k", [(0.25, 16), (0.5, 16), (0.5, MAX_K),
                                      (1.0, MAX_K)])
def test_ball_query_kernel_at_the_box_boundary(radius, k):
    """0.25-grid clouds, Morton-sorted: tiles whose box lies at exactly
    the radius, duplicated points, exact ties; at r = 1 more than 128
    supports are in radius, so the key buffer is cut to K as it fills."""
    rng = np.random.default_rng(41)
    xyz = rng.integers(-4, 5, size=(3, 600, 3)).astype(np.float32) * 0.25
    xyz[:, 30:60] = xyz[:, :30]
    mask = rng.random((3, 600)) >= 0.1
    out = morton_sort_batch({"xyz": xyz, "mask": mask})
    s = torch.from_numpy(out["xyz"]).cuda()
    sm = torch.from_numpy(out["mask"]).cuda()
    _bq_equal(s, s, radius, k, sm, sm)


def _edge_case(name):
    """(q, s, radius, k, qmask, smask) on the card."""
    x, m = _sorted_clouds(SyntheticClassification, 3, 700)
    if name == "all_masked":
        m[1] = False
        return x, x, 0.1, 16, torch.ones_like(m), m
    if name == "masked_in_reach":
        sm = m.clone()
        near = ((x[0, :, None] - x[0, None, :50]) ** 2).sum(-1).amin(1)
        sm[0] = near > 0.3 ** 2
        return x, x, 0.1, 16, m, sm
    if name == "far_valid":  # valid supports at d2 >= 1e10
        s, sm = x.clone(), m.clone()
        sm[:, :350] = False
        s[:, 350:, 0] += 2e5
        return x, s, 0.1, 16, m, sm
    if name == "k_max":
        return x, x, 0.3, MAX_K, m, m
    if name == "k_gt_ns":
        sm = m[:, :5].clone()
        sm[0, 3] = False
        return x, x[:, :5].contiguous(), 0.8, 12, m, sm
    if name in ("huge_radius", "huge_radius_k_gt_ns"):
        sm = m.clone()
        sm[:, ::2] = False
        if name == "huge_radius":
            return x, x, 1e5, 40, m, sm
        return (x, x[:, :9].contiguous(), 2e5, 12, m,
                sm[:, :9].contiguous())
    if name == "unsorted":
        perm = torch.from_numpy(
            np.random.default_rng(5).permutation(700)).cuda()
        return (x[:, :300].contiguous(), x[:, perm].contiguous(), 0.2, 32,
                m[:, :300].contiguous(), m[:, perm].contiguous())
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "all_masked", "masked_in_reach", "far_valid", "k_max", "k_gt_ns",
    "huge_radius", "huge_radius_k_gt_ns", "unsorted"])
def test_ball_query_kernel_edge_cases(name):
    """An all-masked cloud; only masked supports in reach; valid supports
    all at d2 >= 1e10 (a masked one is nearest); K = 64; K > Ns; r >= 1e5
    (masked supports in radius, nothing pruned); unsorted supports, which
    stay exact and only prune less."""
    _bq_equal(*_edge_case(name))


_ONE_CALL_OPS = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from closerlook3d_tpu_torch.ops.neighbors import ball_query_cuda
g = torch.Generator(device="cuda").manual_seed(0)
x = torch.rand((4, 2000, 3), generator=g, device="cuda")
m = torch.rand((4, 2000), generator=g, device="cuda") > 0.1
ball_query_cuda(x, x, 0.1, 26, m, m)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    for _ in range(4):
        ball_query_cuda(x, x, 0.1, 26, m, m)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


def test_ball_query_device_ops_run_once_a_call():
    """Each call runs the preparation pass and the query kernel once, and
    nothing else on the device. Profiled in a process of its own: after
    one profiling session, a later one in the same process has missed
    device events (the K13 test below then saw 1 of its 4 launches)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH"))
                           if p)
    out = subprocess.run([sys.executable, "-c", _ONE_CALL_OPS], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=path),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(set(names)) == 2, names
    assert all(names.count(n) == 4 for n in names), names


@pytest.mark.parametrize("n,npoint", [
    (1, 1), (33, 40), (1500, 375), (5000, 1250), (16384, 64)])
def test_fps_kernel_equals_plain(n, npoint):
    xyz, mask = _cloud(3, 3, n, masked_frac=0.3)
    ki, km = furthest_point_sample_cuda(xyz, npoint, mask)
    pi, pm = furthest_point_sample_plain(xyz, npoint, mask)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(km, pm)


def test_fps_kernel_ties_and_no_mask():
    xyz, _ = _cloud(4, 2, 700, grid=True)
    ki, km = furthest_point_sample_cuda(xyz, 100)
    pi, pm = furthest_point_sample_plain(xyz, 100)
    assert torch.equal(ki, pi) and torch.equal(km, pm)


FPS_SIZES = [1, 33, 1025, 5000, 10000, 16384]


def _fps_case(n, b):
    """A grid cloud (duplicated points, exact ties) with 30% of its points
    masked, cloud 0 holding only a few valid points (npoint > nvalid) and,
    for b > 1, the last cloud all masked; npoint past N for the smallest
    clouds."""
    xyz, mask = _cloud(40 + n, b, n, masked_frac=0.3, grid=True)
    keep = torch.rand((n,), generator=torch.Generator().manual_seed(n))
    mask[0] &= (keep < 0.01).cuda()
    return xyz, mask, min(n + 7, 300)


@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("n", FPS_SIZES)
def test_fps_kernel_equals_plain_at_every_size(n, b):
    """The picks and sample mask equal the plain version's at every cloud
    size, on ties, masked points, an all-masked cloud, npoint > nvalid and
    N off the warp."""
    xyz, mask, npoint = _fps_case(n, b)
    ki, km = furthest_point_sample_cuda(xyz, npoint, mask)
    pi, pm = furthest_point_sample_plain(xyz, npoint, mask)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(km, pm)
    if b > 1:
        assert (ki[-1] == 0).all() and not km[-1].any()


def test_fps_launch_plan():
    """``cl3d_fps_plan``, the kernel's own launch plan, at the plans that
    ``tests/test_torch_fps.py``'s mirror holds at the models' calls, and
    its limits at every N: enough points a thread, at most 32 warps, one
    warp up to 128 points, 8 points a thread or more past it."""
    import ctypes

    from closerlook3d_tpu_torch.ops import kernels

    lib = kernels.load("fps")
    ppt, threads = ctypes.c_int(), ctypes.c_int()

    def plan(n):
        lib.cl3d_fps_plan(n, ctypes.byref(ppt), ctypes.byref(threads))
        return ppt.value, threads.value

    assert plan(5000) == (8, 640) and plan(1250) == (8, 160)
    assert plan(1024) == (8, 128) and plan(312) == (8, 64)
    assert plan(78) == (4, 32) and plan(16384) == (16, 1024)
    for n in range(1, lib.cl3d_fps_max_points() + 1, 7):
        p, t = plan(n)
        assert p * t >= n and t % 32 == 0 and t <= 1024, (n, p, t)
        assert (t == 32) if n <= 128 else (p >= 8), (n, p, t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("nq,ns,c,k", [
    (70, 300, 3, 1), (257, 500, 96, 20), (33, 90, 1152, MAX_K)])
def test_pospool_kernel_matches_plain(dtype, reduction, nq, ns, c, k):
    s, smask = _cloud(5, 3, ns, masked_frac=0.2)
    q, qmask = _cloud(6, 3, nq, masked_frac=0.1)
    idx, nmask = ball_query_cuda(q, s, 0.4, k, qmask, smask)
    gen = torch.Generator(device="cuda").manual_seed(7)
    f = torch.randn((3, ns, c), generator=gen, device="cuda").to(dtype)
    got = pospool_xyz_cuda(q, s, f, idx, nmask, 0.4, reduction)
    ref = pospool_xyz_plain(q, s, f, idx, nmask, 0.4, reduction)
    assert got.dtype == dtype and got.shape == (3, nq, c)
    if dtype == torch.float32:
        # same f32 products; the neighbor sum associates differently
        tol = dict(rtol=1e-5, atol=1e-6 if reduction == "avg" else 1e-5)
    else:
        # the plain path rounds each product and the sum to bf16
        tol = dict(rtol=2e-2, atol=2e-2 if reduction == "avg" else 6e-2)
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    # an all-masked query row gives exactly 0
    assert (got[-1] == 0).all()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, qmask = _cloud(8, 2, 50)
    with pytest.raises(ValueError, match="nsample"):
        ball_query_cuda(q, q, 0.3, MAX_K + 1, qmask, qmask)
    with pytest.raises(ValueError, match="float32"):
        ball_query_cuda(q.double(), q.double(), 0.3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        furthest_point_sample_cuda(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), 8)
    idx, nmask = ball_query_cuda(q, q, 0.3, 4, qmask, qmask)
    f = torch.randn((2, 50, 10), device="cuda")
    with pytest.raises(ValueError, match="multiple of 3"):
        pospool_xyz_cuda(q, q, f, idx, nmask, 0.3, "avg")
    with pytest.raises(ValueError, match="int32"):
        pospool_xyz_cuda(q, q, f[..., :9].contiguous(), idx.long(), nmask,
                         0.3, "avg")


def test_launch_counters_count_launches_only():
    q, qmask = _cloud(9, 2, 40)
    before = ball_query_cuda.launches
    ball_query_cuda(q, q, 0.3, 4, qmask, qmask)
    with pytest.raises(ValueError):
        ball_query_cuda(q, q, 0.3, 0, qmask, qmask)
    assert ball_query_cuda.launches == before + 1


def _neighborhoods(nq, ns, k, seed=10):
    s, smask = _cloud(seed, 3, ns, masked_frac=0.2)
    q, qmask = _cloud(seed + 1, 3, nq, masked_frac=0.1)
    idx, nmask = ball_query_cuda(q, s, 0.4, k, qmask, smask)
    assert (~nmask.any(-1)).any()  # empty neighborhoods (masked cloud)
    return q, s, idx, nmask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("nq,ns,c,k", [
    (70, 300, 3, 1), (257, 500, 300, 20), (33, 90, 1152, MAX_K),
    (40, 5, 12, 8)])  # the last: K > Ns
def test_pospool_bwd_kernel_matches_plain(dtype, reduction, nq, ns, c, k):
    """K1b (the reverse index, then a gather per support row) equal to
    ``pospool_xyz_bwd_plain`` run on CPU copies, bit for bit with zero
    signs (both add the same f32 terms in (q, t) order from +0 and round
    once), and the same bits on a second launch."""
    q, s, idx, nmask = _neighborhoods(nq, ns, k)
    gen = torch.Generator(device="cuda").manual_seed(11)
    dy = torch.randn((3, nq, c), generator=gen, device="cuda").to(dtype)
    args = (q, s, idx, nmask, dy, 0.4, reduction)
    got = pospool_xyz_bwd_cuda(*args)
    again = pospool_xyz_bwd_cuda(*args)
    twin = pospool_xyz_bwd_plain(
        *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (3, ns, c)
    assert torch.equal(_bits(got.cpu()), _bits(twin))
    assert torch.equal(_bits(got), _bits(again))
    assert (got[-1] == 0).all()  # the all-masked cloud gets nothing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("values", ["ties", "distinct"])
@pytest.mark.parametrize("nq,ns,c,k", [
    (70, 300, 3, 1), (257, 500, 300, 20), (33, 90, 1152, MAX_K),
    (40, 5, 12, 8)])
def test_neighborhood_max_kernels_match_plain(dtype, values, nq, ns, c, k):
    _, _, idx, nmask = _neighborhoods(nq, ns, k, seed=12)
    gen = torch.Generator(device="cuda").manual_seed(13)
    f = torch.randn((3, ns, c), generator=gen, device="cuda")
    if values == "ties":  # post-ReLU values on a coarse grid
        f = torch.relu(torch.round(f * 2) / 2)
    f = f.to(dtype)
    out = neighborhood_max_cuda(f, idx, nmask)
    assert torch.equal(out, neighborhood_max_plain(f, idx, nmask))
    assert (out[-1] == 0).all()  # empty neighborhoods give 0
    dy = torch.randn((3, nq, c), generator=gen, device="cuda").to(dtype)
    args = (f, idx, nmask, out, dy)
    got = neighborhood_max_bwd_cuda(*args)
    again = neighborhood_max_bwd_cuda(*args)
    # the twin on CPU copies adds in (q, t) order, as the gather does
    twin = neighborhood_max_bwd_plain(*(a.cpu() for a in args))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (3, ns, c)
    assert torch.equal(_bits(got.cpu()), _bits(twin))
    assert torch.equal(_bits(got), _bits(again))
    assert (got[-1] == 0).all()  # the all-masked cloud gets nothing


# K8f and K7f in query groups: (B, Nq, Ns, K, C), K 1-64 and C in {1, 13,
# 72, 144, 1152}; the ModelNet40 strided calls' shapes (s1, s4), Nq off the
# groups a block, 1-4 queries at C = 1152 and the point-wise MLP's K13
# route (8 clouds of 8 queries)
EXTREMA_CASES = {"k1_c1": (3, 70, 300, 1, 1), "k13_c13": (3, 37, 120, 13, 13),
                 "k26_c72": (4, 125, 500, 26, 72),
                 "s1_c144": (4, 125, 500, 26, 144),
                 "k64_c144": (3, 40, 90, MAX_K, 144),
                 "s4_c1152": (8, 19, 78, 41, 1152),
                 "q1_c1152": (1, 1, 78, 41, 1152),
                 "q2_c1152": (1, 2, 78, 41, 1152),
                 "q3_c1152": (2, 3, 78, 41, 1152),
                 "q4_c1152": (1, 4, 78, 41, 1152),
                 "route_c1152": (8, 8, 32, 41, 1152)}


def _extrema_case(name, dtype, values, seed=95):
    """(f, d, idx, nmask) of an ``EXTREMA_CASES`` case: ball-query
    neighborhoods (past one cloud, the last all masked) with slots naming
    row -1 under a set mask and under a clear one; f on a 0.5 grid (ties,
    and -0 beside +0 where a rounding crosses zero from below), with NaNs
    at a few support rows for ``values`` "nan"; d [B, Nq, C] in f's
    dtype."""
    b, nq, ns, k, c = EXTREMA_CASES[name]
    s, smask = _cloud(seed, b, ns, masked_frac=0.2)
    q, qmask = _cloud(seed + 1, b, nq, masked_frac=0.1)
    idx, nmask = ball_query_cuda(q, s, 0.5, k, qmask, smask)
    idx = idx.clone()
    idx[..., 2::7] = torch.where(nmask[..., 2::7], -1, idx[..., 2::7])
    idx[..., 3::7] = torch.where(nmask[..., 3::7], idx[..., 3::7], -1)
    assert (nmask & (idx >= 0)).any()
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    f = torch.round(2 * torch.randn((b, ns, c), generator=gen,
                                    device="cuda")) / 2
    if values == "nan":  # the rows of cloud 0's first valid slots
        rows = idx[0][nmask[0] & (idx[0] >= 0)][:3].long()
        f[0, rows, ::5] = float("nan")
    d = torch.round(2 * torch.randn((b, nq, c), generator=gen,
                                    device="cuda")) / 2
    return f.to(dtype), d.to(dtype), idx, nmask


def _extrema_slot_order(x, valid):
    """The parents' loop over all K slots, in PyTorch on the card: over x
    [B, Nq, K, C] f32, for t = 0 .. K-1 each valid slot sets hi and lo if
    it is the first, else raises hi where hi == hi and (v != v or v > hi)
    (lo alike); 0 where no slot is valid. (hi, lo) f32."""
    hi = torch.zeros_like(x[:, :, 0])
    lo = torch.zeros_like(hi)
    seen = torch.zeros_like(valid[:, :, :1])
    for t in range(x.shape[2]):
        v, live = x[:, :, t], valid[:, :, t, None]
        first = live & ~seen
        up = live & (hi == hi) & ((v != v) | (v > hi))
        dn = live & (lo == lo) & ((v != v) | (v < lo))
        hi = torch.where(first | up, v, hi)
        lo = torch.where(first | dn, v, lo)
        seen = seen | live
    return hi, lo


def _equal_nan_by_position(got, ref, bits=True):
    """NaNs at the same places; elsewhere the same bits (or, ``bits``
    False, the same values: -0 == +0)."""
    nan = got.isnan()
    assert torch.equal(nan, ref.isnan())
    a, b = got.masked_fill(nan, 0), ref.masked_fill(nan, 0)
    assert torch.equal(_bits(a), _bits(b)) if bits else torch.equal(a, b)


@pytest.mark.parametrize("values", ["grid", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(EXTREMA_CASES))
@pytest.mark.parametrize("op", ["max", "minmax"])
def test_extrema_forwards_in_query_groups(op, name, dtype, values):
    """K8f and K7f: equal to their plain versions (given the mask set only
    where idx >= 0) and bit for bit to the parents' slot loop, NaNs by
    position; one launch counted a call, the same bits on a second one; 0
    where no slot is valid. K8b's backward on K8f's output still equals
    its twin on CPU copies to the bit (finite values)."""
    f, d, idx, nmask = _extrema_case(name, dtype, values)
    valid = nmask & (idx >= 0)
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    x = grouping.group_features(f.float(), safe)
    empty = ~valid.any(-1)
    if op == "max":
        fn, before = neighborhood_max_cuda, neighborhood_max_cuda.launches
        got = (fn(f, idx, nmask),)
        again = (fn(f, idx, nmask),)
        ref = (neighborhood_max_plain(f, idx.clamp(min=0), valid),)
        slot = (_extrema_slot_order(x, valid)[0].to(dtype),)
    else:
        if name == "route_c1152":  # the K13 route's call, against zeros
            d = torch.zeros_like(d)
        fn = gather_reduce.gather_sub_minmax_cuda
        before = fn.launches
        got, again = fn(f, d, idx, nmask), fn(f, d, idx, nmask)
        ref = gather_reduce.gather_sub_minmax_plain(f, d, idx.clamp(min=0),
                                                    valid)
        slot = _extrema_slot_order(x - d.float()[:, :, None, :], valid)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    for o, o2, r, sl in zip(got, again, ref, slot):
        assert o.dtype == r.dtype and o.shape == r.shape
        _equal_nan_by_position(o, r, bits=False)
        _equal_nan_by_position(o, sl)
        assert torch.equal(_bits(o), _bits(o2))
        assert (o[empty] == 0).all()
    assert got[0].isnan().any() == (values == "nan")
    if op == "max" and values == "grid":
        gen = torch.Generator(device="cuda").manual_seed(96)
        dy = torch.randn(got[0].shape, generator=gen,
                         device="cuda").to(dtype)
        # the backward takes the valid slots (the twin gathers every row)
        args = (f, idx.clamp(min=0), valid, got[0], dy)
        df = neighborhood_max_bwd_cuda(*args)
        twin = neighborhood_max_bwd_plain(*(a.cpu() for a in args))
        assert torch.equal(_bits(df.cpu()), _bits(twin))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["k13_c13", "s1_c144", "q3_c1152"])
def test_extrema_forwards_take_unaligned_views(name, dtype):
    """f (K8f), and g and d (K7f), as views one element into a buffer (off
    16 bytes: the scalar units) give the bits of their aligned copies."""
    f, d, idx, nmask = _extrema_case(name, dtype, "grid", seed=97)

    def odd(t):
        base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        base[1:] = t.reshape(-1)
        return base[1:].view(t.shape)

    fv, dv = odd(f), odd(d)
    assert fv.data_ptr() % 16 != 0 and dv.data_ptr() % 16 != 0
    assert torch.equal(_bits(neighborhood_max_cuda(fv, idx, nmask)),
                       _bits(neighborhood_max_cuda(f, idx, nmask)))
    got = gather_reduce.gather_sub_minmax_cuda(fv, dv, idx, nmask)
    ref = gather_reduce.gather_sub_minmax_cuda(f, d, idx, nmask)
    for o, r in zip(got, ref):
        assert torch.equal(_bits(o), _bits(r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 12, 144, 300, 1152])
@pytest.mark.parametrize("name", ["ball", "ties", "strided",
                                  "masked_queries", "unreached", "one_row"])
def test_neighborhood_max_bwd_gather_equals_twin_to_the_bit(name, c, dtype):
    """K8b (the tiled reverse index beside the tie quotients, then a
    gather per support row) on post-ReLU values on a 0.25 grid that are a
    function of the point's position (duplicated points carry equal rows,
    exact ties within neighborhoods): equal to its twin on CPU copies to
    the bit, and the same bits on a second launch; C off the 16-byte vector
    (3, 12 and 300 in bf16) takes the scalar units."""
    q, s, idx, nmask = _gather_case(name)
    gen = torch.Generator(device="cuda").manual_seed(69)
    w = torch.randn((3, c), generator=gen, device="cuda")
    f = torch.relu(torch.round(4 * (s @ w)) / 4).to(dtype)
    out = neighborhood_max_cuda(f, idx, nmask)
    dy = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    args = (f, idx, nmask, out, dy)
    got = neighborhood_max_bwd_cuda(*args)
    again = neighborhood_max_bwd_cuda(*args)
    twin = neighborhood_max_bwd_plain(*(a.cpu() for a in args))
    torch.cuda.synchronize()
    assert torch.equal(_bits(got.cpu()), _bits(twin))
    assert torch.equal(_bits(got), _bits(again))
    assert (got[-1] == 0).all()


def test_neighborhood_max_bwd_takes_unaligned_views_and_keeps_nan_at_ties():
    """f, out and dy as views at an odd element offset give the bits of
    their aligned copies; a NaN in dy reaches only the rows that tie for
    its (query, channel), every other element as with that dy set to 0
    (the twin's g * 0 would spread it to every row the query names)."""
    q, s, idx, nmask = _gather_case("ties")
    c = 72
    gen = torch.Generator(device="cuda").manual_seed(70)
    w = torch.randn((3, c), generator=gen, device="cuda")
    f0 = torch.relu(torch.round(4 * (s @ w)) / 4).bfloat16()
    out0 = neighborhood_max_cuda(f0, idx, nmask)
    dy0 = torch.randn(out0.shape, generator=gen, device="cuda").bfloat16()

    def odd(t):
        base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        base[1:] = t.reshape(-1)
        return base[1:].view(t.shape)

    f, out, dy = odd(f0), odd(out0), odd(dy0)
    assert f.data_ptr() % 16 != 0
    ref = neighborhood_max_bwd_cuda(f0, idx, nmask, out0, dy0)
    assert torch.equal(_bits(neighborhood_max_bwd_cuda(f, idx, nmask, out,
                                                       dy)), _bits(ref))
    q0 = int(nmask[0].sum(-1).argmax())
    ch = 5
    nan = dy0.clone()
    nan[0, q0, ch] = float("nan")
    zero = dy0.clone()
    zero[0, q0, ch] = 0
    got = neighborhood_max_bwd_cuda(f0, idx, nmask, out0, nan)
    base = neighborhood_max_bwd_cuda(f0, idx, nmask, out0, zero)
    rows = idx[0, q0][nmask[0, q0]].long()
    ties = rows[f0[0, rows, ch] == out0[0, q0, ch]]
    want = torch.zeros_like(got, dtype=torch.bool)
    want[0, ties, ch] = True
    assert torch.equal(torch.isnan(got), want) and len(ties) > 0
    assert torch.equal(_bits(got[~want]), _bits(base[~want]))


@pytest.mark.parametrize("op", ["pospool", "max"])
def test_autograd_launches_the_backward_kernels(op):
    q, s, idx, nmask = _neighborhoods(60, 200, 16, seed=14)
    f = torch.randn((3, 200, 24), device="cuda", requires_grad=True)
    if op == "pospool":
        fused = lambda x: aggregation.pospool_fused(  # noqa: E731
            q, s, x, idx, nmask, 0.4, "xyz", "avg")
        plain = lambda x: pospool_xyz_plain(  # noqa: E731
            q, s, x, idx, nmask, 0.4, "avg")
        fwd, bwd = pospool_xyz_cuda, pospool_xyz_bwd_cuda
    else:
        fused = lambda x: grouping.neighborhood_max(  # noqa: E731
            x, idx, nmask)
        plain = lambda x: neighborhood_max_plain(x, idx, nmask)  # noqa
        fwd, bwd = neighborhood_max_cuda, neighborhood_max_bwd_cuda
    before = (fwd.launches, bwd.launches)
    dy = torch.randn((3, 60, 24), device="cuda")
    (got,) = torch.autograd.grad(fused(f), f, dy)
    (ref,) = torch.autograd.grad(plain(f), f, dy)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    q, s, idx, nmask = _neighborhoods(20, 50, 4, seed=15)
    dy = torch.randn((3, 20, 9), device="cuda")
    with pytest.raises(ValueError, match="dy must be"):
        pospool_xyz_bwd_cuda(q, s, idx, nmask, dy[:, :10].contiguous(), 0.4,
                             "avg")
    f = torch.randn((3, 50, 9), device="cuda")
    out = neighborhood_max_cuda(f, idx, nmask)
    with pytest.raises(ValueError, match="dtype"):
        neighborhood_max_bwd_cuda(f, idx, nmask, out, dy.bfloat16())
    with pytest.raises(ValueError, match="int32"):
        neighborhood_max_cuda(f, idx.long(), nmask)


# sin/cos PosPool (K5) and the neighborhood moments (K9): (forward kernel,
# its plain version, backward kernel, its twin, output channels per input
# channel)
NEW_OPS = {
    "sincos": (pospool_sincos_cuda, pospool_sincos_plain,
               pospool_sincos_bwd_cuda, pospool_sincos_bwd_plain, 1),
    "moments": (neighborhood_moments_cuda, neighborhood_moments_plain,
                neighborhood_moments_bwd_cuda, neighborhood_moments_bwd_plain,
                4),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("nq,ns,c,k", [
    (70, 300, 6, 1), (257, 500, 300, 20), (33, 90, 1152, MAX_K),
    (40, 5, 12, 8)])  # C off the thread block and at 1152; K > Ns
@pytest.mark.parametrize("op", sorted(NEW_OPS))
def test_sincos_and_moments_kernels_match_plain(op, dtype, reduction, nq,
                                                ns, c, k):
    fwd, plain, bwd, twin, widen = NEW_OPS[op]
    q, s, idx, nmask = _neighborhoods(nq, ns, k, seed=16)
    gen = torch.Generator(device="cuda").manual_seed(17)
    f = torch.randn((3, ns, c), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((3, nq, c * widen), generator=gen,
                     device="cuda").to(dtype)
    out = fwd(q, s, f, idx, nmask, 0.4, reduction)
    ref = plain(q, s, f, idx, nmask, 0.4, reduction)
    assert out.dtype == dtype and out.shape == (3, nq, c * widen)
    got = bwd(q, s, idx, nmask, dy, 0.4, reduction)
    twin_df = twin(q, s, idx, nmask, dy, 0.4, reduction)
    assert got.dtype == dtype and got.shape == (3, ns, c)
    if dtype == torch.float32:
        # same f32 terms (sin/cos of the same f32 angles), summed in slot
        # order or with atomics; a moments slot term is up to 4x a PosPool
        # one
        fwd_tol = dict(rtol=1e-5, atol=1e-6 if reduction == "avg" else 1e-5)
        bwd_tol = dict(rtol=1e-5,
                       atol=1e-6 if reduction == "avg" else 4e-5)
    else:
        # the plain forward rounds each product to bf16; the twin sums in
        # f32 and rounds once, as the kernel does
        fwd_tol = dict(rtol=2e-2, atol=2e-2 if reduction == "avg" else 6e-2)
        bwd_tol = dict(rtol=8e-3, atol=1e-5)
    torch.testing.assert_close(out.float(), ref.float(), **fwd_tol)
    torch.testing.assert_close(got.float(), twin_df.float(), **bwd_tol)
    assert (out[-1] == 0).all() and (got[-1] == 0).all()  # masked cloud


@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("op", ["xyz", "adaptive"])
def test_bf16_aggregation_within_a_rounding_of_its_arithmetic(op, reduction):
    """The bf16 PosPool xyz and moments forwards at the shape of PartNet's
    stage-2 strided call (8 clouds of 625 queries onto 2500 supports,
    K = 31, C = 288) against their own arithmetic in f64
    (``chip_smoke.agg_exact``: dp rounded to bf16, products and sums
    exact): within half a bf16 ulp of the result and the f32 sums' error.
    The plain version rounds every product and sum to bf16 and strays
    further."""
    import chip_smoke

    fwd = chip_smoke.agg_ops(op)[0]
    s, smask = _cloud(30, 8, 2500, masked_frac=0.1)
    q, qmask = s[:, :625].contiguous(), smask[:, :625].contiguous()
    idx, nmask = ball_query_cuda(q, s, 0.3, 31, qmask, smask)
    gen = torch.Generator(device="cuda").manual_seed(31)
    f = torch.randn((8, 2500, 288), generator=gen,
                    device="cuda").to(torch.bfloat16)
    got = fwd(q, s, f, idx, nmask, 0.3, reduction)
    exact = chip_smoke.agg_exact(op, q, s, f, idx, nmask, 0.3, reduction)
    assert got.dtype == torch.bfloat16 and got.shape == exact.shape
    torch.testing.assert_close(got.double(), exact, rtol=2 ** -8, atol=1e-4)


def test_sincos_kernel_at_large_angles():
    """Neighbors out to |dp| = 1 (100 rad in the top frequency): the
    kernel's sincosf of f32 angles against torch.sin / torch.cos."""
    q = torch.zeros((1, 1, 3), device="cuda")
    s = torch.tensor([[[1.0, 0, 0], [0, -1.0, 0], [0.6, 0.8, 0],
                       [0.3, -0.4, 0.866]]], device="cuda")
    idx = torch.arange(4, dtype=torch.int32, device="cuda").reshape(1, 1, 4)
    nmask = torch.ones((1, 1, 4), dtype=torch.bool, device="cuda")
    f = torch.ones((1, 4, 1152), device="cuda")
    got = pospool_sincos_cuda(q, s, f, idx, nmask, 1.0, "sum")
    ref = pospool_sincos_plain(q, s, f, idx, nmask, 1.0, "sum")
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", sorted(NEW_OPS))
def test_autograd_launches_sincos_and_moments_kernels(op):
    fwd, plain, bwd, _, widen = NEW_OPS[op]
    q, s, idx, nmask = _neighborhoods(60, 200, 16, seed=18)
    f = torch.randn((3, 200, 24), device="cuda", requires_grad=True)
    if op == "sincos":
        fused = lambda x: aggregation.pospool_fused(  # noqa: E731
            q, s, x, idx, nmask, 0.4, "sin_cos", "avg")
    else:
        fused = lambda x: moments.neighborhood_moments(  # noqa: E731
            q, s, x, idx, nmask, 0.4, "avg")
    before = (fwd.launches, bwd.launches)
    dy = torch.randn((3, 60, 24 * widen), device="cuda")
    (got,) = torch.autograd.grad(fused(f), f, dy)
    (ref,) = torch.autograd.grad(
        plain(q, s, f, idx, nmask, 0.4, "avg"), f, dy)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_sincos_and_moments_wrappers_refuse():
    q, s, idx, nmask = _neighborhoods(20, 50, 4, seed=19)
    f = torch.randn((3, 50, 9), device="cuda")
    with pytest.raises(ValueError, match="multiple of 6"):
        pospool_sincos_cuda(q, s, f, idx, nmask, 0.4, "avg")
    with pytest.raises(ValueError, match="multiple of 4"):
        neighborhood_moments_bwd_cuda(q, s, idx, nmask,
                                      torch.randn((3, 20, 10), device="cuda"),
                                      0.4, "avg")
    with pytest.raises(ValueError, match="avg|sum"):
        neighborhood_moments_cuda(q, s, f, idx, nmask, 0.4, "max")


# the point-wise MLP's kernels: K6 (min/max + BN statistics) and K7
# (gather-subtract min/max)
def _pwmlp_inputs(nq, ns, c, k, dtype, values, seed):
    _, _, idx, nmask = _neighborhoods(nq, ns, k, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    g32 = torch.randn((3, ns, c), generator=gen, device="cuda")
    if values == "ties":  # a coarse grid: exact ties in a neighborhood
        g32 = torch.round(g32 * 2) / 2
    d = torch.randn((3, nq, c), generator=gen, device="cuda").to(dtype)
    cot = [torch.randn((3, nq, c), generator=gen, device="cuda")
           for _ in range(4)]
    return g32.to(dtype), (g32 * g32).to(dtype), d, idx, nmask, cot


def _pwmlp_bwd_tol(dtype):
    # the same f32 terms scattered in atomic order; bf16: both sum in f32
    # and round once
    return (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
            else dict(rtol=8e-3, atol=1e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("values", ["ties", "distinct"])
@pytest.mark.parametrize("nq,ns,c,k", [
    (70, 300, 8, 1), (257, 500, 300, 20), (33, 90, 1152, MAX_K),
    (40, 5, 12, 8)])  # C off the thread block and at 1152; K > Ns
def test_pwmlp_stats_kernels_match_plain(dtype, values, nq, ns, c, k):
    g, gsq, _, idx, nmask, cot = _pwmlp_inputs(nq, ns, c, k, dtype, values,
                                               20)
    outs = gather_reduce.pwmlp_minmax_stats_cuda(g, gsq, idx, nmask)
    ref = gather_reduce.pwmlp_minmax_stats_plain(g, gsq, idx, nmask)
    assert all(o.dtype == torch.float32 and o.shape == (3, nq, c)
               for o in outs)
    assert torch.equal(outs[0], ref[0]) and torch.equal(outs[1], ref[1])
    for o, r in zip(outs[2:], ref[2:]):  # f32 sums in slot order vs ATen's
        torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-5)
    assert all((o[-1] == 0).all() for o in outs)  # the masked cloud
    got = gather_reduce.pwmlp_minmax_stats_bwd_cuda(g, idx, nmask, outs[0],
                                                    outs[1], *cot)
    twin = gather_reduce.pwmlp_minmax_stats_bwd_plain(g, idx, nmask, outs[0],
                                                      outs[1], *cot)
    for o, r in zip(got, twin):
        assert o.dtype == dtype and o.shape == g.shape
        torch.testing.assert_close(o.float(), r.float(),
                                   **_pwmlp_bwd_tol(dtype))
        assert (o[-1] == 0).all()


def _stats_slot_order(g, gsq, idx, nmask):
    """K6f's sums as its parent's loop over all K slots ran them, in
    PyTorch on the card: for t = 0 .. K-1, each valid slot (mask set, idx
    >= 0) adds g and gsq in f64 from +0, each add a tensor op of its own;
    one rounding to f32. (s1, s2)."""
    valid = nmask & (idx >= 0)
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    sums = []
    for x in (g, gsq):
        v = grouping.group_features(x, safe).double()  # [B, Nq, K, C]
        acc = torch.zeros_like(v[:, :, 0])
        for t in range(idx.shape[2]):
            acc = torch.where(valid[:, :, t, None], acc + v[:, :, t], acc)
        sums.append(acc.float())
    return sums


# name: (B, Nq, Ns, K, C): the ModelNet40 step's stages (C = 72 ... 1152,
# the strided calls' Nq < Ns, deep stages split into slices) and C off the
# 4-channel unit (scalar units)
STATS_CASES = {"s0": (4, 500, 500, 26, 72),
               "s1_strided": (4, 125, 500, 26, 144),
               "s2": (8, 80, 80, 38, 288), "s3": (32, 78, 78, 41, 576),
               "s4": (32, 19, 19, 39, 1152), "c78": (3, 37, 120, 16, 78),
               "c13": (3, 37, 120, 16, 13), "k64": (3, 20, 90, MAX_K, 6)}


def _stats_case(name, dtype, seed=90):
    """(g, gsq, idx, nmask) of a K6f case: ball-query neighborhoods (the
    last cloud all masked) with a few slots naming row -1 under a set mask
    (the loops skip them), values on a coarse grid (ties) and gsq = g^2."""
    b, nq, ns, k, c = STATS_CASES[name]
    s, smask = _cloud(seed, b, ns, masked_frac=0.2)
    q, qmask = (s, smask) if nq == ns else _cloud(seed + 1, b, nq,
                                                  masked_frac=0.1)
    idx, nmask = ball_query_cuda(q, s, 0.4, k, qmask, smask)
    idx = idx.clone()
    idx[..., ::7] = torch.where(nmask[..., ::7], -1, idx[..., ::7])
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    g32 = torch.round(4 * torch.randn((b, ns, c), generator=gen,
                                      device="cuda")) / 4
    return g32.to(dtype), (g32 * g32).to(dtype), idx, nmask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(STATS_CASES))
def test_pwmlp_stats_forward_equals_slot_order(name, dtype):
    """K6f in query groups: gmax and gmin equal the plain version, s1 and
    s2 the slot-order f64 sums of ``_stats_slot_order``, bit for bit, and
    a second launch gives the same bits; 0 where no slot is valid."""
    g, gsq, idx, nmask = _stats_case(name, dtype)
    outs = gather_reduce.pwmlp_minmax_stats_cuda(g, gsq, idx, nmask)
    again = gather_reduce.pwmlp_minmax_stats_cuda(g, gsq, idx, nmask)
    valid = nmask & (idx >= 0)
    ref = gather_reduce.pwmlp_minmax_stats_plain(
        g, gsq, idx.clamp(min=0), valid)
    sums = _stats_slot_order(g, gsq, idx, nmask)
    for o, r in zip(outs[:2], ref[:2]):  # values: amax may pick -0 or +0
        assert o.dtype == torch.float32 and torch.equal(o, r)
    for o, r in zip(outs[2:], sums):
        assert o.dtype == torch.float32 and torch.equal(_bits(o), _bits(r))
    for o, o2 in zip(outs, again):
        assert torch.equal(_bits(o), _bits(o2))
    assert outs[2].abs().max() > 0.1
    assert all((o[~valid.any(-1)] == 0).all() for o in outs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pwmlp_stats_forward_takes_unaligned_views(dtype):
    """g and gsq as views one element into a buffer (off the vector: the
    scalar units) give the bits of their aligned copies."""
    g, gsq, idx, nmask = _stats_case("s1_strided", dtype, seed=93)
    views = []
    for x in (g, gsq):
        flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        view = flat[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 8 != 0
        views.append(view)
    got = gather_reduce.pwmlp_minmax_stats_cuda(*views, idx, nmask)
    ref = gather_reduce.pwmlp_minmax_stats_cuda(g, gsq, idx, nmask)
    for o, r in zip(got, ref):
        assert torch.equal(_bits(o), _bits(r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("values", ["ties", "distinct"])
@pytest.mark.parametrize("nq,ns,c,k", [
    (70, 300, 8, 1), (257, 500, 300, 20), (33, 90, 1152, MAX_K),
    (40, 5, 12, 8)])
def test_gather_sub_minmax_kernels_match_plain(dtype, values, nq, ns, c, k):
    g, _, d, idx, nmask, cot = _pwmlp_inputs(nq, ns, c, k, dtype, values, 22)
    hm = gather_reduce.gather_sub_minmax_cuda(g, d, idx, nmask)
    ref = gather_reduce.gather_sub_minmax_plain(g, d, idx, nmask)
    assert torch.equal(hm[0], ref[0]) and torch.equal(hm[1], ref[1])
    assert (hm[0][-1] == 0).all() and (hm[1][-1] == 0).all()
    # K7b adds each support row's terms in the (q, t) order of its twin's
    # index_add_ on CPU tensors: the twin's bits, the same on every launch
    args = (g, d, idx, nmask, *hm, *cot[:2])
    dg, dd = gather_reduce.gather_sub_minmax_bwd_cuda(*args)
    again = gather_reduce.gather_sub_minmax_bwd_cuda(*args)
    twin = gather_reduce.gather_sub_minmax_bwd_plain(*(a.cpu() for a in args))
    torch.cuda.synchronize()
    assert dg.dtype == dd.dtype == dtype and dd.shape == d.shape
    for o, a, r in zip((dg, dd), again, twin):
        assert torch.equal(_bits(o.cpu()), _bits(r))
        assert torch.equal(_bits(o), _bits(a))
    assert (dg[-1] == 0).all() and (dd[-1] == 0).all()


def _minmax_bwd_case(name, c, dtype, seed=71):
    """K7b's inputs on a ``_gather_case``: g on the supports and d on the
    queries, values on a 0.5 grid that are a function of the point's
    position (duplicated points carry equal rows; a neighborhood's h
    often ties its max, its min or both), the forward's extrema, f32
    cotangents."""
    q, s, idx, nmask = _gather_case(name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((3, c), generator=gen, device="cuda")
    g = (torch.round(2 * (s @ w)) / 2).to(dtype)
    d = (torch.round(2 * (q @ w.flip(1))) / 2).to(dtype)
    hm = gather_reduce.gather_sub_minmax_cuda(g, d, idx, nmask)
    cot = [torch.randn(hm[0].shape, generator=gen, device="cuda")
           for _ in range(2)]
    return g, d, idx, nmask, *hm, *cot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 12, 144, 300, 1152])
@pytest.mark.parametrize("name", ["ball", "ties", "strided",
                                  "masked_queries", "unreached", "one_row"])
def test_gather_sub_minmax_bwd_gather_equals_twin_to_the_bit(name, c, dtype):
    """K7b (the tiled reverse index beside the shares, then a gather per
    support row) at ties, masked queries, unreached rows, one row named by
    every slot and strided shapes: dg and dd equal to the twin on CPU
    copies to the bit and the same on a second launch; C off the 4-channel
    unit (3) takes scalar units."""
    args = _minmax_bwd_case(name, c, dtype)
    got = gather_reduce.gather_sub_minmax_bwd_cuda(*args)
    again = gather_reduce.gather_sub_minmax_bwd_cuda(*args)
    twin = gather_reduce.gather_sub_minmax_bwd_plain(*(a.cpu() for a in args))
    torch.cuda.synchronize()
    for o, a, r in zip(got, again, twin):
        assert o.dtype == dtype and o.shape == r.shape
        assert torch.equal(_bits(o.cpu()), _bits(r))
        assert torch.equal(_bits(o), _bits(a))
    assert (got[0][-1] == 0).all() and got[0].float().abs().max() > 0.1


def test_gather_sub_minmax_bwd_takes_unaligned_views():
    """g, d, the extrema and the cotangents as views at an odd element
    offset (off 16 bytes: the scalar units) give the bits of their aligned
    copies."""
    for dtype in (torch.float32, torch.bfloat16):
        args = _minmax_bwd_case("ties", 72, dtype, seed=72)

        def odd(t):
            base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
            base[1:] = t.reshape(-1)
            return base[1:].view(t.shape)

        views = [a if i in (2, 3) else odd(a) for i, a in enumerate(args)]
        assert all(v.data_ptr() % 16 != 0 for i, v in enumerate(views)
                   if i not in (2, 3))
        got = gather_reduce.gather_sub_minmax_bwd_cuda(*views)
        ref = gather_reduce.gather_sub_minmax_bwd_cuda(*args)
        for o, r in zip(got, ref):
            assert torch.equal(_bits(o), _bits(r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns,k", [(32, 41), (8, 39)])
def test_gather_sub_minmax_bwd_at_the_k13_route(dtype, ns, k):
    """K7b at the shapes of the ShapeNetPart point-wise MLP's K13-route
    calls (8 clouds of 8 queries, C = 1152, K 41 or 39 over 32 or 8
    supports, d = 0 as that route passes it): the twin's bits, every
    launch."""
    gen = torch.Generator(device="cuda").manual_seed(73)
    s = torch.rand((8, ns, 3), generator=gen, device="cuda")
    smask = torch.ones((8, ns), dtype=torch.bool, device="cuda")
    smask[-1, ns // 2:] = False
    idx, nmask = ball_query_cuda(s[:, :8].contiguous(), s, 0.6, k,
                                 smask[:, :8].contiguous(), smask)
    g = (torch.round(2 * torch.randn((8, ns, 1152), generator=gen,
                                     device="cuda")) / 2).to(dtype)
    d = torch.zeros((8, 8, 1152), dtype=dtype, device="cuda")
    hm = gather_reduce.gather_sub_minmax_cuda(g, d, idx, nmask)
    cot = [torch.randn(hm[0].shape, generator=gen, device="cuda")
           for _ in range(2)]
    args = (g, d, idx, nmask, *hm, *cot)
    got = gather_reduce.gather_sub_minmax_bwd_cuda(*args)
    twin = gather_reduce.gather_sub_minmax_bwd_plain(*(a.cpu() for a in args))
    again = gather_reduce.gather_sub_minmax_bwd_cuda(*args)
    for o, a, r in zip(got, again, twin):
        assert torch.equal(_bits(o.cpu()), _bits(r))
        assert torch.equal(_bits(o), _bits(a))


_OPS_A_CALL = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from closerlook3d_tpu_torch.ops import gather_reduce, neighbors
g = torch.Generator(device="cuda").manual_seed(0)
x = torch.rand((4, 4096, 3), generator=g, device="cuda")
m = torch.rand((4, 4096), generator=g, device="cuda") > 0.1
idx, nm = neighbors.ball_query_cuda(x[:, :500].contiguous(), x, 0.1, 26,
                                    m[:, :500].contiguous(), m)
f = torch.randn((4, 4096, 72), generator=g, device="cuda").bfloat16()
d = torch.randn((4, 500, 72), generator=g, device="cuda").bfloat16()
hm = gather_reduce.gather_sub_minmax_cuda(f, d, idx, nm)
cot = [torch.randn(hm[0].shape, generator=g, device="cuda") for _ in hm]
q = torch.rand((4, 9000, 3), generator=g, device="cuda")
x5, m5 = x[:, :500].contiguous(), m[:, :500].contiguous()
calls = [lambda: gather_reduce.gather_sub_minmax_bwd_cuda(f, d, idx, nm,
                                                          *hm, *cot),
         lambda: neighbors.knn(q, x, 1, m),
         lambda: neighbors.knn(q, x5, 1, m5),
         lambda: neighbors.knn(q, x, 3, m)]
for c in calls:
    c()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    for _ in range(4):
        for c in calls:
            c()
    torch.cuda.synchronize()
print(json.dumps({"names": [e.name for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA],
                  "ops": [neighbors.knn_device_ops(n, k)
                          for n, k in ((4096, 1), (500, 1), (4096, 3))]}))
"""


def test_k7b_and_knn_device_ops_a_call():
    """K7b runs its two launches once a call (the index with the shares,
    then the gather) and nothing else on the device: no fill, no cast;
    the 1-NN over 4096 supports runs the preparation and the pruned
    search, over 500 supports the all-pairs kernel alone, and the k-NN at
    k = 3 its kernel alone, as ``knn_device_ops`` reports. Profiled in a
    process of its own (see the ball query's test)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH"))
                           if p)
    out = subprocess.run([sys.executable, "-c", _OPS_A_CALL], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=path),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    names = got["names"]
    assert got["ops"] == [2, 1, 1]
    assert len(set(names)) == 6 and all(names.count(n) == 4
                                        for n in names), names
    short = sorted(re.search(r"(\w+)(<[^(]*>)?\(", n).group(1)
                   for n in set(names))
    assert short == sorted(["mm_index_shares_kernel", "mm_gather_kernel",
                            "prep_kernel", "knn1_pruned_kernel",
                            "knn1_kernel", "knn_kernel"]), short


@pytest.mark.parametrize("op", ["stats", "minmax"])
def test_autograd_launches_pwmlp_kernels(op):
    g, gsq, d, idx, nmask, cot = _pwmlp_inputs(60, 200, 24, 16,
                                               torch.float32, "distinct", 24)
    if op == "stats":
        fused = gather_reduce.pwmlp_minmax_stats
        plain = gather_reduce.pwmlp_minmax_stats_plain
        fwd = gather_reduce.pwmlp_minmax_stats_cuda
        bwd = gather_reduce.pwmlp_minmax_stats_bwd_cuda
        inputs, cots = (g, gsq), cot
    else:
        fused = gather_reduce.gather_sub_minmax
        plain = gather_reduce.gather_sub_minmax_plain
        fwd = gather_reduce.gather_sub_minmax_cuda
        bwd = gather_reduce.gather_sub_minmax_bwd_cuda
        inputs, cots = (g, d), cot[:2]
    xs = [x.clone().requires_grad_(True) for x in inputs]
    before = (fwd.launches, bwd.launches)
    got = torch.autograd.grad(fused(*xs, idx, nmask), xs, cots)
    ref = torch.autograd.grad(plain(*xs, idx, nmask), xs, cots)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with torch.no_grad():  # no backward, no record
        fused(*xs, idx, nmask)
    assert bwd.launches == before[1] + 1


def test_pwmlp_wrappers_refuse():
    g, gsq, d, idx, nmask, cot = _pwmlp_inputs(20, 50, 9, 4, torch.float32,
                                               "distinct", 26)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gather_reduce.pwmlp_minmax_stats_cuda(g.double(), gsq.double(), idx,
                                              nmask)
    with pytest.raises(ValueError, match="dtype"):
        gather_reduce.pwmlp_minmax_stats_cuda(g, gsq.bfloat16(), idx, nmask)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_reduce.gather_sub_minmax_cuda(g, d.cpu(), idx, nmask)
    with pytest.raises(ValueError, match="contiguous"):
        gather_reduce.gather_sub_minmax_cuda(
            g.transpose(0, 1).contiguous().transpose(0, 1), d, idx, nmask)
    with pytest.raises(ValueError, match="int32"):
        gather_reduce.gather_sub_minmax_cuda(g, d, idx.long(), nmask)
    gmax, gmin, _, _ = gather_reduce.pwmlp_minmax_stats_cuda(g, gsq, idx,
                                                             nmask)
    with pytest.raises(ValueError, match="wrong dtype"):  # f32 cotangents
        gather_reduce.pwmlp_minmax_stats_bwd_cuda(
            g, idx, nmask, gmax, gmin, cot[0].bfloat16(), *cot[1:])
    with pytest.raises(ValueError, match="shapes"):
        gather_reduce.gather_sub_minmax_cuda(g, d[:, :10].contiguous(), idx,
                                             nmask)


# K13, the masked neighborhood sum, and the point-wise MLP's route through
# it
def _dup_neighborhoods(nq, ns, k, seed):
    """Ball-query neighborhoods (empty ones included) whose cloud 0 lists
    each valid slot's support row twice: the second half of its slots
    repeats the first."""
    _, _, idx, nmask = _neighborhoods(nq, ns, k, seed=seed)
    idx, nmask = idx.clone(), nmask.clone()
    half = k // 2
    idx[0, :, half:2 * half] = idx[0, :, :half]
    nmask[0, :, half:2 * half] = nmask[0, :, :half]
    return idx, nmask


def _nsum_check(f, idx, nmask, dy):
    """K13 forward equal to its plain version; backward equal to the twin
    run on CPU copies (both add in (q, t) order in f32 and round once; on
    CUDA tensors the twin's index_add_ adds in atomic order) and
    bit-identical across two launches."""
    b, nq, _ = idx.shape
    ns, c = f.shape[1:]
    out = gather_reduce.neighborhood_sum_cuda(f, idx, nmask)
    assert out.dtype == f.dtype and out.shape == (b, nq, c)
    # both add in f32 slot by slot in slot order and round once
    assert torch.equal(out, gather_reduce.neighborhood_sum_plain(f, idx,
                                                                 nmask))
    got = gather_reduce.neighborhood_sum_bwd_cuda(idx, nmask, dy, ns)
    assert got.dtype == dy.dtype and got.shape == (b, ns, c)
    twin = gather_reduce.neighborhood_sum_bwd_plain(
        idx.cpu(), nmask.cpu(), dy.cpu(), ns)
    assert torch.equal(got.cpu(), twin)
    assert torch.equal(gather_reduce.neighborhood_sum_bwd_cuda(
        idx, nmask, dy, ns), got)
    return out, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,ns,c,k", [
    (70, 300, 8, 1), (257, 500, 300, 20), (33, 90, 1152, MAX_K),
    (40, 5, 12, 8), (50, 60, 13, 33)])
# C off the vector width (12, 300 in bf16; 13) and at 1152; K > Ns
def test_neighborhood_sum_kernels_match_plain(dtype, nq, ns, c, k):
    idx, nmask = _dup_neighborhoods(nq, ns, k, seed=40)
    gen = torch.Generator(device="cuda").manual_seed(41)
    f = torch.randn((3, ns, c), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((3, nq, c), generator=gen, device="cuda").to(dtype)
    out, got = _nsum_check(f, idx, nmask, dy)
    assert (out[-1] == 0).all()  # the all-masked cloud
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_neighborhood_sum_kernels_take_odd_offset_views(dtype):
    """Contiguous views that start one element into their storage, so
    rows are not 16-byte aligned though C is a multiple of the vector
    width: the kernels take their scalar path."""
    nq, ns, c, k = 24, 40, 256, 16
    idx, nmask = _dup_neighborhoods(nq, ns, k, seed=45)
    gen = torch.Generator(device="cuda").manual_seed(46)
    fs = torch.randn(3 * ns * c + 1, generator=gen, device="cuda").to(dtype)
    ds = torch.randn(3 * nq * c + 1, generator=gen, device="cuda").to(dtype)
    f, dy = fs[1:].view(3, ns, c), ds[1:].view(3, nq, c)
    assert f.is_contiguous() and f.data_ptr() % 16 != 0
    _nsum_check(f, idx, nmask, dy)


def test_neighborhood_sum_bwd_is_one_device_kernel():
    """The profiler sees one device kernel per backward call (no fill of
    a scratch, no cast) and per forward call."""
    from torch.profiler import ProfilerActivity, profile

    idx, nmask = _dup_neighborhoods(8, 32, 41, seed=47)
    f = torch.randn((3, 32, 2304), device="cuda").bfloat16()
    dy = torch.randn((3, 8, 2304), device="cuda").bfloat16()
    for fn, args in ((gather_reduce.neighborhood_sum_cuda, (f, idx, nmask)),
                     (gather_reduce.neighborhood_sum_bwd_cuda,
                      (idx, nmask, dy, 32))):
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                fn(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 4 and len(set(names)) == 1, names


def test_autograd_launches_neighborhood_sum_kernels():
    idx, nmask = _dup_neighborhoods(60, 200, 16, seed=42)
    f = torch.randn((3, 200, 24), device="cuda", requires_grad=True)
    dy = torch.randn((3, 60, 24), device="cuda")
    fwd = gather_reduce.neighborhood_sum_cuda
    bwd = gather_reduce.neighborhood_sum_bwd_cuda
    before = (fwd.launches, bwd.launches)
    (got,) = torch.autograd.grad(
        gather_reduce.neighborhood_sum(f, idx, nmask), f, dy)
    (ref,) = torch.autograd.grad(
        gather_reduce.neighborhood_sum_plain(f, idx, nmask), f, dy)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        gather_reduce.neighborhood_sum(f, idx, nmask)
    assert bwd.launches == before[1] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq", [(8, 8), (5, 13), (1, 128)])
def test_pwmlp_route_on_the_card(dtype, b, nq):
    """K13 + K7 up to 64 queries in the batch, K6 from 65 on, launched as
    counted; the outputs and gradients equal the plain route's (CPU
    rule, same arithmetic)."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    s = torch.rand((b, 3 * nq, 3), generator=gen, device="cuda")
    smask = torch.ones((b, 3 * nq), dtype=torch.bool, device="cuda")
    idx, nmask = ball_query_cuda(s[:, :nq].contiguous(), s, 0.5, 16,
                                 smask[:, :nq].contiguous(), smask)
    g0 = torch.randn((b, 3 * nq, 24), generator=gen, device="cuda")
    cot = [torch.randn((b, nq, 24), generator=gen, device="cuda")
           for _ in range(4)]
    wrappers = {n: getattr(gather_reduce, n) for n in (
        "neighborhood_sum_cuda", "neighborhood_sum_bwd_cuda",
        "gather_sub_minmax_cuda", "gather_sub_minmax_bwd_cuda",
        "pwmlp_minmax_stats_cuda", "pwmlp_minmax_stats_bwd_cuda")}
    before = {n: fn.launches for n, fn in wrappers.items()}

    def run(fn):
        g = g0.to(dtype).clone().requires_grad_(True)
        gsq = (g0 * g0).to(dtype).requires_grad_(True)
        outs = fn(g, gsq, idx, nmask)
        torch.autograd.backward(outs, cot)
        return [o.detach() for o in outs], (g.grad, gsq.grad)

    outs, grads = run(gather_reduce.pwmlp_minmax_stats)
    small, large = int(b * nq <= 64), int(b * nq > 64)
    assert {n: fn.launches - before[n] for n, fn in wrappers.items()} == {
        "neighborhood_sum_cuda": small, "neighborhood_sum_bwd_cuda": small,
        "gather_sub_minmax_cuda": small,
        "gather_sub_minmax_bwd_cuda": small,
        "pwmlp_minmax_stats_cuda": large,
        "pwmlp_minmax_stats_bwd_cuda": large}
    cpu = [t.cpu() for t in (g0, idx, nmask)]

    def run_cpu(fn):
        g = cpu[0].to(dtype).clone().requires_grad_(True)
        gsq = (cpu[0] * cpu[0]).to(dtype).requires_grad_(True)
        o = fn(g, gsq, *cpu[1:])
        torch.autograd.backward(o, [c.cpu() for c in cot])
        return [x.detach() for x in o], (g.grad, gsq.grad)

    ref_outs, ref_grads = run_cpu(gather_reduce.pwmlp_minmax_stats)
    for o, r in zip(outs[:2], ref_outs[:2]):
        assert torch.equal(o.cpu(), r)
    for o, r in zip(outs[2:], ref_outs[2:]):
        if small:  # K13 and its plain version add in one order
            assert torch.equal(o.cpu(), r)
        else:  # K6 and its plain version round f64 sums once
            torch.testing.assert_close(o.cpu(), r, rtol=1e-6, atol=1e-6)
    for a, r in zip(grads, ref_grads):
        torch.testing.assert_close(a.float().cpu(), r.float(),
                                   **_pwmlp_bwd_tol(dtype))


def test_neighborhood_sum_wrappers_refuse():
    idx, nmask = _dup_neighborhoods(20, 50, 4, seed=44)
    f = torch.randn((3, 50, 9), device="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gather_reduce.neighborhood_sum_cuda(f.double(), idx, nmask)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_reduce.neighborhood_sum_cuda(f.cpu(), idx, nmask)
    with pytest.raises(ValueError, match="int32"):
        gather_reduce.neighborhood_sum_cuda(f, idx.long(), nmask)
    dy = torch.randn((3, 20, 9), device="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gather_reduce.neighborhood_sum_bwd_cuda(idx, nmask, dy.half(), 50)
    with pytest.raises(ValueError, match="shapes"):
        gather_reduce.neighborhood_sum_bwd_cuda(idx, nmask,
                                                  dy[:, :5].contiguous(), 50)
    with pytest.raises(ValueError, match="Ns >= 1"):
        gather_reduce.neighborhood_sum_bwd_cuda(idx, nmask, dy, 0)


def _kernel_points(kpn):
    kp = kernel_point_layout(kpn, "center" if kpn > 1 else "none")
    return (torch.from_numpy(kp).cuda(),
            1.2 * _typical_spacing(kp) if kpn > 1 else 0.7)


def _pgrid_tol(dtype):
    """Kernel vs plain version and twin: the same f32 terms summed in
    another order (slot order or atomics vs a matmul and index_add_), each
    rounded once; in bf16 one ulp where the orders straddle a rounding
    boundary."""
    return (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
            else dict(rtol=8e-3, atol=1e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["linear", "constant", "gaussian"])
@pytest.mark.parametrize("nq,ns,c,k,kpn", [
    (70, 300, 6, 8, 15), (257, 500, 72, 26, 15),
    (33, 90, 300, MAX_K, 15),   # C off the thread block, K at its bound
    (40, 5, 12, 8, 15),         # K > Ns
    (50, 200, 24, 16, 20),      # Kp over one register chunk of 16
    (50, 200, 10, 16, 1)])      # one kernel point
def test_pseudo_grid_kernels_match_plain(dtype, mode, nq, ns, c, k, kpn):
    q, s, idx, nmask = _neighborhoods(nq, ns, k, seed=30)
    kp, extent = _kernel_points(kpn)
    gen = torch.Generator(device="cuda").manual_seed(31)
    f = torch.randn((3, ns, c), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((3, nq, kpn * c), generator=gen,
                     device="cuda").to(dtype)
    args = (kp, 0.4, extent, mode)
    got = pseudo_grid_cuda(q, s, f, idx, nmask, *args)
    ref = pseudo_grid_plain(q, s, f, idx, nmask, *args)
    assert got.dtype == dtype and got.shape == (3, nq, kpn * c)
    tol = _pgrid_tol(dtype)
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    assert (got[-1] == 0).all()  # all-masked cloud: empty neighborhoods
    dg = pseudo_grid_bwd_cuda(q, s, idx, nmask, kp, dy, 0.4, extent, mode)
    twin = pseudo_grid_bwd_plain(q, s, idx, nmask, kp, dy, 0.4, extent, mode)
    assert dg.dtype == dtype and dg.shape == f.shape
    torch.testing.assert_close(dg.float(), twin.float(), **tol)
    x = f.detach().clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(
        pseudo_grid_plain(q, s, x, idx, nmask, *args), x, dy)
    torch.testing.assert_close(dg.float(), auto.float(), **tol)


def test_autograd_launches_pseudo_grid_kernels():
    q, s, idx, nmask = _neighborhoods(60, 200, 16, seed=32)
    kp, extent = _kernel_points(15)
    f = torch.randn((3, 200, 24), device="cuda", requires_grad=True)
    before = (pseudo_grid_cuda.launches, pseudo_grid_bwd_cuda.launches)
    dy = torch.randn((3, 60, 15 * 24), device="cuda")
    (got,) = torch.autograd.grad(pseudo_grid.pseudo_grid_fused(
        q, s, f, idx, nmask, kp, 0.4, extent, "linear"), f, dy)
    (ref,) = torch.autograd.grad(pseudo_grid_plain(
        q, s, f, idx, nmask, kp, 0.4, extent, "linear"), f, dy)
    assert (pseudo_grid_cuda.launches, pseudo_grid_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_pseudo_grid_wrappers_refuse():
    q, s, idx, nmask = _neighborhoods(20, 50, 4, seed=33)
    kp, extent = _kernel_points(15)
    f = torch.randn((3, 50, 9), device="cuda")
    with pytest.raises(ValueError, match="Kp=65"):
        pseudo_grid_cuda(q, s, f, idx, nmask, torch.zeros((65, 3),
                                                          device="cuda"),
                         0.4, extent, "linear")
    with pytest.raises(ValueError, match="KP_influence"):
        pseudo_grid_cuda(q, s, f, idx, nmask, kp, 0.4, extent, "cubic")
    with pytest.raises(ValueError, match="int32"):
        pseudo_grid_cuda(q, s, f, idx.long(), nmask, kp, 0.4, extent,
                         "linear")
    with pytest.raises(ValueError, match="CUDA tensor"):
        pseudo_grid_cuda(q, s, f, idx, nmask, kp.cpu(), 0.4, extent,
                         "linear")
    with pytest.raises(ValueError, match="dy must be"):
        pseudo_grid_bwd_cuda(q, s, idx, nmask, kp,
                             torch.randn((3, 20, 16), device="cuda"), 0.4,
                             extent, "linear")


# ---- the forward kernels' query-group layout (K10f, K5f, K1f, K9f) ----------

def _group_fwd_tol(dtype, reduction):
    """As test_pospool_kernel_matches_plain and
    test_sincos_and_moments_kernels_match_plain hold these forwards: the
    same f32 terms summed in slot order; in bf16 the plain version rounds
    each product."""
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-6 if reduction == "avg" else 1e-5)
    return dict(rtol=2e-2, atol=2e-2 if reduction == "avg" else 6e-2)


# name: (B, Nq, Ns, K, C, Kp)
GROUP_CASES = {
    "c_off_vector": (3, 37, 120, 16, 78, 15),  # Nq off the groups a block
    "stage4_split": (32, 19, 78, 39, 1152, 15),  # channels across groups
    "k64_kp64": (3, 20, 90, MAX_K, 24, 64),
}
# the forwards of PosPool xyz and the moments, taking (radius, reduction)
GROUP_OPS = {"sincos": (pospool_sincos_cuda, pospool_sincos_plain),
             "xyz": (pospool_xyz_cuda, pospool_xyz_plain),
             "moments": (neighborhood_moments_cuda,
                         neighborhood_moments_plain)}


def _group_forward(op, name, dtype, seed=70):
    """(kernel fn, plain fn, inputs but features, features, tol) of one
    group case; the last cloud all masked."""
    b, nq, ns, k, c, kpn = GROUP_CASES[name]
    s, smask = _cloud(seed, b, ns, masked_frac=0.2)
    q, qmask = _cloud(seed + 1, b, nq, masked_frac=0.1)
    idx, nmask = ball_query_cuda(q, s, 0.4, k, qmask, smask)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    f = torch.randn((b, ns, c), generator=gen, device="cuda").to(dtype)
    if op == "pseudo_grid":
        kp, extent = _kernel_points(kpn)
        return (pseudo_grid_cuda, pseudo_grid_plain,
                (q, s, idx, nmask, (kp, 0.4, extent, "linear")), f,
                _pgrid_tol(dtype))
    return (*GROUP_OPS[op], (q, s, idx, nmask, (0.4, "sum")), f,
            _group_fwd_tol(dtype, "sum"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(GROUP_CASES))
@pytest.mark.parametrize("op", ["pseudo_grid", "sincos", "xyz", "moments"])
def test_forward_query_groups_match_plain(op, name, dtype):
    fwd, plain, (q, s, idx, nmask, rest), f, tol = _group_forward(
        op, name, dtype)
    got = fwd(q, s, f, idx, nmask, *rest)
    ref = plain(q, s, f, idx, nmask, *rest)
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    assert (got[-1] == 0).all()  # the all-masked cloud
    assert torch.equal(_bits(fwd(q, s, f, idx, nmask, *rest)), _bits(got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["pseudo_grid", "sincos", "xyz", "moments"])
def test_forward_query_groups_take_unaligned_views(op, dtype):
    """Features as a view one element into a buffer (off 16 bytes: the
    scalar path) give the bits of their aligned copy."""
    fwd, plain, (q, s, idx, nmask, rest), f, tol = _group_forward(
        op, "c_off_vector", dtype, seed=73)
    flat = torch.empty(f.numel() + 1, dtype=dtype, device="cuda")
    view = flat[1:].view(f.shape)
    view.copy_(f)
    assert view.data_ptr() % 16 != 0
    got = fwd(q, s, view, idx, nmask, *rest)
    assert torch.equal(_bits(got), _bits(fwd(q, s, f, idx, nmask, *rest)))
    torch.testing.assert_close(got.float(),
                               plain(q, s, f, idx, nmask, *rest).float(),
                               **tol)


def _slot_order(op, q, s, f, idx, nmask, radius, reduction):
    """K1f's and K9f's sums as their parents' loops over all K slots ran
    them, in PyTorch on the card: for t = 0 .. K-1, each valid slot (mask
    set, idx >= 0) adds v * D (xyz, D of channel c's coordinate c / (C/3))
    or v and v * D[d] (moments) in f32 from +0, each product and sum a
    tensor op of its own (rounded, never fused); avg divides by
    max(valid slots, 1); one rounding to f's dtype."""
    valid = nmask & (idx >= 0)
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    v = grouping.group_features(f, safe).float()  # [B, Nq, K, C]
    dp = grouping.neighbor_offsets(q, s, safe, radius, f.dtype).float()
    if op == "xyz":
        terms = [v * dp.repeat_interleave(f.shape[-1] // 3, dim=-1)]
    else:
        terms = [v] + [v * dp[..., d:d + 1] for d in range(3)]
    acc = [torch.zeros_like(v[:, :, 0]) for _ in terms]
    for t in range(idx.shape[2]):
        live = valid[:, :, t, None]
        acc = [torch.where(live, a + x[:, :, t], a)
               for a, x in zip(acc, terms)]
    out = torch.cat(acc, dim=-1)
    if reduction == "avg":
        out = out / valid.sum(-1, keepdim=True).clamp(min=1).float()
    return out.to(f.dtype)


@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(GROUP_CASES) + ["s3dis_padding"])
@pytest.mark.parametrize("op", ["xyz", "moments"])
def test_xyz_and_moments_forwards_equal_slot_order(op, name, dtype,
                                                   reduction):
    """K1f and K9f keep their parents' arithmetic: bit for bit the
    slot-order f32 sums of ``_slot_order``, at the group cases (a few
    slots naming row -1 under a set mask, which the loops skip) and on
    an S3DIS-like stage: 2 x 4096 query slots of which ~17% hold points,
    the rest padding whose neighborhoods are all masked."""
    if name == "s3dis_padding":
        s, smask = _cloud(80, 2, 4096, masked_frac=0.83)
        s = s * smask[..., None]  # padding at the origin
        idx, nmask = ball_query_cuda(s, s, 0.4, 26, smask, smask)
        gen = torch.Generator(device="cuda").manual_seed(81)
        f = torch.randn((2, 4096, 72), generator=gen, device="cuda").to(dtype)
        q = s
        assert 0 < int(nmask.any(-1).sum()) < 2 * 4096 // 4
    else:
        _, _, (q, s, idx, nmask, _), f, _ = _group_forward(op, name, dtype)
        idx = idx.clone()
        idx[..., ::7] = torch.where(nmask[..., ::7], -1, idx[..., ::7])
    fwd = GROUP_OPS[op][0]
    got = fwd(q, s, f, idx, nmask, 0.4, reduction)
    ref = _slot_order(op, q, s, f, idx, nmask, 0.4, reduction)
    assert got.shape == ref.shape and got.float().abs().max() > 0.1
    assert torch.equal(_bits(got), _bits(ref))
    assert (got[~nmask.any(-1)] == 0).all()


# ---- the reverse neighbor index; the backward gathers of K6 and K10 ----------

def _gather_case(name, seed=60):
    """(q, s, idx, nmask) of a named neighborhood case, 3 clouds (the last
    all-masked): "ball" (ball-query neighborhoods, Nq = Ns), "ties" (grid
    clouds: duplicated points, exact ties), "strided" (60 queries over 500
    supports), "masked_queries" (cloud 0's even queries all masked),
    "unreached" (20 queries over 1000 supports: most rows unnamed) and
    "one_row" (every valid slot names support row 3: a row of hundreds)."""
    nq, ns, k = {"ball": (257, 257, 26), "ties": (200, 200, 20),
                 "strided": (60, 500, 32), "masked_queries": (120, 120, 16),
                 "unreached": (20, 1000, 16), "one_row": (40, 50, 24)}[name]
    grid = name == "ties"
    s, smask = _cloud(seed, 3, ns, masked_frac=0.2, grid=grid)
    q, qmask = (s, smask) if nq == ns else _cloud(seed + 1, 3, nq,
                                                  masked_frac=0.1, grid=grid)
    idx, nmask = ball_query_cuda(q, s, 0.5 if grid else 0.4, k, qmask, smask)
    if name == "masked_queries":
        nmask[0, ::2] = False
    if name == "one_row":
        idx = torch.full_like(idx, 3)
    return q, s, idx, nmask


GATHER_CASES = ["ball", "ties", "strided", "masked_queries", "unreached",
                "one_row"]


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _index_equal(idx, nmask, ns):
    """The reverse index kernel equal to its plain version: offsets, and
    each cloud's valid entries (the kernel sorts each row; the rest of
    slots is unused)."""
    off, slots = reverse_index_cuda(idx, nmask, ns)
    poff, pslots = reverse_index_plain(idx, nmask, ns)
    torch.cuda.synchronize()
    assert torch.equal(off, poff)
    for b in range(idx.shape[0]):
        n = int(off[b, -1])
        assert n == int(nmask[b].sum())
        assert torch.equal(slots[b, :n], pslots[b, :n])


@pytest.mark.parametrize("name", GATHER_CASES)
def test_reverse_index_kernel_equals_plain(name):
    _, s, idx, nmask = _gather_case(name)
    _index_equal(idx, nmask, s.shape[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 7, 72, 300, 1152])
@pytest.mark.parametrize("name", GATHER_CASES)
def test_pwmlp_stats_bwd_gather_equals_twin_to_the_bit(name, c, dtype):
    """K6b (reverse index, tie shares, a gather per support row) equal to
    ``pwmlp_minmax_stats_bwd_plain`` run on CPU copies, bit for bit with
    zero signs (both add in (q, t) order in f32 from +0 and round once;
    the twin's masked slots add +-0, which changes no such sum), and the
    same bits on a second launch. Grid values give ties."""
    _, s, idx, nmask = _gather_case(name)
    gen = torch.Generator(device="cuda").manual_seed(61)
    g32 = torch.round(2 * torch.randn((3, s.shape[1], c), generator=gen,
                                      device="cuda")) / 2
    g, gsq = g32.to(dtype), (g32 * g32).to(dtype)
    cot = [torch.randn((3, idx.shape[1], c), generator=gen, device="cuda")
           for _ in range(4)]
    gmax, gmin, _, _ = gather_reduce.pwmlp_minmax_stats_cuda(g, gsq, idx,
                                                             nmask)
    args = (g, idx, nmask, gmax, gmin, *cot)
    got = gather_reduce.pwmlp_minmax_stats_bwd_cuda(*args)
    again = gather_reduce.pwmlp_minmax_stats_bwd_cuda(*args)
    twin = gather_reduce.pwmlp_minmax_stats_bwd_plain(
        *(a.cpu() for a in args))
    torch.cuda.synchronize()
    for o, o2, r in zip(got, again, twin):
        assert o.dtype == dtype and o.shape == g.shape
        assert torch.equal(_bits(o.cpu()), _bits(r))
        assert torch.equal(_bits(o), _bits(o2))
        assert (o[-1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["linear", "gaussian"])
@pytest.mark.parametrize("c,kpn", [(1, 15), (7, 15), (72, 15), (300, 20),
                                   (1152, 15)])
@pytest.mark.parametrize("name", GATHER_CASES)
def test_pseudo_grid_bwd_gather_matches_twin(name, c, kpn, mode, dtype):
    """K10b (reverse index, a gather per support row) within the
    tolerance of ``pseudo_grid_bwd_plain`` (the same f32 slot terms; the
    sum over kernel points in fma order against a matmul's) and of
    autograd of the plain forward, and the same bits on a second
    launch."""
    q, s, idx, nmask = _gather_case(name)
    kp, extent = _kernel_points(kpn)
    gen = torch.Generator(device="cuda").manual_seed(62)
    dy = torch.randn((3, idx.shape[1], kpn * c), generator=gen,
                     device="cuda").to(dtype)
    args = (q, s, idx, nmask, kp, dy, 0.4, extent, mode)
    got = pseudo_grid_bwd_cuda(*args)
    again = pseudo_grid_bwd_cuda(*args)
    twin = pseudo_grid_bwd_plain(*args)
    assert got.dtype == dtype and got.shape == (3, s.shape[1], c)
    torch.testing.assert_close(got.float(), twin.float(), **_pgrid_tol(dtype))
    assert torch.equal(_bits(got), _bits(again))
    assert (got[-1] == 0).all()
    f = torch.zeros((3, s.shape[1], c), device="cuda", requires_grad=True)
    (auto,) = torch.autograd.grad(pseudo_grid_plain(
        q, s, f, idx, nmask, kp, 0.4, extent, mode), f, dy.float())
    torch.testing.assert_close(got.float(), auto, **_pgrid_tol(dtype))


@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 7, 72, 300, 1152])
@pytest.mark.parametrize("name", GATHER_CASES)
def test_moments_bwd_gather_equals_twin_to_the_bit(name, c, dtype,
                                                   reduction):
    """K9b (reverse index and, for avg, dy / max(count, 1) by query; then
    a gather per support row that recomputes each entry's term from its
    own position) equal to ``neighborhood_moments_bwd_plain`` run on CPU
    copies, bit for bit with zero signs (both add the same f32 terms in
    (q, t) order from +0 and round once), and the same bits on a second
    launch."""
    q, s, idx, nmask = _gather_case(name)
    gen = torch.Generator(device="cuda").manual_seed(66)
    dy = torch.randn((3, idx.shape[1], 4 * c), generator=gen,
                     device="cuda").to(dtype)
    args = (q, s, idx, nmask, dy, 0.4, reduction)
    got = neighborhood_moments_bwd_cuda(*args)
    again = neighborhood_moments_bwd_cuda(*args)
    twin = neighborhood_moments_bwd_plain(
        *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (3, s.shape[1], c)
    assert torch.equal(_bits(got.cpu()), _bits(twin))
    assert torch.equal(_bits(got), _bits(again))
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 9, 72, 300, 1152])
@pytest.mark.parametrize("name", GATHER_CASES)
def test_xyz_bwd_gather_equals_twin_to_the_bit(name, c, dtype, reduction):
    """K1b (reverse index and, for avg, dy / max(count, 1) by query; then a
    gather per support row that recomputes each entry's D from the row's
    own position; 16-byte units of one coordinate where C/3 allows them:
    72, 1152 and f32 300; else scalar) equal to ``pospool_xyz_bwd_plain``
    run on CPU copies, bit for bit with zero signs, and the same bits on a
    second launch."""
    q, s, idx, nmask = _gather_case(name)
    gen = torch.Generator(device="cuda").manual_seed(69)
    dy = torch.randn((3, idx.shape[1], c), generator=gen,
                     device="cuda").to(dtype)
    args = (q, s, idx, nmask, dy, 0.4, reduction)
    got = pospool_xyz_bwd_cuda(*args)
    again = pospool_xyz_bwd_cuda(*args)
    twin = pospool_xyz_bwd_plain(
        *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (3, s.shape[1], c)
    assert torch.equal(_bits(got.cpu()), _bits(twin))
    assert torch.equal(_bits(got), _bits(again))
    assert (got[-1] == 0).all()


def _sums_on_cpu(twin, *args):
    """``twin`` (a plain backward twin of ``ops/aggregation.py``) with its
    per-slot terms formed on the card and its ``scatter_to_support`` run on
    CPU copies of them: the terms keep CUDA's arithmetic (sinf and cosf of
    the angles), and ``index_add_`` on CPU tensors adds them in (q, t)
    order, as the gathers do, where on CUDA tensors it adds with atomics in
    an order that varies run to run."""
    def on_cpu(contrib, idx, ns):
        return grouping.scatter_to_support(contrib.cpu(), idx.cpu(), ns)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aggregation, "scatter_to_support", on_cpu)
        return twin(*args)


@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [6, 18, 72, 300, 1152])
@pytest.mark.parametrize("name", GATHER_CASES)
def test_sincos_bwd_gather_matches_twin(name, c, dtype, reduction):
    """K5b (as K9b, with each entry's angles and sincosf recomputed from
    the row's own position; 4, 2 or 1 frequencies a lane as C / 6 allows:
    72 and 1152, 300, 6 and 18) against ``pospool_sincos_bwd_plain`` with
    its terms formed on the card (CUDA's sinf and cosf of the same f32
    angles) and added on CPU copies in (q, t) order (``_sums_on_cpu``):
    within ``chip_smoke._bwd_tol`` and equal to the bit, and the same bits
    on a second launch. The twin run wholly on CPU copies takes torch's CPU
    sin and cos, an ulp from sincosf, which flipped the bf16 rounding of
    one term of one element in 1.7 million (1.3% of that element, whose
    terms cancel); run wholly on the card, its index_add_ adds with
    atomics, whose order moved one f32 element of 45000 by 1.24e-6 once."""
    import chip_smoke

    q, s, idx, nmask = _gather_case(name)
    gen = torch.Generator(device="cuda").manual_seed(67)
    dy = torch.randn((3, idx.shape[1], c), generator=gen,
                     device="cuda").to(dtype)
    args = (q, s, idx, nmask, dy, 0.4, reduction)
    got = pospool_sincos_bwd_cuda(*args)
    again = pospool_sincos_bwd_cuda(*args)
    twin = _sums_on_cpu(pospool_sincos_bwd_plain, *args)
    torch.cuda.synchronize()
    got = got.cpu()
    assert got.dtype == dtype and got.shape == (3, s.shape[1], c)
    torch.testing.assert_close(got.float(), twin.float(),
                               **chip_smoke._bwd_tol(dtype, reduction,
                                                     "sincos"))
    assert torch.equal(_bits(got), _bits(twin))
    assert torch.equal(_bits(got), _bits(again.cpu()))
    assert (got[-1] == 0).all()


# the backward gathers that recompute their terms: (kernel, dy channels
# per input channel)
RECOMPUTED_BWD = {"xyz": (pospool_xyz_bwd_cuda, 1),
                  "sincos": (pospool_sincos_bwd_cuda, 1),
                  "moments": (neighborhood_moments_bwd_cuda, 4)}


@pytest.mark.parametrize("op", sorted(RECOMPUTED_BWD))
def test_recomputed_gathers_take_unaligned_views(op):
    """dy a view at an odd element offset (sum: the gather reads dy
    itself, one value at a time): the bits of its aligned copy."""
    bwd, widen = RECOMPUTED_BWD[op]
    q, s, idx, nmask = _gather_case("ball")
    c = 72
    n = 3 * idx.shape[1] * c * widen
    gen = torch.Generator(device="cuda").manual_seed(68)
    base = torch.randn(n + 1, generator=gen, device="cuda").bfloat16()
    dy = base[1:].view(3, idx.shape[1], c * widen)
    assert dy.data_ptr() % 16 != 0
    for reduction in ("sum", "avg"):
        got = bwd(q, s, idx, nmask, dy, 0.4, reduction)
        ref = bwd(q, s, idx, nmask, dy.clone(), 0.4, reduction)
        assert torch.equal(_bits(got), _bits(ref))


_BWD_OPS = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from closerlook3d_tpu_torch.ops import (
    aggregation, gather_reduce, grouping, moments, pseudo_grid, sampling)
from closerlook3d_tpu_torch.ops.neighbors import ball_query_cuda
g = torch.Generator(device="cuda").manual_seed(0)
x = torch.rand((4, 2000, 3), generator=g, device="cuda")
m = torch.rand((4, 2000), generator=g, device="cuda") > 0.1
idx, nmask = ball_query_cuda(x, x, 0.1, 26, m, m)
f = torch.randn((4, 2000, 72), generator=g, device="cuda").bfloat16()
gmax, gmin, _, _ = gather_reduce.pwmlp_minmax_stats_cuda(f, f, idx, nmask)
cot = [torch.randn((4, 2000, 72), generator=g, device="cuda")
       for _ in range(4)]
kp = torch.rand((15, 3), generator=g, device="cuda")
dy = torch.randn((4, 2000, 15 * 72), generator=g, device="cuda").bfloat16()
dy5, dy9 = (torch.randn((4, 2000, w), generator=g, device="cuda").bfloat16()
            for w in (72, 4 * 72))
calls = {"pwmlp_stats_bwd": lambda: gather_reduce.pwmlp_minmax_stats_bwd_cuda(
             f, idx, nmask, gmax, gmin, *cot),
         "pospool_xyz_bwd": lambda: aggregation.pospool_xyz_bwd_cuda(
             x, x, idx, nmask, dy5, 0.1, "avg"),
         "pseudo_grid_bwd": lambda: pseudo_grid.pseudo_grid_bwd_cuda(
             x, x, idx, nmask, kp, dy, 0.1, 0.4, "linear"),
         "pospool_sincos_bwd": lambda: aggregation.pospool_sincos_bwd_cuda(
             x, x, idx, nmask, dy5, 0.1, "avg"),
         "moments_bwd": lambda: moments.neighborhood_moments_bwd_cuda(
             x, x, idx, nmask, dy9, 0.1, "avg"),
         "neighborhood_max_bwd": lambda: grouping.neighborhood_max_bwd_cuda(
             f, idx, nmask, out8, dy5),
         "fps": lambda: sampling.furthest_point_sample_cuda(x, 500, m)}
out8 = grouping.neighborhood_max_cuda(f, idx, nmask)
fn = calls[__import__("sys").argv[1]]
fn()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    for _ in range(4):
        fn()
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


@pytest.mark.parametrize("kernel", ["pwmlp_stats_bwd", "pseudo_grid_bwd",
                                    "pospool_xyz_bwd", "pospool_sincos_bwd",
                                    "moments_bwd", "neighborhood_max_bwd",
                                    "fps"])
def test_backward_gathers_run_their_device_ops_once_a_call(kernel):
    """K6b, K10b, K1b, K5b, K9b and K8b each run two device kernels once a
    call (the reverse index beside the per-slot terms, or for K1b, K5b and
    K9b beside avg's dy / max(count, 1), for K8b beside the tie quotients;
    then the gather) and nothing else on the device: no fill, no cast. FPS
    runs one. Profiled in a process of its
    own (see ``test_ball_query_device_ops_run_once_a_call``)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH"))
                           if p)
    out = subprocess.run([sys.executable, "-c", _BWD_OPS, kernel], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=path),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(set(names)) == (1 if kernel == "fps" else 2), names
    assert all(names.count(n) == 4 for n in names), names


def test_backward_gathers_count_in_global_memory_past_shared_memory():
    """Ns = 60000 outgrows the shared memory of the index's block, whose
    counters then live in global memory: the index alone still equals its
    plain version, K6b, K1b, K9b and K8b their twins on CPU copies to the bit,
    K10b its twin within tolerance and K5b its twin with the sums on CPU
    copies (``_sums_on_cpu``) within tolerance."""
    s, smask = _cloud(63, 2, 60000)
    q, qmask = _cloud(64, 2, 64)
    idx, nmask = ball_query_cuda(q, s, 0.2, 16, qmask, smask)
    _index_equal(idx, nmask, 60000)
    gen = torch.Generator(device="cuda").manual_seed(65)
    g = torch.round(2 * torch.randn((2, 60000, 8), generator=gen,
                                    device="cuda")) / 2
    cot = [torch.randn((2, 64, 8), generator=gen, device="cuda")
           for _ in range(4)]
    gmax, gmin, _, _ = gather_reduce.pwmlp_minmax_stats_cuda(g, g * g, idx,
                                                             nmask)
    args = (g, idx, nmask, gmax, gmin, *cot)
    got = gather_reduce.pwmlp_minmax_stats_bwd_cuda(*args)
    twin = gather_reduce.pwmlp_minmax_stats_bwd_plain(
        *(a.cpu() for a in args))
    for o, r in zip(got, twin):
        assert torch.equal(_bits(o.cpu()), _bits(r))
    kp, extent = _kernel_points(15)
    dy = torch.randn((2, 64, 15 * 8), generator=gen, device="cuda")
    pargs = (q, s, idx, nmask, kp, dy, 0.2, extent, "linear")
    torch.testing.assert_close(pseudo_grid_bwd_cuda(*pargs),
                               pseudo_grid_bwd_plain(*pargs),
                               **_pgrid_tol(torch.float32))
    for red in ("avg", "sum"):
        margs = (q, s, idx, nmask, cot[0].repeat(1, 1, 4), 0.2, red)
        assert torch.equal(
            _bits(neighborhood_moments_bwd_cuda(*margs).cpu()),
            _bits(neighborhood_moments_bwd_plain(
                *(a.cpu() if isinstance(a, torch.Tensor) else a
                  for a in margs))))
        sargs = (q, s, idx, nmask, cot[1][..., :6].contiguous(), 0.2, red)
        torch.testing.assert_close(pospool_sincos_bwd_cuda(*sargs).cpu(),
                                   _sums_on_cpu(pospool_sincos_bwd_plain,
                                                *sargs),
                                   rtol=1e-5, atol=1e-5)
        xargs = (q, s, idx, nmask, cot[2][..., :6].contiguous(), 0.2, red)
        assert torch.equal(
            _bits(pospool_xyz_bwd_cuda(*xargs).cpu()),
            _bits(pospool_xyz_bwd_plain(
                *(a.cpu() if isinstance(a, torch.Tensor) else a
                  for a in xargs))))
    out = neighborhood_max_cuda(g, idx, nmask)
    nargs = (g, idx, nmask, out, cot[3])
    assert torch.equal(_bits(neighborhood_max_bwd_cuda(*nargs).cpu()),
                       _bits(neighborhood_max_bwd_plain(
                           *(a.cpu() for a in nargs))))


@pytest.mark.parametrize("nq,ns,k,grid", [
    (100, 300, 1, False), (100, 300, 3, False),
    (64, 1500, MAX_KNN, False),  # k at its bound, supports across tiles
    (37, 5, 8, False),           # k > Ns: padded slots
    (200, 200, 3, True),         # duplicated points: exact ties
    (1, 1, 1, False)])
def test_knn_kernel_equals_plain(nq, ns, k, grid):
    # the last cloud's supports are all masked
    s, smask = _cloud(40, 3, ns, masked_frac=0.2, grid=grid)
    q, _ = _cloud(41, 3, nq, grid=grid)
    ki, kd = knn_cuda(q, s, k, smask)
    pi, pd = knn_plain(q, s, k, smask)
    torch.cuda.synchronize()
    assert ki.shape == kd.shape == (3, nq, k)
    assert torch.equal(ki, pi)
    assert torch.equal(kd, pd)  # d2 bit for bit
    ki, kd = knn_cuda(q, s, k)  # no mask: the wrapper supplies one
    pi, pd = knn_plain(q, s, k)
    assert torch.equal(ki, pi) and torch.equal(kd, pd)


def test_knn1_equals_plain_at_every_support_size():
    """The 1-NN at every Ns from 1 to 16384 (below 1024 the all-pairs
    kernel, from 1024 on the pruned search over tile boxes), on uniform
    clouds and on 0.25-grid clouds whose duplicated points tie across
    tiles, 20% of the supports masked and the last cloud all masked:
    indices and d2 equal to ``knn_plain``'s, bit for bit (lowest index on
    ties, masked supports tied at 1e10 where a cloud has no valid one)."""
    bad = []
    for grid in (False, True):
        s_all, m_all = _cloud(46 + grid, 3, 16384, masked_frac=0.2,
                              grid=grid)
        q, _ = _cloud(48 + grid, 3, 40, grid=grid)
        flags = []
        for ns in range(1, 16385):
            s = s_all[:, :ns].contiguous()
            sm = m_all[:, :ns].contiguous()
            ki, kd = neighbors.knn(q, s, 1, sm)
            pi, pd = knn_plain(q, s, 1, sm)
            flags.append((ki == pi).all() & (_bits(kd) == _bits(pd)).all())
        ok = torch.stack(flags).cpu()
        bad += [(grid, i + 1) for i in torch.nonzero(~ok).flatten().tolist()]
    assert not bad, bad[:20]


def test_knn_routes_as_the_jax_package():
    s, smask = _cloud(42, 2, 1100, masked_frac=0.3)
    q, _ = _cloud(43, 2, 500)
    before = (knn1_cuda.launches, knn_cuda.launches)
    ki, kd = neighbors.knn(q, s, 1, smask)  # k = 1, Ns >= 1024: K11's route
    pi, pd = knn_plain(q, s, 1, smask)
    assert torch.equal(ki, pi) and torch.equal(kd, pd)
    neighbors.knn(q, s[:, :1000].contiguous(), 1,
                  smask[:, :1000].contiguous())  # K12's
    neighbors.knn(q, s, 3, smask)  # K12's
    assert (knn1_cuda.launches, knn_cuda.launches) == (
        before[0] + 1, before[1] + 2)


def test_knn_wrappers_refuse():
    q, qmask = _cloud(44, 2, 50)
    with pytest.raises(ValueError, match="k 17"):
        knn_cuda(q, q, MAX_KNN + 1, qmask)
    with pytest.raises(ValueError, match="k 0"):
        knn_cuda(q, q, 0, qmask)
    with pytest.raises(ValueError, match="k must be 1"):
        knn1_cuda(q, q, 3, qmask)
    with pytest.raises(ValueError, match="bool"):
        knn_cuda(q, q, 2, qmask.int())


def test_grid_subsample_on_the_card_equals_the_cpu():
    s, smask = _cloud(45, 3, 3000, masked_frac=0.2)
    for cell, budget in ((0.1, 1200), (0.1, 300), (0.5, 64)):
        gx, gm = grid_subsample(s, cell, budget, smask)
        cx, cm = grid_subsample(s.cpu(), cell, budget, smask.cpu())
        assert torch.equal(gm.cpu(), cm) and torch.equal(gx.cpu(), cx)


def _op_cases():
    """(op, its arguments, the wrapper it launches or None, the wrapper's
    arguments) at small shapes on the card, f32 and bf16."""
    s, smask = _cloud(46, 3, 1200, masked_frac=0.2)
    q = s[:, :300].contiguous()
    qmask = smask[:, :300].contiguous()
    idx, nmask = ball_query_cuda(q, s, 0.3, 16, qmask, smask)
    gen = torch.Generator(device="cuda").manual_seed(47)
    f = torch.randn((3, 1200, 24), generator=gen, device="cuda")
    d = torch.randn((3, 300, 24), generator=gen, device="cuda")
    kp = torch.from_numpy(kernel_point_layout(15)).cuda()
    cases = [
        ("ball_query", (q, s, 0.3, 16, qmask, smask, None),
         ball_query_cuda, (q, s, 0.3, 16, qmask, smask)),
        ("furthest_point_sample", (s, 300, smask),
         furthest_point_sample_cuda, (s, 300, smask)),
        ("knn", (q, s, 1, smask, None), knn1_cuda, (q, s, 1, smask)),
        ("knn", (q, s, 3, smask, None), knn_cuda, (q, s, 3, smask)),
        ("grid_subsample", (s, 0.1, 400, smask), None, None),
    ]
    for dt in (torch.float32, torch.bfloat16):
        fd, dd = f.to(dt), d.to(dt)
        cases += [
            ("pospool", (q, s, fd, idx, nmask, 0.3, "xyz", "avg"),
             pospool_xyz_cuda, (q, s, fd, idx, nmask, 0.3, "avg")),
            ("pospool", (q, s, fd, idx, nmask, 0.3, "sin_cos", "sum"),
             pospool_sincos_cuda, (q, s, fd, idx, nmask, 0.3, "sum")),
            ("neighborhood_max", (fd, idx, nmask), neighborhood_max_cuda,
             (fd, idx, nmask)),
            ("neighborhood_moments", (q, s, fd, idx, nmask, 0.3, "avg"),
             neighborhood_moments_cuda, (q, s, fd, idx, nmask, 0.3, "avg")),
            ("gather_sub_minmax", (fd, dd, idx, nmask),
             gather_reduce.gather_sub_minmax_cuda, (fd, dd, idx, nmask)),
            ("pseudo_grid", (q, s, fd, idx, nmask, kp, 0.3, 0.5, "linear"),
             pseudo_grid_cuda, (q, s, fd, idx, nmask, kp, 0.3, 0.5,
                                "linear")),
        ]
    return cases


@pytest.mark.parametrize("case", range(17))
def test_cl3d_ops_launch_their_kernels(case):
    """Each ``cl3d`` op on CUDA tensors: its fake implementation describes
    the kernel's outputs (``opcheck``'s schema and fake-tensor tests run
    the op for real beside it), and a call launches the kernel once,
    giving the wrapper's bits."""
    name, args, wrapper, wargs = _op_cases()[case]
    op = getattr(torch.ops.cl3d, name).default
    torch.library.opcheck(op, args,
                          test_utils=("test_schema", "test_faketensor"))
    before = wrapper.launches if wrapper else None
    got = op(*args)
    torch.cuda.synchronize()
    if wrapper is None:  # plain PyTorch on every device
        want = op(*(a.cpu() if torch.is_tensor(a) else a for a in args))
        got = [t.cpu() for t in got]
    else:
        assert wrapper.launches == before + 1
        want = wrapper(*wargs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.is_contiguous()
        assert torch.equal(g, w)
