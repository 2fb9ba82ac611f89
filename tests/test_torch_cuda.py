"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips without a CUDA device. On a machine
with one:

    python -m pytest tests/test_torch_cuda.py -q

``chip_smoke.py`` checks the kernels at the shapes of the flagship
forward and of the ModelNet40 train step; these cases cover what those
paths do not reach: FPS beyond 1024 points (several points per thread),
query counts off the block size, supports across shared-memory tile
edges, K at its bound and above Ns, channel counts off the thread block
(C = 3, 300, 1152), masked queries and empty neighborhoods, f32 and
bf16, the backward kernels (PosPool and neighborhood max, ties
included), the autograd wiring, and the wrappers' refusals.
"""

import numpy as np
import pytest
import torch

from closerlook3d_tpu_torch.ops import aggregation, grouping
from closerlook3d_tpu_torch.ops.aggregation import (
    pospool_xyz_bwd_cuda, pospool_xyz_bwd_plain, pospool_xyz_cuda,
    pospool_xyz_plain)
from closerlook3d_tpu_torch.ops.grouping import (
    neighborhood_max_bwd_cuda, neighborhood_max_bwd_plain,
    neighborhood_max_cuda, neighborhood_max_plain)
from closerlook3d_tpu_torch.ops.neighbors import (
    MAX_K, ball_query_cuda, ball_query_plain)
from closerlook3d_tpu_torch.ops.sampling import (
    furthest_point_sample_cuda, furthest_point_sample_plain)

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
    q, s, idx, nmask = _neighborhoods(nq, ns, k)
    gen = torch.Generator(device="cuda").manual_seed(11)
    dy = torch.randn((3, nq, c), generator=gen, device="cuda").to(dtype)
    got = pospool_xyz_bwd_cuda(q, s, idx, nmask, dy, 0.4, reduction)
    twin = pospool_xyz_bwd_plain(q, s, idx, nmask, dy, 0.4, reduction)
    assert got.dtype == dtype and got.shape == (3, ns, c)
    if dtype == torch.float32:
        # the same f32 terms, summed in atomic order
        tol = dict(rtol=1e-5, atol=1e-6 if reduction == "avg" else 1e-5)
    else:
        # both sum in f32 and round once: one bf16 ulp at most
        tol = dict(rtol=8e-3, atol=1e-5)
    torch.testing.assert_close(got.float(), twin.float(), **tol)
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
    got = neighborhood_max_bwd_cuda(f, idx, nmask, out, dy)
    twin = neighborhood_max_bwd_plain(f, idx, nmask, out, dy)
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32
           else dict(rtol=8e-3, atol=1e-5))
    torch.testing.assert_close(got.float(), twin.float(), **tol)


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
