"""Port ops (plain PyTorch versions, CPU) vs the JAX package's ops.

Inputs come from numpy seeds and go to both packages. The JAX side runs
its jnp reference paths and, where named, its Pallas kernels in interpret
mode. Integer outputs (neighbor indices, masks, FPS picks) must be equal;
float outputs agree within the tolerance stated at each test. The CUDA
kernels themselves are checked against these plain versions on the GPU by
``chip_smoke.py``; here their wrappers must refuse CPU tensors.
"""

import numpy as np
import pytest
import torch

import conftest
import jax.numpy as jnp

from closerlook3d_tpu.ops import grouping as jgrouping
from closerlook3d_tpu.ops.neighbors import ball_query as jball_query
from closerlook3d_tpu.ops.sampling import furthest_point_sample as jfps
from closerlook3d_tpu_torch.ops import grouping as tgrouping
from closerlook3d_tpu_torch.ops.aggregation import (
    pospool_fused, pospool_sincos_bwd_cuda, pospool_sincos_cuda,
    pospool_xyz_bwd_cuda, pospool_xyz_cuda)
from closerlook3d_tpu_torch.ops.dispatch import use_kernel
from closerlook3d_tpu_torch.ops.moments import (
    neighborhood_moments_bwd_cuda, neighborhood_moments_cuda)
from closerlook3d_tpu_torch.ops.neighbors import ball_query, ball_query_cuda
from closerlook3d_tpu_torch.ops.sampling import (
    furthest_point_sample, furthest_point_sample_cuda)


@pytest.fixture(autouse=True)
def _jnp_reference(monkeypatch):
    # JAX entry points take their jnp path; Pallas calls run interpreted
    conftest.pallas_test_mode(monkeypatch, ops_impl="jnp")


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    """The port's CPU math on one ATen thread. Multi-threaded, ATen splits
    sin/cos into chunks for MKL's vector math, and in a process that also
    runs XLA one chunk came back with errors up to ~1e-4 at the 100-rad
    angles of the sin/cos embedding in about one run in twenty (never
    reproduced on recomputation or on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cloud(case: str):
    """(query_xyz, query_mask, support_xyz, support_mask, radius, k)."""
    rng = np.random.default_rng(7)
    b, n = 2, 96
    xyz = rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    if case == "random":
        return xyz, mask, xyz, mask, 0.5, 8
    if case == "padded":
        mask[1, 70:] = False
        return xyz, mask, xyz, mask, 0.5, 8
    if case == "strided":  # coarse queries into the fine cloud
        mask[1, 70:] = False
        return xyz[:, :24], mask[:, :24], xyz, mask, 0.6, 12
    if case == "all_masked":
        mask[1] = False
        return xyz, mask, xyz, mask, 0.5, 8
    if case == "k_gt_ns":  # deep stage: fewer supports than K
        smask = mask[:, :5].copy()
        smask[0, 3] = False
        return xyz[:, :5], smask, xyz[:, :5], smask, 0.8, 8
    if case == "grid_ties":
        # coordinates on a 0.25 grid: duplicated points, exact distance
        # ties, and neighbors at exactly the radius (d2 = 0.25 = r2)
        g = rng.integers(-4, 5, size=(b, n, 3)).astype(np.float32) * 0.25
        g[:, 10:20] = g[:, :10]  # exact duplicates
        return g, mask, g, mask, 0.5, 16
    raise ValueError(case)


BQ_CASES = ["random", "padded", "strided", "all_masked", "k_gt_ns",
            "grid_ties"]


@pytest.mark.parametrize("case", BQ_CASES)
def test_ball_query_matches_jnp(case):
    q, qm, s, sm, r, k = _cloud(case)
    ji, jm = jball_query(jnp.asarray(q), jnp.asarray(s), r, k,
                         query_mask=jnp.asarray(qm),
                         support_mask=jnp.asarray(sm))
    ti, tm = ball_query(torch.from_numpy(q), torch.from_numpy(s), r, k,
                        query_mask=torch.from_numpy(qm),
                        support_mask=torch.from_numpy(sm))
    assert ti.dtype == torch.int32 and tm.dtype == torch.bool
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_ball_query_exact_radius_is_inside():
    # |q - s| = 0.5 exactly in f32: in radius at r = 0.5 (d2 <= r2)
    q = np.zeros((1, 1, 3), np.float32)
    s = np.array([[[0.5, 0, 0], [0, 0.5, 0], [0.75, 0, 0]]], np.float32)
    ti, tm = ball_query(torch.from_numpy(q), torch.from_numpy(s), 0.5, 4)
    np.testing.assert_array_equal(tm.numpy()[0, 0], [True, True, False,
                                                     False])
    np.testing.assert_array_equal(ti.numpy()[0, 0], [0, 1, 0, 0])
    ji, jm = jball_query(jnp.asarray(q), jnp.asarray(s), 0.5, 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("case", ["padded", "strided"])
def test_ball_query_matches_pallas_kernel(case):
    """Against the TPU kernel (interpret mode): masks equal, indices equal
    where the mask is True (the chunked kernel's shadow index of
    all-invalid rows may differ, ops/pallas/neighbors.py)."""
    from closerlook3d_tpu.ops.pallas.neighbors import ball_query_pallas

    q, qm, s, sm, r, k = _cloud(case)
    pi, pm = ball_query_pallas(jnp.asarray(q), jnp.asarray(s), r, k,
                               query_mask=jnp.asarray(qm),
                               support_mask=jnp.asarray(sm))
    ti, tm = ball_query(torch.from_numpy(q), torch.from_numpy(s), r, k,
                        query_mask=torch.from_numpy(qm),
                        support_mask=torch.from_numpy(sm))
    pm = np.asarray(pm)
    np.testing.assert_array_equal(tm.numpy(), pm)
    np.testing.assert_array_equal(ti.numpy()[pm], np.asarray(pi)[pm])


def test_ball_query_matches_chunked_pallas_kernel():
    from closerlook3d_tpu.ops.pallas.neighbors import (
        ball_query_pallas_chunked)

    rng = np.random.default_rng(12)
    xyz = rng.uniform(-1, 1, size=(1, 640, 3)).astype(np.float32)
    pi, pm = ball_query_pallas_chunked(jnp.asarray(xyz), jnp.asarray(xyz),
                                       0.35, 6)
    ti, tm = ball_query(torch.from_numpy(xyz), torch.from_numpy(xyz),
                        0.35, 6)
    pm = np.asarray(pm)
    np.testing.assert_array_equal(tm.numpy(), pm)
    np.testing.assert_array_equal(ti.numpy()[pm], np.asarray(pi)[pm])


def _fps_cloud(case: str):
    rng = np.random.default_rng(9)
    xyz = rng.uniform(-1, 1, size=(2, 96, 3)).astype(np.float32)
    mask = np.ones((2, 96), bool)
    npoint = 24
    if case == "padded":
        mask[1, 70:] = False
    elif case == "all_masked":
        mask[1] = False
    elif case == "duplicates":
        xyz = (rng.integers(-2, 3, size=xyz.shape) * 0.5).astype(np.float32)
    elif case == "npoint_gt_nvalid":
        mask[0, 10:] = False
        mask[1, 30:] = False
    return xyz, mask, npoint


@pytest.mark.parametrize(
    "case", ["padded", "all_masked", "duplicates", "npoint_gt_nvalid"])
def test_fps_matches_jnp(case):
    xyz, mask, npoint = _fps_cloud(case)
    ji, jm = jfps(jnp.asarray(xyz), npoint, jnp.asarray(mask))
    ti, tm = furthest_point_sample(torch.from_numpy(xyz), npoint,
                                   torch.from_numpy(mask))
    assert ti.dtype == torch.int32 and tm.dtype == torch.bool
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_fps_without_mask_matches_jnp():
    xyz, _, npoint = _fps_cloud("padded")
    ji, jm = jfps(jnp.asarray(xyz), npoint)
    ti, tm = furthest_point_sample(torch.from_numpy(xyz), npoint)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.fixture(scope="module")
def grouped():
    """Features, indices and masks from a padded cloud's ball query."""
    q, qm, s, sm, r, k = _cloud("padded")
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 96, 12)).astype(np.float32)
    idx, nmask = ball_query(torch.from_numpy(q), torch.from_numpy(s), 0.3, 6,
                            query_mask=torch.from_numpy(qm),
                            support_mask=torch.from_numpy(sm))
    nmask = nmask.numpy()
    assert (~nmask.any(-1)).any()  # some empty neighborhoods
    return q, feats, idx.numpy(), nmask, 0.3


@pytest.mark.parametrize("op", ["masked_max", "masked_sum", "masked_avg"])
def test_grouping_reductions_match_jnp(grouped, op):
    _, feats, idx, nmask, _ = grouped
    tg = tgrouping.group_features(torch.from_numpy(feats),
                                  torch.from_numpy(idx))
    jg = jgrouping.group_features(jnp.asarray(feats), jnp.asarray(idx))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    got = getattr(tgrouping, op)(tg, torch.from_numpy(nmask))
    ref = getattr(jgrouping, op)(jg, jnp.asarray(nmask))
    # same f32 arithmetic over <= 6 terms; sums may associate differently
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-7)


def test_neighborhood_max_matches_jnp(grouped):
    _, feats, idx, nmask, _ = grouped
    got = tgrouping.neighborhood_max(torch.from_numpy(feats),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(nmask))
    ref = jgrouping.neighborhood_max(jnp.asarray(feats), jnp.asarray(idx),
                                     jnp.asarray(nmask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jnp_pospool(xyz, feats, idx, nmask, radius, reduction):
    """The JAX package's gather path (models/aggregation.py _pospool)."""
    f = jgrouping.group_features(feats, idx)
    pj = jgrouping.group_xyz(xyz, idx)
    dp = (pj - xyz[:, :, None, :]) / jnp.float32(radius)
    g = feats.shape[-1] // 3
    enc = jnp.concatenate([f[..., :g] * dp[..., 0:1],
                           f[..., g:2 * g] * dp[..., 1:2],
                           f[..., 2 * g:] * dp[..., 2:3]], -1)
    red = jgrouping.masked_avg if reduction == "avg" else jgrouping.masked_sum
    return red(enc, nmask)


@pytest.mark.parametrize("reduction", ["avg", "sum"])
def test_pospool_xyz_matches_jnp_gather_path(grouped, reduction):
    q, feats, idx, nmask, r = grouped
    ref = _jnp_pospool(jnp.asarray(q), jnp.asarray(feats), jnp.asarray(idx),
                       jnp.asarray(nmask), r, reduction)
    x = torch.from_numpy(q)
    got = pospool_fused(x, x, torch.from_numpy(feats), torch.from_numpy(idx),
                        torch.from_numpy(nmask), r, "xyz", reduction)
    # same f32 ops; the neighbor sum may associate differently
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reduction", ["avg", "sum"])
def test_pospool_xyz_matches_pallas_kernel(grouped, reduction):
    from closerlook3d_tpu.ops.pallas.aggregation import (
        pospool_fused as jpospool_fused)

    q, feats, idx, nmask, r = grouped
    x = jnp.asarray(q)
    ref = jpospool_fused(x, x, jnp.asarray(feats), jnp.asarray(idx),
                         jnp.asarray(nmask), r, "xyz", reduction)
    xt = torch.from_numpy(q)
    got = pospool_fused(xt, xt, torch.from_numpy(feats),
                        torch.from_numpy(idx), torch.from_numpy(nmask), r,
                        "xyz", reduction)
    # the Pallas kernel multiplies by 1/r and sums through MXU matmuls
    # (tests/test_pallas_aggregation.py uses the same tolerance)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reduction", ["avg", "sum"])
def test_pospool_sin_cos_matches_jnp_gather_path(grouped, reduction):
    from closerlook3d_tpu.models.aggregation import sinusoidal_embedding

    q, feats, idx, nmask, r = grouped
    f = jgrouping.group_features(jnp.asarray(feats), jnp.asarray(idx))
    pj = jgrouping.group_xyz(jnp.asarray(q), jnp.asarray(idx))
    dp = (pj - jnp.asarray(q)[:, :, None, :]) / jnp.float32(r)
    red = jgrouping.masked_avg if reduction == "avg" else jgrouping.masked_sum
    # concrete before the port computes: the two runtimes never run at once
    ref = np.asarray(red(f * sinusoidal_embedding(dp, 12), jnp.asarray(nmask)))
    x = torch.from_numpy(q)
    got = pospool_fused(x, x, torch.from_numpy(feats), torch.from_numpy(idx),
                        torch.from_numpy(nmask), r, "sin_cos", reduction)
    # the same f32 angles (equal frequency tables at C = 12); sin/cos may
    # differ by an ulp between XLA and ATen, and the sums associate
    # differently
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="% 6"):
        pospool_fused(x, x, torch.from_numpy(feats[..., :9]),
                      torch.from_numpy(idx), torch.from_numpy(nmask), r,
                      "sin_cos", reduction)


def test_kernel_launchers_refuse_cpu_tensors(grouped):
    """Called directly, each CUDA wrapper raises on CPU tensors rather
    than falling back to its plain version, and counts no launch."""
    q, feats, idx, nmask, r = grouped
    x, f = torch.from_numpy(q), torch.from_numpy(feats)
    i, m = torch.from_numpy(idx), torch.from_numpy(nmask)
    wrappers = (ball_query_cuda, furthest_point_sample_cuda,
                pospool_xyz_cuda, pospool_xyz_bwd_cuda,
                pospool_sincos_cuda, pospool_sincos_bwd_cuda,
                neighborhood_moments_cuda, neighborhood_moments_bwd_cuda,
                tgrouping.neighborhood_max_cuda,
                tgrouping.neighborhood_max_bwd_cuda)
    before = [w.launches for w in wrappers]
    dy = torch.zeros((2, 96, 12))
    with pytest.raises(ValueError, match="CUDA"):
        ball_query_cuda(x, x, r, 6)
    with pytest.raises(ValueError, match="CUDA"):
        furthest_point_sample_cuda(x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        pospool_xyz_cuda(x, x, f, i, m, r, "avg")
    with pytest.raises(ValueError, match="CUDA"):
        pospool_xyz_bwd_cuda(x, x, i, m, dy, r, "avg")
    with pytest.raises(ValueError, match="CUDA"):
        pospool_sincos_cuda(x, x, f, i, m, r, "avg")
    with pytest.raises(ValueError, match="CUDA"):
        pospool_sincos_bwd_cuda(x, x, i, m, dy, r, "avg")
    with pytest.raises(ValueError, match="CUDA"):
        neighborhood_moments_cuda(x, x, f, i, m, r, "avg")
    with pytest.raises(ValueError, match="CUDA"):
        neighborhood_moments_bwd_cuda(x, x, i, m, torch.zeros((2, 96, 48)),
                                      r, "sum")
    with pytest.raises(ValueError, match="CUDA"):
        tgrouping.neighborhood_max_cuda(f, i, m)
    with pytest.raises(ValueError, match="CUDA"):
        tgrouping.neighborhood_max_bwd_cuda(f, i, m, dy, dy)
    assert [w.launches for w in wrappers] == before


def test_dispatch_follows_device_only(monkeypatch):
    monkeypatch.setenv("CL3D_OPS_IMPL", "pallas")  # JAX's switch: ignored
    assert use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(1, device="meta"))
