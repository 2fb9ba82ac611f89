"""Port operators on the CPU: PosPool sin/cos (K5) and the neighborhood
moments behind the adaptive weight (K9), against the JAX package.

Seeded numpy inputs go through both packages. The JAX side runs its jnp
gather paths and, where named, its Pallas kernels in interpret mode. The
port runs its plain versions; the backward kernels' plain twins are held
to autograd of the plain forwards; the ``autograd.Function``s that carry
the CUDA kernels are driven with counting plain twins in place of their
launchers. Then the tiny versions of both ModelNet40 configs
(``configs/modelnet40/{pospool_sincos_avg,adaptive_weight_dp_fc1_avg}
.yaml`` cut to the tiny flagship's size, f32) run logits, gradients and
three train steps against JAX's from converted weights, in
``tests/test_torch_operator_models.py``. The kernels themselves are held
to the plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.models.aggregation import sinusoidal_embedding
from closerlook3d_tpu.ops import grouping as jgrouping
from closerlook3d_tpu_torch.ops import aggregation, moments
from closerlook3d_tpu_torch.ops.neighbors import ball_query


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


@pytest.fixture(scope="module")
def cloud():
    """(query xyz, support xyz, idx, mask, radius): 24 coarse queries into
    a 96-point support, one cloud padded, one query masked, some empty
    neighborhoods, and neighbors out to |dp| ~ 0.95 (angles ~95 rad in
    the top sin/cos frequency)."""
    rng = np.random.default_rng(21)
    xyz = rng.uniform(-1, 1, size=(2, 96, 3)).astype(np.float32)
    mask = np.ones((2, 96), bool)
    mask[1, 70:] = False
    q, qm = xyz[:, :24].copy(), mask[:, :24].copy()
    qm[0, 5] = False
    idx, nmask = ball_query(torch.from_numpy(q), torch.from_numpy(xyz), 0.35,
                            10, query_mask=torch.from_numpy(qm),
                            support_mask=torch.from_numpy(mask))
    nmask = nmask.numpy()
    assert (~nmask.any(-1)).any() and nmask.any(-1).any()
    return q, xyz, idx.numpy(), nmask, 0.35


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _port_vjp(fn, feats, dy):
    """(out, d<out, dy>/d feats) of fn(features) under torch autograd."""
    f = torch.from_numpy(feats).requires_grad_(True)
    out = fn(f)
    out.backward(torch.from_numpy(dy))
    return out.detach().numpy(), f.grad.numpy()


def _jax_vjp(fn, feats, dy):
    out, vjp = jax.vjp(fn, jnp.asarray(feats))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(dy))[0])


def _jnp_sincos(q, s, feats, idx, nmask, radius, reduction):
    """The JAX package's gather path (models/aggregation.py _pospool)."""
    f = jgrouping.group_features(feats, idx)
    pj = jgrouping.group_xyz(s, idx)
    dp = (pj - q[:, :, None, :]) / jnp.float32(radius)
    red = jgrouping.masked_avg if reduction == "avg" else jgrouping.masked_sum
    return red(f * sinusoidal_embedding(dp, feats.shape[-1]), nmask)


def _inputs(cloud, seed, c, out_c):
    q, s, idx, nmask, r = cloud
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, 96, c)).astype(np.float32)
    dy = rng.normal(size=(2, 24, out_c)).astype(np.float32)
    return feats, dy, [jnp.asarray(a) for a in (q, s, idx, nmask)]


@pytest.mark.parametrize("reduction", ["avg", "sum"])
def test_pospool_sincos_and_grad_match_jax_gather_path(cloud, reduction):
    feats, dy, (jq, js, ji, jm) = _inputs(cloud, 3, 12, 12)
    qt, st, it, mt = _t(*cloud[:4])
    r = cloud[4]
    out, grad = _port_vjp(lambda f: aggregation.pospool_fused(
        qt, st, f, it, mt, r, "sin_cos", reduction), feats, dy)
    jout, jgrad = _jax_vjp(lambda f: _jnp_sincos(jq, js, f, ji, jm, r,
                                                 reduction), feats, dy)
    # f32 angles from equal frequency tables; sin/cos may differ by an ulp
    # between XLA and ATen, and the sums and the scatter associate
    # differently
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-5, atol=1e-5)


def test_pospool_sincos_matches_pallas_kernel(cloud):
    from closerlook3d_tpu.ops.pallas.aggregation import (
        pospool_fused as jpospool_fused)

    feats, dy, (jq, js, ji, jm) = _inputs(cloud, 4, 12, 12)
    qt, st, it, mt = _t(*cloud[:4])
    r = cloud[4]
    out, grad = _port_vjp(lambda f: aggregation.pospool_fused(
        qt, st, f, it, mt, r, "sin_cos", "avg"), feats, dy)
    jout, jgrad = _jax_vjp(lambda f: jpospool_fused(
        jq, js, f, ji, jm, r, "sin_cos", "avg"), feats, dy)
    # the TPU kernel (_sc_fwd_kernel / _sc_bwd_kernel, interpreted) sums
    # sin/cos of absolute angles and recombines them; the JAX package's
    # own tolerances for it (tests/test_pallas_aggregation.py)
    np.testing.assert_allclose(out, jout, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("reduction", ["avg", "sum"])
def test_moments_and_grad_match_pallas_kernel(cloud, reduction):
    from closerlook3d_tpu.ops.pallas.moments import (
        neighborhood_moments as jmoments)

    feats, dy, (jq, js, ji, jm) = _inputs(cloud, 5, 8, 32)
    qt, st, it, mt = _t(*cloud[:4])
    r = cloud[4]
    out, grad = _port_vjp(lambda f: moments.neighborhood_moments(
        qt, st, f, it, mt, r, reduction), feats, dy)
    assert out.shape == (2, 24, 32)
    jout, jgrad = _jax_vjp(lambda f: jmoments(jq, js, f, ji, jm, r,
                                              reduction), feats, dy)
    # the TPU kernel multiplies by 1/r and sums through MXU matmuls; the
    # JAX package's own tolerance (tests/test_pallas_moments.py)
    np.testing.assert_allclose(out, jout, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-4, atol=1e-5)


TWINS = {
    "sincos": (aggregation.pospool_sincos_plain,
               aggregation.pospool_sincos_bwd_plain, 1),
    "moments": (moments.neighborhood_moments_plain,
                moments.neighborhood_moments_bwd_plain, 4),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduction", ["avg", "sum"])
@pytest.mark.parametrize("op", sorted(TWINS))
def test_bwd_twins_match_autograd(cloud, op, dtype, reduction):
    plain, twin_fn, widen = TWINS[op]
    q, s, idx, nmask, r = cloud
    rng = np.random.default_rng(7)
    qt, st, it, mt = _t(q, s, idx, nmask)
    f = torch.from_numpy(rng.normal(size=(2, 96, 12)).astype(np.float32)).to(
        dtype).requires_grad_(True)
    dy = torch.from_numpy(rng.normal(size=(2, 24, 12 * widen)).astype(
        np.float32)).to(dtype)
    plain(qt, st, f, it, mt, r, reduction).backward(dy)
    twin = twin_fn(qt, st, it, mt, dy, r, reduction)
    assert twin.dtype == dtype and twin.shape == f.shape
    # f32: the same products, summed in another order. bf16: autograd
    # rounds each product and partial sum to bf16, the twin sums in f32
    # and rounds once
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=3e-2))
    torch.testing.assert_close(twin.float(), f.grad.float(), **tol)


def _counting(fn):
    def wrapped(*args):
        wrapped.calls += 1
        return fn(*args)
    wrapped.calls = 0
    return wrapped


@pytest.fixture
def kernel_route(monkeypatch):
    """CPU tensors down the kernel route of both new ops, each CUDA
    launcher replaced by a counting wrapper around its plain twin."""
    fakes = {
        (aggregation, "pospool_sincos_cuda"): aggregation.pospool_sincos_plain,
        (aggregation, "pospool_sincos_bwd_cuda"):
            aggregation.pospool_sincos_bwd_plain,
        (moments, "neighborhood_moments_cuda"):
            moments.neighborhood_moments_plain,
        (moments, "neighborhood_moments_bwd_cuda"):
            moments.neighborhood_moments_bwd_plain,
    }
    counts = {}
    for (mod, name), plain in fakes.items():
        fake = _counting(plain)
        monkeypatch.setattr(mod, name, fake)
        counts[name] = fake
    for mod in (aggregation, moments):
        monkeypatch.setattr(mod, "use_kernel", lambda t: True)
    return counts


def test_autograd_functions_route_through_the_kernels(cloud, kernel_route):
    q, s, idx, nmask, r = cloud
    qt, st, it, mt = _t(q, s, idx, nmask)
    feats, dy, _ = _inputs(cloud, 10, 12, 12)
    _, dy4, _ = _inputs(cloud, 11, 12, 48)
    for op, plain, g in (
            (lambda f: aggregation.pospool_fused(qt, st, f, it, mt, r,
                                                 "sin_cos", "avg"),
             lambda f: aggregation.pospool_sincos_plain(qt, st, f, it, mt, r,
                                                        "avg"), dy),
            (lambda f: moments.neighborhood_moments(qt, st, f, it, mt, r,
                                                    "sum"),
             lambda f: moments.neighborhood_moments_plain(qt, st, f, it, mt,
                                                          r, "sum"), dy4)):
        out, grad = _port_vjp(op, feats, g)
        ref, ref_grad = _port_vjp(plain, feats, g)
        np.testing.assert_array_equal(out, ref)
        # the twins sum the scatter in f32 in another order than autograd
        np.testing.assert_allclose(grad, ref_grad, rtol=1e-5, atol=1e-5)
    assert {k: f.calls for k, f in kernel_route.items()} == dict.fromkeys(
        kernel_route, 1)
    # no backward launch for features that need no gradient
    with torch.no_grad():
        moments.neighborhood_moments(qt, st, torch.from_numpy(feats), it, mt,
                                     r, "avg")
    aggregation.pospool_fused(qt, st, torch.from_numpy(feats), it, mt, r,
                              "sin_cos", "sum").sum()
    assert kernel_route["pospool_sincos_bwd_cuda"].calls == 1
    assert kernel_route["neighborhood_moments_bwd_cuda"].calls == 1
