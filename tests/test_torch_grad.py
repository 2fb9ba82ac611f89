"""Port gradients on the CPU: the two kernel ops' backward vs the JAX package.

``pospool_fused`` (K1 forward + backward) and ``neighborhood_max`` (K8
forward + backward) run here as their plain PyTorch versions under
autograd; their backward kernels' plain twins
(``pospool_xyz_bwd_plain``, ``neighborhood_max_bwd_plain``) are held to
that autograd; and the ``torch.autograd.Function`` that carries the CUDA
kernels is driven with its launchers replaced by counting plain twins
(the rehearsal recipe of ``.claude/skills/verify/SKILL.md``), so the
wiring that would otherwise cut the graph is checked here. JAX runs its
jnp paths and, where named, its Pallas kernels in interpret mode. The
kernels themselves are held to the same twins on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.ops import grouping as jgrouping
from closerlook3d_tpu_torch.models import build_model
from closerlook3d_tpu_torch.models.heads import dropout
from closerlook3d_tpu_torch.ops import aggregation, grouping
from closerlook3d_tpu_torch.ops.neighbors import ball_query


@pytest.fixture(autouse=True)
def _jnp_reference(monkeypatch):
    # JAX entry points take their jnp path; Pallas calls run interpreted
    conftest.pallas_test_mode(monkeypatch, ops_impl="jnp")


@pytest.fixture(scope="module")
def cloud():
    """(query xyz, support xyz, idx, mask, radius) of a strided query:
    24 coarse points into a 96-point support, one cloud padded, with some
    empty neighborhoods."""
    rng = np.random.default_rng(21)
    xyz = rng.uniform(-1, 1, size=(2, 96, 3)).astype(np.float32)
    mask = np.ones((2, 96), bool)
    mask[1, 70:] = False
    q, qm = xyz[:, :24].copy(), mask[:, :24].copy()
    qm[0, 5] = False  # a masked query: all its slots invalid
    idx, nmask = ball_query(torch.from_numpy(q), torch.from_numpy(xyz), 0.35,
                            10, query_mask=torch.from_numpy(qm),
                            support_mask=torch.from_numpy(mask))
    nmask = nmask.numpy()
    assert (~nmask.any(-1)).any() and nmask.any(-1).any()
    return q, xyz, idx.numpy(), nmask, 0.35


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jnp_pospool(q, s, feats, idx, nmask, radius, reduction):
    """The JAX package's gather path (models/aggregation.py _pospool)."""
    f = jgrouping.group_features(feats, idx)
    pj = jgrouping.group_xyz(s, idx)
    dp = (pj - q[:, :, None, :]) / jnp.float32(radius)
    g = feats.shape[-1] // 3
    enc = jnp.concatenate([f[..., :g] * dp[..., 0:1],
                           f[..., g:2 * g] * dp[..., 1:2],
                           f[..., 2 * g:] * dp[..., 2:3]], -1)
    red = jgrouping.masked_avg if reduction == "avg" else jgrouping.masked_sum
    return red(enc, nmask)


def _port_vjp(fn, feats, dy):
    """(out, d<out, dy>/d feats) of fn(features) under torch autograd."""
    f = torch.from_numpy(feats).requires_grad_(True)
    out = fn(f)
    out.backward(torch.from_numpy(dy))
    return out.detach().numpy(), f.grad.numpy()


@pytest.mark.parametrize("reduction", ["avg", "sum"])
def test_pospool_feature_grad_matches_jax(cloud, reduction):
    q, s, idx, nmask, r = cloud
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 96, 12)).astype(np.float32)
    dy = rng.normal(size=(2, 24, 12)).astype(np.float32)
    qt, st, it, mt = _t(q, s, idx, nmask)
    out, grad = _port_vjp(lambda f: aggregation.pospool_fused(
        qt, st, f, it, mt, r, "xyz", reduction), feats, dy)

    args = [jnp.asarray(a) for a in (q, s, idx, nmask)]
    jout, vjp = jax.vjp(lambda f: _jnp_pospool(args[0], args[1], f, args[2],
                                               args[3], r, reduction),
                        jnp.asarray(feats))
    # same f32 products; the neighbor sums and the scatter associate
    # differently
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad, np.asarray(vjp(jnp.asarray(dy))[0]),
                               rtol=1e-5, atol=1e-5)

    from closerlook3d_tpu.ops.pallas.aggregation import (
        pospool_fused as jpospool_fused)
    _, pvjp = jax.vjp(lambda f: jpospool_fused(
        args[0], args[1], f, args[2], args[3], r, "xyz", reduction),
        jnp.asarray(feats))
    # the Pallas backward (_xyz_bwd_kernel, interpreted) multiplies by 1/r
    # and scatters through matmuls (tests/test_pallas_aggregation.py's
    # tolerance)
    np.testing.assert_allclose(grad, np.asarray(pvjp(jnp.asarray(dy))[0]),
                               rtol=1e-4, atol=1e-5)


def _tie_features(seed, shape):
    """Post-ReLU values on a 0.25 grid: many exact ties, zeros included."""
    rng = np.random.default_rng(seed)
    return np.maximum(np.round(rng.normal(size=shape) * 4) / 4,
                      0).astype(np.float32)


@pytest.mark.parametrize("values", ["ties", "distinct"])
def test_neighborhood_max_and_grad_match_jnp(cloud, values):
    _, s, idx, nmask, _ = cloud
    rng = np.random.default_rng(4)
    feats = (_tie_features(5, (2, 96, 10)) if values == "ties"
             else rng.normal(size=(2, 96, 10)).astype(np.float32))
    dy = rng.normal(size=(2, 24, 10)).astype(np.float32)
    it, mt = _t(idx, nmask)
    out, grad = _port_vjp(lambda f: grouping.neighborhood_max(f, it, mt),
                          feats, dy)
    jout, vjp = jax.vjp(lambda f: jgrouping.neighborhood_max(
        f, jnp.asarray(idx), jnp.asarray(nmask)), jnp.asarray(feats))
    np.testing.assert_array_equal(out, np.asarray(jout))
    # both split dy evenly over ties; the scatter sums associate
    # differently
    np.testing.assert_allclose(grad, np.asarray(vjp(jnp.asarray(dy))[0]),
                               rtol=1e-6, atol=1e-6)


def test_neighborhood_max_matches_pallas_kernel(cloud):
    """Against the TPU kernel pair (interpret mode) on distinct values,
    where its first-winner routing equals the even split."""
    from closerlook3d_tpu.ops.pallas.gather_reduce import (
        neighborhood_max as jmax_pallas)

    _, s, idx, nmask, _ = cloud
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(2, 96, 8)).astype(np.float32)
    dy = rng.normal(size=(2, 24, 8)).astype(np.float32)
    it, mt = _t(idx, nmask)
    out, grad = _port_vjp(lambda f: grouping.neighborhood_max(f, it, mt),
                          feats, dy)
    jout, vjp = jax.vjp(lambda f: jmax_pallas(f, jnp.asarray(idx),
                                              jnp.asarray(nmask)),
                        jnp.asarray(feats))
    # one-hot matmul gathers at HIGHEST precision are exact
    np.testing.assert_array_equal(out, np.asarray(jout))
    np.testing.assert_allclose(grad, np.asarray(vjp(jnp.asarray(dy))[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduction", ["avg", "sum"])
def test_pospool_bwd_twin_matches_autograd(cloud, dtype, reduction):
    q, s, idx, nmask, r = cloud
    rng = np.random.default_rng(7)
    qt, st, it, mt = _t(q, s, idx, nmask)
    f = torch.from_numpy(rng.normal(size=(2, 96, 9)).astype(np.float32)).to(
        dtype).requires_grad_(True)
    dy = torch.from_numpy(rng.normal(size=(2, 24, 9)).astype(
        np.float32)).to(dtype)
    aggregation.pospool_xyz_plain(qt, st, f, it, mt, r, reduction).backward(dy)
    twin = aggregation.pospool_xyz_bwd_plain(qt, st, it, mt, dy, r, reduction)
    assert twin.dtype == dtype and twin.shape == f.shape
    # f32: the same products, summed in another order. bf16: autograd
    # rounds each product and each partial sum to bf16, the twin sums in
    # f32 and rounds once
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(twin.float(), f.grad.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_neighborhood_max_bwd_twin_matches_autograd(cloud, dtype):
    _, s, idx, nmask, _ = cloud
    it, mt = _t(idx, nmask)
    f = torch.from_numpy(_tie_features(8, (2, 96, 11))).to(
        dtype).requires_grad_(True)
    dy = torch.randn((2, 24, 11), generator=torch.Generator().manual_seed(
        9)).to(dtype)
    out = grouping.neighborhood_max_plain(f, it, mt)
    out.backward(dy)
    twin = grouping.neighborhood_max_bwd_plain(f.detach(), it, mt,
                                               out.detach(), dy)
    # each share dy / n is rounded alike in both; only the sum over the
    # queries that share a winning row differs (f32 vs bf16 partials)
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-2))
    torch.testing.assert_close(twin.float(), f.grad.float(), **tol)


def _counting(fn):
    def wrapped(*args):
        wrapped.calls += 1
        return fn(*args)
    wrapped.calls = 0
    return wrapped


@pytest.fixture
def kernel_route(monkeypatch):
    """Send CPU tensors down the kernel route, with each CUDA launcher
    replaced by a counting wrapper around its plain twin."""
    fakes = {
        (aggregation, "pospool_xyz_cuda"): aggregation.pospool_xyz_plain,
        (aggregation, "pospool_xyz_bwd_cuda"):
            aggregation.pospool_xyz_bwd_plain,
        (grouping, "neighborhood_max_cuda"): grouping.neighborhood_max_plain,
        (grouping, "neighborhood_max_bwd_cuda"):
            grouping.neighborhood_max_bwd_plain,
    }
    counts = {}
    for (mod, name), plain in fakes.items():
        fake = _counting(plain)
        monkeypatch.setattr(mod, name, fake)
        counts[name] = fake
    for mod in (aggregation, grouping):
        monkeypatch.setattr(mod, "use_kernel", lambda t: True)
    return counts


def test_autograd_functions_route_through_the_kernels(cloud, kernel_route):
    q, s, idx, nmask, r = cloud
    rng = np.random.default_rng(10)
    qt, st, it, mt = _t(q, s, idx, nmask)
    feats = rng.normal(size=(2, 96, 6)).astype(np.float32)
    dy = rng.normal(size=(2, 24, 6)).astype(np.float32)
    for op, plain in (
            (lambda f: aggregation.pospool_fused(qt, st, f, it, mt, r, "xyz",
                                                 "avg"),
             lambda f: aggregation.pospool_xyz_plain(qt, st, f, it, mt, r,
                                                     "avg")),
            (lambda f: grouping.neighborhood_max(f, it, mt),
             lambda f: grouping.neighborhood_max_plain(f, it, mt))):
        out, grad = _port_vjp(op, feats, dy)
        ref, ref_grad = _port_vjp(plain, feats, dy)
        np.testing.assert_array_equal(out, ref)
        # the twins sum the scatter in f32 in another order than autograd
        np.testing.assert_allclose(grad, ref_grad, rtol=1e-6, atol=1e-6)
    assert {k: f.calls for k, f in kernel_route.items()} == {
        "pospool_xyz_cuda": 1, "pospool_xyz_bwd_cuda": 1,
        "neighborhood_max_cuda": 1, "neighborhood_max_bwd_cuda": 1}
    # no backward launch for features that need no gradient
    with torch.no_grad():
        grouping.neighborhood_max(torch.from_numpy(feats), it, mt)
    aggregation.pospool_fused(qt, st, torch.from_numpy(feats), it, mt, r,
                              "xyz", "sum").sum()
    assert kernel_route["pospool_xyz_bwd_cuda"].calls == 1
    assert kernel_route["neighborhood_max_bwd_cuda"].calls == 1


def _tiny_cfg():
    from closerlook3d_tpu_torch.utils.config import load_config

    cfg = load_config()
    cfg.update(num_points=64, num_classes=8, width=24, depth=1,
               nsamples=[8, 8, 8], radius=0.4, precision="f32",
               cls_head_dims=[32, 16], dropout_rate=0.0)
    return cfg


def test_model_gradients_reach_every_parameter_through_the_kernels(
        kernel_route, monkeypatch):
    """A train-mode backward of the whole model on the kernel route: every
    parameter gets the plain path's gradient, and each kernel launches
    once per op (6 PosPools and 2 strided shortcuts at this depth)."""
    cfg = _tiny_cfg()
    rng = np.random.default_rng(11)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (3, 64, 3)).astype(np.float32))
    mask = torch.ones((3, 64), dtype=torch.bool)
    mask[2, 40:] = False
    grads = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            for mod in (aggregation, grouping):
                monkeypatch.setattr(mod, "use_kernel", lambda t: False)
        model = build_model(cfg).train()
        model(xyz, mask, xyz).square().sum().backward()
        grads[route] = {n: p.grad.clone() for n, p in
                        model.named_parameters()}
    assert {k: f.calls for k, f in kernel_route.items()} == {
        "pospool_xyz_cuda": 6, "pospool_xyz_bwd_cuda": 6,
        "neighborhood_max_cuda": 2, "neighborhood_max_bwd_cuda": 2}
    for name, g in grads["kernel"].items():
        assert g.abs().sum() > 0, name
        # f32; the twins' scatters sum in another order than autograd
        torch.testing.assert_close(g, grads["plain"][name], rtol=1e-4,
                                   atol=1e-6, msg=name)


def test_dropout_draws_from_its_generator():
    x = torch.ones((4, 1000))
    a = dropout(x, 0.5, torch.Generator().manual_seed(1))
    b = dropout(x, 0.5, torch.Generator().manual_seed(1))
    c = dropout(x, 0.5, torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    # flax: kept values scaled by 1 / (1 - rate), dropped ones 0
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.45 < float((a > 0).float().mean()) < 0.55
    state = torch.get_rng_state()
    dropout(x, 0.5, torch.Generator().manual_seed(3))
    assert torch.equal(torch.get_rng_state(), state)  # global RNG untouched
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, None)
