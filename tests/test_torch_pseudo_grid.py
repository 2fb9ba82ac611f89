"""The pseudo-grid operator (K10) on the CPU, against the JAX package.

Seeded numpy inputs go through both packages: the kernel-point layout and
its spacing (numpy copies, equal bit for bit); the port's plain
``pseudo_grid_plain`` and its backward twin against JAX's Pallas
``pseudo_grid_fused`` run interpreted (forward and VJP), for the linear,
constant and gaussian influences; the port's ``LocalAggregation`` against
JAX's jnp gather path (``_pseudo_grid``, ``use_pallas="never"``) for every
influence and both convolution modes, with and without the output conv;
the ``autograd.Function`` that carries the CUDA kernels, driven with
counting plain twins in place of its launchers; the tiny flagship with
``configs/modelnet40/pseudo_grid.yaml``'s operator (logits, gradients and
three train steps against JAX's, ``run_tiny`` of
``tests/test_torch_operator_models.py``); and the config. The kernels
themselves are held to the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.models import aggregation as jagg
from closerlook3d_tpu.ops.pallas import pseudo_grid as jpseudo_grid
from closerlook3d_tpu.utils.config import load_config as jload_config
from closerlook3d_tpu_torch.models import aggregation as agg
from closerlook3d_tpu_torch.ops import pseudo_grid
from closerlook3d_tpu_torch.ops.neighbors import ball_query
from closerlook3d_tpu_torch.utils.config import Config, load_config
from test_torch_operator_models import run_tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("linear", "constant", "gaussian")
KPN = 15


@pytest.mark.parametrize("num,fixed", [(15, "center"), (15, "none"),
                                       (7, "center"), (1, "center")])
def test_kernel_point_layout_copy_matches_jax(num, fixed):
    got = agg.kernel_point_layout(num, fixed)
    ref = jagg.kernel_point_layout(num, fixed)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert agg._typical_spacing(got) == jagg._typical_spacing(ref)


@pytest.fixture(scope="module")
def cloud():
    """(query xyz, support xyz, idx, mask, radius, kp, extent): 24
    queries into a 96-point support, one cloud padded, one query masked,
    some empty neighborhoods, and neighbors out to |dp| ~ 1 so that every
    kernel point has some influence."""
    rng = np.random.default_rng(51)
    xyz = rng.uniform(-1, 1, size=(2, 96, 3)).astype(np.float32)
    mask = np.ones((2, 96), bool)
    mask[1, 70:] = False
    q, qm = xyz[:, :24].copy(), mask[:, :24].copy()
    qm[0, 5] = False
    idx, nmask = ball_query(torch.from_numpy(q), torch.from_numpy(xyz), 0.45,
                            12, query_mask=torch.from_numpy(qm),
                            support_mask=torch.from_numpy(mask))
    nmask = nmask.numpy()
    assert (~nmask.any(-1)).any() and nmask.any(-1).any()
    kp = agg.kernel_point_layout(KPN, "center")
    return q, xyz, idx.numpy(), nmask, 0.45, kp, agg._typical_spacing(kp)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _features(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module", params=MODES)
def pallas_vjp(request, cloud):
    """(mode, features, dy, JAX's Pallas forward, its VJP): the kernel
    interpreted on the CPU."""
    q, s, idx, nmask, r, kp, extent = cloud
    feats = _features(52, (2, 96, 6))
    dy = _features(53, (2, 24, KPN * 6))
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp)
        out, vjp = jax.vjp(lambda f: jpseudo_grid.pseudo_grid_fused(
            jnp.asarray(q), jnp.asarray(s), f, jnp.asarray(idx),
            jnp.asarray(nmask), jnp.asarray(kp), r, extent, request.param),
            jnp.asarray(feats))
        (grad,) = vjp(jnp.asarray(dy))
    return request.param, feats, dy, np.asarray(out), np.asarray(grad)


def test_pseudo_grid_plain_matches_pallas_kernel(cloud, pallas_vjp):
    q, s, idx, nmask, r, kp, extent = cloud
    mode, feats, dy, ref, ref_grad = pallas_vjp
    qt, st, it, mt, kpt = _t(q, s, idx, nmask, kp)
    f = torch.from_numpy(feats).requires_grad_(True)
    out = pseudo_grid.pseudo_grid_fused(qt, st, f, it, mt, kpt, r, extent,
                                        mode)
    out.backward(torch.from_numpy(dy))
    twin = pseudo_grid.pseudo_grid_bwd_plain(qt, st, it, mt, kpt,
                                             torch.from_numpy(dy), r, extent,
                                             mode)
    assert out.shape == ref.shape == (2, 24, KPN * 6)
    assert np.abs(ref).max() > 1.0 and (ref[0, 5] == 0).all()
    # f32; the same influence arithmetic (u = (s - q) * (1/r), d2 in
    # coordinate order; exp may differ in its last ulp), the slot sums
    # associate differently
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    # the VJP sums up to 12 slots x 15 kernel points per support row
    for grad in (f.grad.numpy(), twin.numpy()):
        np.testing.assert_allclose(grad, ref_grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_pseudo_grid_twin_matches_autograd_of_plain(cloud, mode, dtype):
    q, s, idx, nmask, r, kp, extent = cloud
    qt, st, it, mt, kpt = _t(q, s, idx, nmask, kp)
    f = torch.from_numpy(_features(54, (2, 96, 9))).to(dtype)
    dy = torch.from_numpy(_features(55, (2, 24, KPN * 9))).to(dtype)
    x = f.clone().requires_grad_(True)
    out = pseudo_grid.pseudo_grid_plain(qt, st, x, it, mt, kpt, r, extent,
                                        mode)
    assert out.dtype == dtype
    (auto,) = torch.autograd.grad(out, x, dy)
    twin = pseudo_grid.pseudo_grid_bwd_plain(qt, st, it, mt, kpt, dy, r,
                                             extent, mode)
    assert twin.dtype == dtype
    # both f32 products and scatters rounded once to dtype (autograd
    # through the plain version's f32 gather and matmul); bf16: one ulp
    # where the two sum orders straddle a rounding boundary
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=8e-3, atol=1e-5))
    torch.testing.assert_close(twin.float(), auto.float(), **tol)


def _counting(fn):
    def wrapped(*args):
        wrapped.calls += 1
        return fn(*args)
    wrapped.calls = 0
    return wrapped


def test_autograd_function_routes_through_the_kernels(cloud, monkeypatch):
    """CPU tensors down the kernel route, each CUDA launcher replaced by a
    counting wrapper around its plain twin: one forward and one backward
    launch, the plain autograd's gradient, none for positions."""
    q, s, idx, nmask, r, kp, extent = cloud
    fwd = _counting(pseudo_grid.pseudo_grid_plain)
    bwd = _counting(pseudo_grid.pseudo_grid_bwd_plain)
    monkeypatch.setattr(pseudo_grid, "pseudo_grid_cuda", fwd)
    monkeypatch.setattr(pseudo_grid, "pseudo_grid_bwd_cuda", bwd)
    monkeypatch.setattr(pseudo_grid, "use_kernel", lambda t: True)
    qt, st, it, mt, kpt = _t(q, s, idx, nmask, kp)
    qt.requires_grad_(True)
    f = torch.from_numpy(_features(56, (2, 96, 6))).requires_grad_(True)
    dy = torch.from_numpy(_features(57, (2, 24, KPN * 6)))
    out = pseudo_grid.pseudo_grid_fused(qt, st, f, it, mt, kpt, r, extent,
                                        "gaussian")
    got_q, got = torch.autograd.grad(out, (qt, f), dy, allow_unused=True)
    assert (fwd.calls, bwd.calls) == (1, 1)
    assert got_q is None
    x = f.detach().clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(pseudo_grid.pseudo_grid_plain(
        qt.detach(), st, x, it, mt, kpt, r, extent, "gaussian"), x, dy)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    with torch.no_grad():  # no backward, no record
        pseudo_grid.pseudo_grid_fused(qt, st, f, it, mt, kpt, r, extent,
                                      "linear")
    assert (fwd.calls, bwd.calls) == (2, 1)


def _operator_config(mode, conv, output_conv):
    cfg = load_config()
    cfg.local_aggregation_type = "pseudo_grid"
    cfg.precision = "f32"
    cfg.use_pallas = "never"
    cfg.pseudo_grid.KP_influence = mode
    cfg.pseudo_grid.convolution_mode = conv
    cfg.pseudo_grid.output_conv = output_conv
    return cfg


@pytest.mark.parametrize("mode,conv,output_conv", [
    ("linear", "sum", False), ("linear", "avg", True),
    ("constant", "sum", False), ("constant", "avg", False),
    ("gaussian", "sum", True), ("gaussian", "avg", False)])
def test_local_aggregation_matches_jax_jnp_path(cloud, mode, conv,
                                                output_conv):
    """The module against JAX's jnp ``_pseudo_grid`` (which divides by r,
    takes a norm, and sums with an einsum), from its own parameters; eval
    mode, with non-trivial BatchNorm statistics in the output conv."""
    q, s, idx, nmask, r, _, _ = cloud
    cfg = _operator_config(mode, conv, output_conv)
    jcfg = jload_config()
    for key in ("local_aggregation_type", "precision", "use_pallas"):
        jcfg[key] = cfg[key]
    for key, value in cfg.pseudo_grid.items():
        jcfg.pseudo_grid[key] = value
    feats = _features(58, (2, 96, 6))
    jmod = jagg.LocalAggregation(out_channels=8, radius=r, config=jcfg)
    args = (q, s, feats, idx, nmask)
    variables = jax.tree.map(np.asarray, dict(
        jmod.init(jax.random.PRNGKey(3), *args)))
    rng = np.random.default_rng(59)
    if output_conv:
        bs = variables["batch_stats"]["ConvBN_0"]["BatchNorm_0"]
        bs["mean"] = rng.normal(0, 0.2, 8).astype(np.float32)
        bs["var"] = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    ref = np.asarray(jmod.apply(variables, *args))

    mod = agg.LocalAggregation(6, 8, r, Config(cfg.to_dict())).eval()
    params = variables["params"]
    with torch.no_grad():
        mod.kernel_weights.weight.copy_(torch.from_numpy(
            params["kernel_weights"].T.copy()))
        if output_conv:
            conv_p, bn = params["ConvBN_0"], variables["batch_stats"][
                "ConvBN_0"]["BatchNorm_0"]
            oc = mod.output_conv
            oc.linear.weight.copy_(torch.from_numpy(
                conv_p["Dense_0"]["kernel"].T.copy()))
            oc.bn.weight.copy_(torch.tensor(conv_p["BatchNorm_0"]["scale"]))
            oc.bn.bias.copy_(torch.tensor(conv_p["BatchNorm_0"]["bias"]))
            oc.bn.running_mean.copy_(torch.tensor(bs["mean"]))
            oc.bn.running_var.copy_(torch.tensor(bs["var"]))
        else:
            assert mod.output_conv is None
        out = mod(*_t(q, s, feats, idx, nmask))
    assert out.shape == ref.shape == (2, 24, 8)
    assert np.abs(ref).max() > 0.1
    # f32; the influences agree to rounding (1/r vs /r, sqrt(d2) vs the
    # norm), the slot and weight sums associate differently
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_local_aggregation_refuses_unknown_settings():
    cfg = _operator_config("cubic", "sum", False)
    with pytest.raises(ValueError, match="KP_influence"):
        agg.LocalAggregation(6, 8, 0.4, cfg)
    cfg = _operator_config("linear", "max", False)
    with pytest.raises(ValueError, match="convolution_mode"):
        agg.LocalAggregation(6, 8, 0.4, cfg)


@pytest.fixture(scope="module")
def trained():
    return run_tiny("pgrid")


def test_pseudo_grid_model_eval_logits_match_jax(trained):
    got, ref = trained["logits"]
    assert got.shape == ref.shape == (8, 8)
    # f32 end to end; the influences agree to rounding, XLA and ATen sum
    # matmuls and neighborhoods in different orders
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_pseudo_grid_model_grads_match_jax(trained):
    tg, jg = trained["grads"]
    assert sorted(tg) == sorted(jg)
    assert sum(k.endswith("/kernel_weights") for k in jg) == 6
    for k in jg:
        assert np.abs(tg[k]).sum() > 0, k
        # the JAX package's cross-path tolerance: BN backward over the
        # 64-point batches amplifies reordering in small-norm gradients
        np.testing.assert_allclose(tg[k], jg[k], rtol=5e-4,
                                   atol=5e-5 * np.abs(jg[k]).max(),
                                   err_msg=k)


def test_pseudo_grid_model_losses_track_jax_over_steps(trained):
    tl, jl = trained["losses"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_pseudo_grid_config_matches_jax():
    path = os.path.join(REPO, "configs/modelnet40/pseudo_grid.yaml")
    cfg = load_config(path)
    assert cfg.to_dict() == jload_config(path).to_dict()
    assert cfg.local_aggregation_type == "pseudo_grid"
    assert cfg.pseudo_grid.num_kernel_points == 15
