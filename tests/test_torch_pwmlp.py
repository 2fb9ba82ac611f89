"""The port's point-wise MLP on the CPU, against the JAX package.

Seeded numpy inputs go through both packages:

* the two ops of ``ops/gather_reduce.py`` (their plain versions), forward
  and VJP, against JAX's ``ops/pallas/gather_reduce.py`` kernels run in
  interpret mode (K6 ``pwmlp_minmax_stats``, K7 ``gather_sub_minmax``);
* the backward kernels' plain twins against autograd of the plain
  forwards, ties included, and the ``autograd.Function``s that carry the
  CUDA kernels, driven with counting plain twins in place of their
  launchers;
* ``LocalAggregation`` with the point-wise MLP in train and eval mode
  against JAX's gather path and its factorized path (interpreted):
  outputs, updated running statistics and gradients; one gather-path
  setting (two FCs, avg); PosPool's max reduction;
* the tiny flagship with ``configs/modelnet40/pointwisemlp_dp_fi_df_fc1_
  max.yaml``'s operator settings (f32, dropout 0): eval logits,
  first-step gradients and three train steps against JAX's, and the
  weight bridge's round trip.

The CUDA kernels themselves are held to the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.models.aggregation import (
    LocalAggregation as JLocalAggregation)
from closerlook3d_tpu.ops.pallas import gather_reduce as jgather_reduce
from closerlook3d_tpu.utils.config import load_config as jload_config
from closerlook3d_tpu_torch.convert import (
    flatten_variables, flax_to_state_dict, state_dict_to_flax)
from closerlook3d_tpu_torch.models import build_model
from closerlook3d_tpu_torch.models.aggregation import LocalAggregation
from closerlook3d_tpu_torch.ops import gather_reduce
from closerlook3d_tpu_torch.ops.neighbors import ball_query
from closerlook3d_tpu_torch.utils.config import Config
from test_torch_operator_models import run_tiny

# the shapes of tests/test_pallas_pwmlp.py
B, N, K, C, COUT = 2, 64, 6, 8, 16
RADIUS = 0.5


@pytest.fixture(scope="module")
def cloud():
    """(xyz, idx, mask): one cloud padded from point 50 on, so its last
    queries have empty neighborhoods."""
    rng = np.random.default_rng(9)
    xyz = rng.uniform(-1, 1, size=(B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[0, 50:] = False
    pm = torch.from_numpy(mask)
    idx, nmask = ball_query(torch.from_numpy(xyz), torch.from_numpy(xyz),
                            RADIUS, K, query_mask=pm, support_mask=pm)
    nmask = nmask.numpy()
    assert (~nmask.any(-1)).any() and (nmask.sum(-1) > 1).any()
    return xyz, idx.numpy(), nmask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---- (a) the ops against JAX's Pallas kernels, interpreted --------------------

@pytest.fixture(scope="module")
def jax_ops(cloud):
    """JAX's K6 and K7 forward and VJP on one set of seeded inputs."""
    _, idx, mask = cloud
    g, d = _normal(11, B, N, COUT), _normal(12, B, N, COUT)
    cot = [_normal(13 + i, B, N, COUT) for i in range(4)]
    ji, jm = jnp.asarray(idx), jnp.asarray(mask)
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp)
        stats, vjp6 = jax.vjp(
            lambda a, b: jgather_reduce.pwmlp_minmax_stats(a, b, ji, jm),
            jnp.asarray(g), jnp.asarray(g * g))
        grads6 = vjp6(tuple(jnp.asarray(c) for c in cot))
        mm, vjp7 = jax.vjp(
            lambda a, b: jgather_reduce.gather_sub_minmax(a, b, ji, jm),
            jnp.asarray(g), jnp.asarray(d))
        grads7 = vjp7(tuple(jnp.asarray(c) for c in cot[:2]))
    return {"g": g, "d": d, "cot": cot,
            "k6": ([np.asarray(o) for o in stats],
                   [np.asarray(o) for o in grads6]),
            "k7": ([np.asarray(o) for o in mm],
                   [np.asarray(o) for o in grads7])}


def _close_extrema(got, ref):
    # the JAX tests' own tolerance for max/min (tests/test_pallas_pwmlp.py)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def _close_sums(got, ref):
    # ... and for sums and gradients
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_pwmlp_minmax_stats_and_vjp_match_pallas_kernel(cloud, jax_ops):
    _, idx, mask = cloud
    it, mt = _t(idx, mask)
    g = torch.from_numpy(jax_ops["g"]).requires_grad_(True)
    gsq = (g * g).detach().requires_grad_(True)
    outs = gather_reduce.pwmlp_minmax_stats(g, gsq, it, mt)
    torch.autograd.backward(outs, [torch.from_numpy(c)
                                   for c in jax_ops["cot"]])
    (jmax, jmin, js1, js2), (jdg, jdgsq) = jax_ops["k6"]
    empty = ~mask.any(-1)
    for o, r, extremum in zip(outs, (jmax, jmin, js1, js2),
                              (True, True, False, False)):
        o = o.detach().numpy()
        assert o.dtype == np.float32 and o.shape == (B, N, COUT)
        assert np.all(o[empty] == 0.0)  # never a sentinel
        (_close_extrema if extremum else _close_sums)(o, r)
    _close_sums(g.grad.numpy(), jdg)
    _close_sums(gsq.grad.numpy(), jdgsq)


def test_gather_sub_minmax_and_vjp_match_pallas_kernel(cloud, jax_ops):
    _, idx, mask = cloud
    it, mt = _t(idx, mask)
    g = torch.from_numpy(jax_ops["g"]).requires_grad_(True)
    d = torch.from_numpy(jax_ops["d"]).requires_grad_(True)
    hmax, hmin = gather_reduce.gather_sub_minmax(g, d, it, mt)
    torch.autograd.backward(
        (hmax, hmin), [torch.from_numpy(c) for c in jax_ops["cot"][:2]])
    (jmax, jmin), (jdg, jdd) = jax_ops["k7"]
    empty = ~mask.any(-1)
    for o, r in ((hmax, jmax), (hmin, jmin)):
        o = o.detach().numpy()
        assert np.all(o[empty] == 0.0)
        _close_extrema(o, r)
    _close_sums(g.grad.numpy(), jdg)
    _close_sums(d.grad.numpy(), jdd)


# ---- (b) the backward twins against autograd of the plain forwards -----------

def _tie_values(seed, *shape):
    """Values on a coarse grid: many exact ties in every neighborhood."""
    return np.round(_normal(seed, *shape) * 1.5) / 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("values", ["ties", "distinct"])
def test_bwd_twins_match_autograd(cloud, dtype, values):
    _, idx, mask = cloud
    it, mt = _t(idx, mask)
    make = _tie_values if values == "ties" else _normal
    g = torch.from_numpy(make(20, B, N, COUT)).to(dtype).requires_grad_(True)
    gsq = (g.detach().float() ** 2).to(dtype).requires_grad_(True)
    d = torch.from_numpy(make(21, B, N, COUT)).to(dtype).requires_grad_(True)
    cot = [torch.from_numpy(_normal(22 + i, B, N, COUT)) for i in range(4)]
    # f32 sums in another order; bf16: both scatter in f32 and round once
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=8e-3, atol=1e-5))

    outs = gather_reduce.pwmlp_minmax_stats_plain(g, gsq, it, mt)
    torch.autograd.backward(outs, cot)
    dg, dgsq = gather_reduce.pwmlp_minmax_stats_bwd_plain(
        g.detach(), it, mt, outs[0].detach(), outs[1].detach(), *cot)
    assert dg.dtype == dgsq.dtype == dtype and dg.shape == g.shape
    torch.testing.assert_close(dg.float(), g.grad.float(), **tol)
    torch.testing.assert_close(dgsq.float(), gsq.grad.float(), **tol)

    g.grad = None
    hmax, hmin = gather_reduce.gather_sub_minmax_plain(g, d, it, mt)
    torch.autograd.backward((hmax, hmin), cot[:2])
    dg, dd = gather_reduce.gather_sub_minmax_bwd_plain(
        g.detach(), d.detach(), it, mt, hmax.detach(), hmin.detach(),
        *cot[:2])
    assert dg.dtype == dd.dtype == dtype and dd.shape == d.shape
    torch.testing.assert_close(dg.float(), g.grad.float(), **tol)
    torch.testing.assert_close(dd.float(), d.grad.float(), **tol)


def test_extremum_cotangent_splits_evenly_over_ties():
    """Three slots, two tying at the max: each gets half of dmax."""
    g = torch.tensor([[[1.0], [1.0], [0.0]]])
    idx = torch.tensor([[[0, 1, 2]]], dtype=torch.int32)
    mask = torch.ones((1, 1, 3), dtype=torch.bool)
    one, zero = torch.ones((1, 1, 1)), torch.zeros((1, 1, 1))
    gmax, gmin, _, _ = gather_reduce.pwmlp_minmax_stats_plain(g, g * g, idx,
                                                              mask)
    dg, dgsq = gather_reduce.pwmlp_minmax_stats_bwd_plain(
        g, idx, mask, gmax, gmin, one, 4 * one, zero, one)
    assert dg.flatten().tolist() == [0.5, 0.5, 4.0]
    assert dgsq.flatten().tolist() == [1.0, 1.0, 1.0]
    d = torch.full((1, 1, 1), 0.25)
    hmax, hmin = gather_reduce.gather_sub_minmax_plain(g, d, idx, mask)
    dg, dd = gather_reduce.gather_sub_minmax_bwd_plain(
        g, d, idx, mask, hmax, hmin, one, 4 * one)
    assert dg.flatten().tolist() == [0.5, 0.5, 4.0]
    assert dd.flatten().tolist() == [-5.0]


# ---- (c) the autograd.Functions, with counting plain launchers -----------------

def _counting(fn):
    def wrapped(*args):
        wrapped.calls += 1
        return fn(*args)
    wrapped.calls = 0
    return wrapped


@pytest.fixture
def kernel_route(monkeypatch):
    """CPU tensors down the kernel route, each CUDA launcher replaced by a
    counting wrapper around its plain version or twin."""
    counts = {}
    for name in ("pwmlp_minmax_stats", "gather_sub_minmax"):
        for suffix in ("", "_bwd"):
            fake = _counting(getattr(gather_reduce, f"{name}{suffix}_plain"))
            monkeypatch.setattr(gather_reduce, f"{name}{suffix}_cuda", fake)
            counts[f"{name}{suffix}_cuda"] = fake
    monkeypatch.setattr(gather_reduce, "use_kernel", lambda t: True)
    return counts


def test_autograd_functions_route_through_the_kernels(cloud, kernel_route):
    _, idx, mask = cloud
    it, mt = _t(idx, mask)
    g0, d0 = _normal(30, B, N, COUT), _normal(31, B, N, COUT)
    cot = [torch.from_numpy(_normal(32 + i, B, N, COUT)) for i in range(4)]

    def run(stats, minmax):
        g = torch.from_numpy(g0).requires_grad_(True)
        gsq = torch.from_numpy(g0 * g0).requires_grad_(True)
        d = torch.from_numpy(d0).requires_grad_(True)
        outs = stats(g, gsq, it, mt) + minmax(g, d, it, mt)
        torch.autograd.backward(outs, cot + cot[:2])
        return [o.detach() for o in outs], (g.grad, gsq.grad, d.grad)

    outs, grads = run(gather_reduce.pwmlp_minmax_stats,
                      gather_reduce.gather_sub_minmax)
    ref_outs, ref_grads = run(gather_reduce.pwmlp_minmax_stats_plain,
                              gather_reduce.gather_sub_minmax_plain)
    for o, r in zip(outs, ref_outs):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    for o, r in zip(grads, ref_grads):
        # the twins scatter in f32 in another order than autograd
        torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-5)
    assert {k: f.calls for k, f in kernel_route.items()} == dict.fromkeys(
        kernel_route, 1)
    # no backward launch where nothing needs a gradient
    g = torch.from_numpy(g0)
    gather_reduce.pwmlp_minmax_stats(g, g * g, it, mt)
    with torch.no_grad():
        gather_reduce.gather_sub_minmax(g.requires_grad_(True), g, it, mt)
    assert kernel_route["pwmlp_minmax_stats_bwd_cuda"].calls == 1
    assert kernel_route["gather_sub_minmax_bwd_cuda"].calls == 1


# ---- (d) LocalAggregation against JAX's gather and factorized paths ----------

def _agg_cfg(kind="pointwisemlp", **settings):
    cfg = jload_config()
    cfg.local_aggregation_type = kind
    cfg.precision = "f32"
    for key, value in settings.items():
        cfg[kind][key] = value
    return cfg


def _jax_variables(jla, cfg, feats, xyz, idx, mask):
    """Flax init with seeded non-trivial BN state; a point-wise MLP's
    pw_bn_0/scale gets negative entries, so the factorized path also
    takes its min branch."""
    variables = jax.tree.map(np.asarray, dict(jla.init(
        jax.random.PRNGKey(0), xyz, xyz, feats, idx, mask)))
    flat = flatten_variables(variables)
    rng = np.random.default_rng(40)
    for k in sorted(flat):
        if k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
        elif k.endswith("/scale"):
            flat[k] = (rng.uniform(0.5, 1.5, flat[k].shape)
                       * np.where(np.arange(flat[k].size) % 3 == 1, -1, 1)
                       ).astype(np.float32)
        elif k.endswith(("/mean", "/bias")):
            flat[k] = rng.normal(0, 0.2, flat[k].shape).astype(np.float32)
    return flat


def _nested(flat, collection):
    out = {}
    for k, v in flat.items():
        top, *path, leaf = k.split("/")
        if top == collection:
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return out


def _port_agg(cfg, cin, cout, flat):
    """The port's LocalAggregation with the flax variables of a lone
    LocalAggregation (keys ``params/pw_kernel_0`` ...)."""
    la = LocalAggregation(cin, cout, RADIUS, Config(cfg.to_dict()))
    sd = {}
    for fk, v in flat.items():
        top, scope, *rest = fk.split("/")
        if scope.startswith("pw_kernel_"):
            sd[f"pw_linears.{scope[10:]}.weight"] = v.T
        elif scope.startswith("pw_bn_"):
            name = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                    "var": "running_var"}[rest[0]]
            sd[f"pw_bns.{scope[6:]}.{name}"] = v
        else:
            raise KeyError(fk)
    la.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in sd.items()}, strict=True)
    return la


def _run_both(cfg, cloud, train, cin=C, cout=COUT, flag="never"):
    """(port, JAX) x (output, updated batch_stats, grads): grads of
    <out, dy> w.r.t. the parameters (flat flax keys) and the features."""
    xyz, idx, mask = cloud
    feats = _normal(41, B, N, cin)
    dy = _normal(42, B, N, cout)
    cfg.use_pallas = flag
    jla = JLocalAggregation(cout, RADIUS, cfg)
    jargs = [jnp.asarray(a) for a in (xyz, feats, idx, mask)]

    def jfwd(p, f):
        out = jla.apply({"params": p, "batch_stats": stats}, jargs[0],
                        jargs[0], f, jargs[2], jargs[3], train=train,
                        mutable=["batch_stats"])
        return out[0], out[1]

    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp)
        flat = _jax_variables(jla, cfg, jargs[1], jargs[0], *jargs[2:])
        params, stats = _nested(flat, "params"), _nested(flat, "batch_stats")
        jout, vjp, jnew = jax.vjp(jfwd, params, jargs[1], has_aux=True)
        jgp, jgf = vjp(jnp.asarray(dy))
    jgrads = flatten_variables({"params": jax.tree.map(np.asarray, jgp)})
    jgrads["features"] = np.asarray(jgf)
    jnew = flatten_variables(jax.tree.map(np.asarray, dict(jnew)))

    la = _port_agg(cfg, cin, cout, flat).train(train)
    xt, it, mt = _t(xyz, idx, mask)
    f = torch.from_numpy(feats).requires_grad_(True)
    out = la(xt, xt, f, it, mt)
    out.backward(torch.from_numpy(dy))
    # a dp-only MLP does not read the features
    grads = {"features": (np.zeros_like(feats) if f.grad is None
                          else f.grad.numpy())}
    for name, p in la.named_parameters():
        mod, i, leaf = name.split(".")
        g = p.grad.numpy()
        if mod == "pw_linears":
            grads[f"params/pw_kernel_{i}"] = g.T
        elif mod == "pw_bns":
            grads[f"params/pw_bn_{i}/"
                  f"{'scale' if leaf == 'weight' else 'bias'}"] = g
    assert sorted(grads) == sorted(jgrads)
    new = {f"batch_stats/pw_bn_{i}/{k}": getattr(bn, f"running_{k}").numpy()
           for i, bn in enumerate(la.pw_bns) for k in ("mean", "var")}
    return ((out.detach().numpy(), new, grads),
            (np.asarray(jout), jnew, jgrads), la)


def _check_agg(port, ref, train):
    out, new, grads = port
    jout, jnew, jgrads = ref
    # tests/test_pallas_pwmlp.py's tolerances between JAX's two paths
    np.testing.assert_allclose(out, jout, rtol=2e-4, atol=2e-5)
    if train:
        assert sorted(new) == sorted(jnew)
        for k in jnew:
            np.testing.assert_allclose(new[k], jnew[k], rtol=2e-4,
                                       atol=2e-5, err_msg=k)
    for k in jgrads:
        assert k == "features" or np.abs(jgrads[k]).sum() > 0, k
        np.testing.assert_allclose(grads[k], jgrads[k], rtol=5e-4,
                                   atol=5e-5, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("feature_type", ["dp_fi_df", "dp", "dp_fi"])
def test_pointwisemlp_matches_jax_gather_path(cloud, feature_type, train):
    cfg = _agg_cfg(feature_type=feature_type)
    port, ref, la = _run_both(cfg, cloud, train)
    assert la.factorized and (la.pw_bns[0].weight < 0).any()
    _check_agg(port, ref, train)


@pytest.mark.parametrize("train", [False, True])
def test_pointwisemlp_matches_jax_factorized_path(cloud, train):
    """JAX's factorized path runs its K6 (train) or K7 (eval) Pallas
    kernel, interpreted."""
    port, ref, _ = _run_both(_agg_cfg(), cloud, train, flag="always")
    _check_agg(port, ref, train)


def test_pointwisemlp_gather_path_matches_jax(cloud):
    """Two FC layers and an avg: the gather path on both sides."""
    cfg = _agg_cfg(num_mlps=2, reduction="avg")
    port, ref, la = _run_both(cfg, cloud, True)
    assert not la.factorized and len(la.pw_bns) == 2
    _check_agg(port, ref, True)


@pytest.mark.parametrize("embedding", ["xyz", "sin_cos"])
def test_pospool_max_matches_jax_gather_path(cloud, embedding):
    xyz, idx, mask = cloud
    cfg = _agg_cfg("pospool", position_embedding=embedding, reduction="max")
    feats, dy = _normal(50, B, N, 12), _normal(51, B, N, 12)
    jla = JLocalAggregation(12, RADIUS, cfg)
    jargs = [jnp.asarray(a) for a in (xyz, idx, mask)]
    jout, vjp = jax.vjp(lambda f: jla.apply({}, jargs[0], jargs[0], f,
                                            *jargs[1:]), jnp.asarray(feats))
    (jgrad,) = vjp(jnp.asarray(dy))
    la = LocalAggregation(12, 12, RADIUS, Config(cfg.to_dict()))
    xt, it, mt = _t(xyz, idx, mask)
    f = torch.from_numpy(feats).requires_grad_(True)
    out = la(xt, xt, f, it, mt)
    out.backward(torch.from_numpy(dy))
    assert np.all(out.detach().numpy()[~mask.any(-1)] == 0.0)
    # f32; XLA and ATen may differ by an ulp in sin/cos
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)


# ---- (e) the tiny flagship with the config's operator settings ----------------

@pytest.fixture(scope="module")
def trained():
    return run_tiny("pwmlp")


def test_pwmlp_model_eval_logits_match_jax(trained):
    got, ref = trained["logits"]
    assert got.shape == ref.shape == (8, 8)
    # f32 end to end; the port factorizes where JAX's jnp path gathers
    # (tests/test_torch_operator_models.py's tolerance)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_pwmlp_model_grads_match_jax(trained):
    tg, jg = trained["grads"]
    assert sorted(tg) == sorted(jg)
    assert any(k.endswith("LocalAggregation_0/pw_kernel_0") for k in tg)
    for k in jg:
        assert np.abs(tg[k]).sum() > 0, k
        # f32. The factorized BN variance E[h^2] - mean^2 cancels, which
        # lifts rounding differences in small gradient entries above
        # tests/test_torch_operator_models.py's tolerance (against JAX's
        # gather and its factorized path alike); these are the JAX
        # package's own between its two point-wise MLP paths
        # (tests/test_pallas_pwmlp.py: rtol 5e-4, atol 5e-5), atol scaled
        # by the gradient's largest entry
        np.testing.assert_allclose(tg[k], jg[k], rtol=5e-4,
                                   atol=5e-5 * np.abs(jg[k]).max(),
                                   err_msg=k)


def test_pwmlp_model_losses_track_jax_over_steps(trained):
    tl, jl = trained["losses"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    # at this LR the third step overshoots, in JAX as in the port
    assert tl[1] < tl[0]


def test_pwmlp_weight_bridge_round_trips(trained):
    variables, cfg = trained["variables"], trained["cfg"]
    model = build_model(cfg)
    # raises on a flax key left unused or a state_dict key left unset
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    assert model.backbone.stem_agg.factorized
    back = state_dict_to_flax(model.state_dict(), model)
    flat = flatten_variables(variables)
    assert sorted(back) == sorted(flat)
    assert any(k.endswith("pw_bn_0/mean") for k in flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
