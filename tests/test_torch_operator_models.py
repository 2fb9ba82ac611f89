"""The tiny ModelNet40 sin/cos PosPool and adaptive-weight models against
JAX.

``configs/modelnet40/{pospool_sincos_avg,adaptive_weight_dp_fc1_avg}.yaml``
cut to the tiny flagship's size (``__graft_entry__._flagship_cfg(tiny=
True)``, f32, dropout 0) are initialised in flax, given seeded non-trivial
BatchNorm statistics and biases, converted with the weight bridge, and run
by both packages on one numpy batch: eval logits, first-step gradients and
three train steps (JAX's ``make_train_step``). The JAX side runs its jnp
paths (``use_pallas="never"``), so the port's factorized adaptive weight
(through the neighborhood moments) is held to JAX's gather path. One
adaptive model on the port's gather path (two weight FCs, softmax, shared
channels, max) checks the weight bridge's ConvBN renumbering. The
operators themselves: ``tests/test_torch_operators.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from closerlook3d_tpu.data import loader as jloader
from closerlook3d_tpu.data import synthetic as jsynthetic
from closerlook3d_tpu.models import build_model as jbuild_model
from closerlook3d_tpu.train import schedules as jschedules
from closerlook3d_tpu.train.state import create_train_state as jcreate_state
from closerlook3d_tpu.train.step import make_train_step as jmake_train_step
from closerlook3d_tpu_torch.convert import (
    flatten_variables, flax_to_state_dict, state_dict_to_flax)
from closerlook3d_tpu_torch.models import build_classification, build_model
from closerlook3d_tpu_torch.train import (
    create_train_state, make_optimizer, make_train_step)
from closerlook3d_tpu_torch.utils.config import Config, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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

CONFIGS = {
    "sincos": "configs/modelnet40/pospool_sincos_avg.yaml",
    "adaptive": "configs/modelnet40/adaptive_weight_dp_fc1_avg.yaml",
    "pwmlp": "configs/modelnet40/pointwisemlp_dp_fi_df_fc1_max.yaml",
    "pgrid": "configs/modelnet40/pseudo_grid.yaml",
}


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_chip_smoke_operator_configs_are_the_yamls(kind):
    import chip_smoke

    path = os.path.join(REPO, CONFIGS[kind])
    assert (chip_smoke.operator_config(kind).to_dict()
            == load_config(path).to_dict())


def _tiny_jcfg(kind: str):
    """The tiny flagship with the config's operator settings, f32."""
    jcfg = graft._flagship_cfg(tiny=True)
    full = load_config(os.path.join(REPO, CONFIGS.get(kind, CONFIGS[
        "adaptive"])))
    jcfg.local_aggregation_type = full.local_aggregation_type
    jcfg.pospool.position_embedding = full.pospool.position_embedding
    for key, value in full.pointwisemlp.items():
        jcfg.pointwisemlp[key] = value
    for key, value in full.pseudo_grid.items():
        jcfg.pseudo_grid[key] = value
    if kind == "adaptive_gather":  # every branch of the gather path
        jcfg.adaptive_weight.local_input_feature = "dp_fi_df"
        jcfg.adaptive_weight.fc_num = 2
        jcfg.adaptive_weight.weight_softmax = True
        jcfg.adaptive_weight.shared_channels = 2
        jcfg.adaptive_weight.reduction = "max"
        jcfg.adaptive_weight.output_conv = True
    jcfg.use_pallas = "never"
    jcfg.dropout_rate = 0.0
    jcfg.base_learning_rate = 0.1
    jcfg.warmup_epoch = 1
    return jcfg


def _nest(flat):
    nested = {}
    for k, v in flat.items():
        node = nested
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return nested


def _batch(jcfg):
    batch = next(iter(jloader.BatchIterator(
        jsynthetic.SyntheticClassification(16, jcfg.num_points,
                                           num_classes=jcfg.num_classes,
                                           seed=7),
        jcfg.batch_size, shuffle=True, feature_spec="xyz", seed=1,
        spatial_sort=True)))
    batch["mask"][3, 50:] = False  # a padded cloud
    return batch


def _seeded_variables(jcfg, model, tx, jbatch):
    """Flax init, with non-trivial BatchNorm and Dense biases."""
    state = jcreate_state(jcfg, model, tx, jax.random.PRNGKey(0), jbatch)
    rng = np.random.default_rng(8)
    flat = flatten_variables({"params": jax.tree.map(np.asarray,
                                                     state.params),
                              "batch_stats": jax.tree.map(
                                  np.asarray, state.batch_stats)})
    for k in sorted(flat):
        if k.endswith(("/scale", "/var")):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
        elif k.endswith(("/mean", "/bias")):
            flat[k] = rng.normal(0, 0.2, flat[k].shape).astype(np.float32)
    variables = _nest(flat)
    return state.replace(
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(jax.tree.map(jnp.asarray,
                                       variables["params"]))), variables


STEPS = 3


def run_tiny(kind: str) -> dict:
    """Eval logits, first-step gradients and STEPS train steps of one tiny
    config in JAX and in the port, from the same variables and batch."""
    jcfg = _tiny_jcfg(kind)
    cfg = Config(jcfg.to_dict())
    spe = 2
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model, loss_fn = jbuild_model(jcfg)
    tx, _ = jschedules.make_optimizer(jcfg, spe)
    state, variables = _seeded_variables(jcfg, model, tx, jbatch)
    # each JAX result is made concrete before the port computes
    jlogits = np.asarray(model.apply(variables, jbatch["xyz"],
                                     jbatch["mask"], jbatch["features"],
                                     train=False))

    def loss_of(params):
        logits, _ = model.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jbatch["xyz"], jbatch["mask"], jbatch["features"], train=True,
            mutable=["batch_stats"])
        return loss_fn(logits, jbatch["label"])

    jgrads = flatten_variables({"params": jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss_of))(state.params))})
    jstep = jmake_train_step(model, loss_fn, jcfg.task, donate=False)
    jlog = []
    for _ in range(STEPS):
        state, m = jstep(state, jbatch, jax.random.PRNGKey(1))
        jlog.append(float(m["loss"]))

    tmodel, tloss_fn = build_classification(cfg)
    tmodel.load_state_dict(flax_to_state_dict(variables, tmodel))
    with torch.inference_mode():
        tlogits = tmodel(torch.from_numpy(batch["xyz"]),
                         torch.from_numpy(batch["mask"]),
                         torch.from_numpy(batch["features"]))
    ttx, _ = make_optimizer(cfg, spe)
    tstate = create_train_state(tmodel, ttx, device="cpu")
    tstep = make_train_step(tloss_fn, cfg.task)
    tlog = []
    for i in range(STEPS):
        tstate, m = tstep(tstate, batch, 0)
        tlog.append(float(m["loss"]))
        if i == 0:
            tgrads = state_dict_to_flax(
                {n: p.grad for n, p in tmodel.named_parameters()}, tmodel,
                params_only=True)
    return {"kind": kind, "variables": variables, "cfg": cfg,
            "logits": (tlogits.numpy(), jlogits),
            "grads": (tgrads, jgrads),
            "losses": (np.array(tlog), np.array(jlog))}


# the point-wise MLP config runs in tests/test_torch_pwmlp.py
@pytest.fixture(scope="module", params=["adaptive", "sincos"])
def trained(request):
    return run_tiny(request.param)


def test_operator_config_eval_logits_match_jax(trained):
    got, ref = trained["logits"]
    assert got.shape == ref.shape == (8, 8)
    # f32 end to end; XLA and ATen sum matmuls and neighborhoods in
    # different orders (and the adaptive config factorizes through the
    # moments where JAX's jnp path gathers)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_operator_config_grads_match_jax(trained):
    tg, jg = trained["grads"]
    assert sorted(tg) == sorted(jg)
    if trained["kind"] == "adaptive":
        assert any(k.endswith("LocalAggregation_0/Dense_0/kernel")
                   for k in tg)
    for k in jg:
        assert np.abs(tg[k]).sum() > 0, k
        # f32; BN backward over 64-point batches amplifies reordering in
        # small-norm gradients (tests/test_torch_train.py's tolerance)
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4,
                                   atol=1e-5 * np.abs(jg[k]).max(),
                                   err_msg=k)


def test_operator_config_losses_track_jax_over_steps(trained):
    tl, jl = trained["losses"]
    # the reordering differences compound over the steps
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_operator_config_weight_bridge_round_trips(trained):
    variables, cfg = trained["variables"], trained["cfg"]
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    back = state_dict_to_flax(model.state_dict(), model)
    flat = flatten_variables(variables)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_adaptive_gather_path_and_bridge_match_jax():
    """Two weight FCs (flax ConvBN_0, then Dense_0, then the output conv
    as ConvBN_1), softmax over the neighborhood, shared channels, max
    reduction: eval logits from converted weights, and the round trip."""
    jcfg = _tiny_jcfg("adaptive_gather")
    cfg = Config(jcfg.to_dict())
    batch = _batch(jcfg)
    model, _ = jbuild_model(jcfg)
    args = (batch["xyz"], batch["mask"], batch["features"])
    variables = jax.tree.map(np.asarray, dict(model.init(
        jax.random.PRNGKey(0), *args, train=False)))
    flat = flatten_variables(variables)
    rng = np.random.default_rng(9)
    for k in sorted(flat):
        if k.endswith(("/mean", "/bias")):
            flat[k] = rng.normal(0, 0.2, flat[k].shape).astype(np.float32)
        elif k.endswith(("/var", "/scale")):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    scope = "params/ResNetBackbone_0/Bottleneck_1/LocalAggregation_0"
    assert {f"{scope}/ConvBN_0/Dense_0/kernel", f"{scope}/Dense_0/kernel",
            f"{scope}/ConvBN_1/Dense_0/kernel"} <= set(flat)
    jlogits = np.asarray(model.apply(_nest(flat), *args, train=False))

    tmodel = build_model(cfg)
    tmodel.load_state_dict(flax_to_state_dict(flat, tmodel), strict=True)
    assert not tmodel.backbone.blocks[1].agg.factorized
    with torch.inference_mode():
        logits = tmodel(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-4,
                               atol=1e-5)
    back = state_dict_to_flax(tmodel.state_dict(), tmodel)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
