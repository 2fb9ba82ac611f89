"""Port training on the CPU (plain versions) vs the JAX package.

Seeded numpy inputs go through the JAX function and the port's
counterpart: train-mode ConvBN, the loss, the LR schedules, the optimizer
chain, the data iterator, and a whole train step of the tiny flagship
(``__graft_entry__._flagship_cfg(tiny=True)``, f32, dropout 0) against
JAX's ``make_train_step``. The JAX side runs its jnp paths
(``use_pallas="never"``).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from closerlook3d_tpu.data import loader as jloader
from closerlook3d_tpu.data import synthetic as jsynthetic
from closerlook3d_tpu.models import build_model as jbuild_model
from closerlook3d_tpu.models import losses as jlosses
from closerlook3d_tpu.models.nn_utils import ConvBN as JConvBN
from closerlook3d_tpu.train import schedules as jschedules
from closerlook3d_tpu.train.state import create_train_state as jcreate_state
from closerlook3d_tpu.train.step import make_train_step as jmake_train_step
from closerlook3d_tpu.utils.config import load_config as jload_config
from closerlook3d_tpu_torch.convert import (
    flatten_variables, flax_to_state_dict, state_dict_to_flax)
from closerlook3d_tpu_torch.data import loader, synthetic
from closerlook3d_tpu_torch.models import build_classification
from closerlook3d_tpu_torch.models.losses import (
    label_smoothing_cross_entropy)
from closerlook3d_tpu_torch.models.nn_utils import ConvBN
from closerlook3d_tpu_torch.train import (
    create_train_state, make_eval_step, make_lr_schedule, make_optimizer,
    make_train_step)
from closerlook3d_tpu_torch.train.schedules import SGD
from closerlook3d_tpu_torch.utils.config import Config, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nest(flat):
    nested = {}
    for k, v in flat.items():
        node = nested
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return nested


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv_bn_train_mode_matches_flax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(1.0, 2.0, size=(3, 50, 12)).astype(np.float32)
    x[2, 30:] = 0.0  # padded rows count in flax's unmasked statistics
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jmod = JConvBN(9, 0.9, activation=fnn.relu, dtype=jdt)
    variables = jax.tree.map(np.asarray, dict(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)))
    flat = flatten_variables(variables)
    for k in flat:  # non-trivial affine params and running statistics
        if not k.endswith("kernel"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    y, mutated = jmod.apply(_nest(flat), jnp.asarray(x).astype(jdt),
                            train=True, mutable=["batch_stats"])

    mod = ConvBN(12, 9, 0.9, dtype=tdt).train()
    weights = {"linear.weight": flat["params/Dense_0/kernel"].T,
               "bn.weight": flat["params/BatchNorm_0/scale"],
               "bn.bias": flat["params/BatchNorm_0/bias"],
               "bn.running_mean": flat["batch_stats/BatchNorm_0/mean"],
               "bn.running_var": flat["batch_stats/BatchNorm_0/var"]}
    mod.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in weights.items()})
    out = mod(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    stats = mutated["batch_stats"]["BatchNorm_0"]
    if dtype == "f32":
        # f32 throughout; the matmul and the statistics' sums associate
        # differently in XLA and ATen
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        # bf16 matmul outputs may differ by one bf16 ulp, which moves the
        # f32 statistics by ~1e-3 relative and the output by ~1 ulp
        tol = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(y, np.float32), **tol)
    np.testing.assert_allclose(mod.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), **tol)
    np.testing.assert_allclose(mod.bn.running_var.numpy(),
                               np.asarray(stats["var"]), **tol)


@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_label_smoothing_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, size=(16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, size=16).astype(np.int32)
    ref = jlosses.label_smoothing_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), smoothing)
    got = label_smoothing_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels), smoothing)
    # f32 log-softmax and sums in XLA vs ATen order
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("scheduler,warmup", [
    ("cosine", 5), ("cosine", 0), ("step", 2), ("step", 0),
    ("multistep", 3), ("multistep", 0)])
def test_lr_schedule_matches_optax(scheduler, warmup):
    overrides = {"lr_scheduler": scheduler, "warmup_epoch": warmup,
                 "epochs": 40, "base_learning_rate": 0.02,
                 "lr_decay_steps": 7, "lr_decay_rate": 0.5,
                 "lr_milestones": [10, 25, 31]}
    spe = 4
    ours = make_lr_schedule(load_config(overrides=overrides), spe)
    ref = jschedules.make_lr_schedule(jload_config(overrides=overrides), spe)
    steps = np.arange(0, 200)
    got = np.array([ours(int(s)) for s in steps])
    want = np.array([float(ref(int(s))) for s in steps])
    # optax evaluates in f32, the port in Python floats; early in the
    # warmup optax's (init - end) * frac + end cancels ~7 of f32's 24 bits
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-12)


class _Toy(torch.nn.Module):
    """Parameters of both kinds: matrices (decayed) and vectors (not)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(5, 4))
        self.k = torch.nn.Parameter(torch.zeros(3, 2))
        self.b = torch.nn.Parameter(torch.zeros(5))


@pytest.mark.parametrize("grad_clip", [0.0, 3.0])
def test_sgd_updates_match_optax_chain(grad_clip):
    """Three updates through warmup: momentum, decay mask, clip (the
    second gradient is scaled past the clip norm, the others are not)."""
    overrides = {"grad_clip": grad_clip, "weight_decay": 0.01,
                 "base_learning_rate": 0.5, "warmup_epoch": 1,
                 "epochs": 10, "momentum": 0.9}
    spe = 2
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(5, 4)), "k": rng.normal(size=(3, 2)),
              "b": rng.normal(size=5)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    grads = [{k: (rng.normal(size=v.shape) * scale).astype(np.float32)
              for k, v in params.items()} for scale in (0.3, 5.0, 0.5)]

    tx, _ = jschedules.make_optimizer(jload_config(overrides=overrides), spe)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)

    model = _Toy()
    with torch.no_grad():
        for k, v in params.items():
            getattr(model, k).copy_(torch.from_numpy(v))
    ours, _ = make_optimizer(load_config(overrides=overrides), spe)
    opt = ours.init(model)
    for count, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, v in g.items():
            getattr(model, k).grad = torch.from_numpy(v.copy())
        ours.update(opt, count)
        for k in params:
            # f32 updates; optax scales by -lr, torch adds with alpha=-lr
            np.testing.assert_allclose(
                getattr(model, k).detach().numpy(), np.asarray(jparams[k]),
                rtol=1e-6, atol=1e-7, err_msg=f"step {count} {k}")


def test_adamw_is_not_ported():
    # AdamW is ported now (tests/test_torch_engine.py holds it to
    # optax.adamw); an optimizer the JAX package lacks still raises
    tx, _ = make_optimizer(load_config(overrides={"optimizer": "adamw"}), 10)
    assert type(tx).__name__ == "AdamW"
    with pytest.raises(ValueError, match="lamb"):
        make_optimizer(load_config(overrides={"optimizer": "lamb"}), 10)


def test_batch_iterator_matches_jax():
    ours = loader.BatchIterator(
        synthetic.SyntheticClassification(20, 64, seed=4), 6, shuffle=True,
        feature_spec="xyz,normals", seed=3, spatial_sort=True)
    ref = jloader.BatchIterator(
        jsynthetic.SyntheticClassification(20, 64, seed=4), 6, shuffle=True,
        feature_spec="xyz,normals", seed=3, spatial_sort=True)
    assert len(ours) == len(ref) == 3
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        pairs = list(zip(ours, ref))
        assert len(pairs) == 3
        for a, b in pairs:
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # eval order: the ragged last batch is padded and marked
    last = list(loader.BatchIterator(
        synthetic.SyntheticClassification(8, 16), 3, shuffle=False,
        feature_spec="ones,xyz", drop_last=False))[-1]
    np.testing.assert_array_equal(last["batch_pad"], [False, False, True])
    assert last["features"].shape == (3, 16, 4)


def test_chip_smoke_slice_config_is_the_yaml():
    import chip_smoke

    path = os.path.join(REPO, "configs/modelnet40/pospool_xyz_avg.yaml")
    assert chip_smoke.slice_config().to_dict() == load_config(path).to_dict()


# ---- a whole train step vs JAX's make_train_step -----------------------

STEPS = 5


@pytest.fixture(scope="module")
def trained():
    """JAX and port runs of STEPS train steps from the same variables and
    batch, plus each side's gradients at the first step."""
    jcfg = graft._flagship_cfg(tiny=True)
    jcfg.use_pallas = "never"
    jcfg.dropout_rate = 0.0
    jcfg.base_learning_rate = 0.1
    jcfg.warmup_epoch = 1
    cfg = Config(jcfg.to_dict())
    spe = 2
    batch = next(iter(loader.BatchIterator(
        synthetic.SyntheticClassification(16, jcfg.num_points,
                                          num_classes=jcfg.num_classes,
                                          seed=7),
        jcfg.batch_size, shuffle=True, feature_spec="xyz", seed=1,
        spatial_sort=True)))
    batch["mask"][3, 50:] = False  # a padded cloud

    model, loss_fn = jbuild_model(jcfg)
    tx, _ = jschedules.make_optimizer(jcfg, spe)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jcreate_state(jcfg, model, tx, jax.random.PRNGKey(0), jbatch)
    # non-trivial BatchNorm affine params and running statistics
    rng = np.random.default_rng(8)
    flat = flatten_variables({"params": jax.tree.map(np.asarray,
                                                     state.params),
                              "batch_stats": jax.tree.map(
                                  np.asarray, state.batch_stats)})
    for k in sorted(flat):
        if k.endswith(("/scale", "/var")):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
        elif k.endswith(("/mean", "/BatchNorm_0/bias")):
            flat[k] = rng.normal(0, 0.2, flat[k].shape).astype(np.float32)
    variables = _nest(flat)
    state = state.replace(
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(jax.tree.map(jnp.asarray, variables["params"])))

    def loss_of(params):
        logits, _ = model.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jbatch["xyz"], jbatch["mask"], jbatch["features"], train=True,
            mutable=["batch_stats"])
        return loss_fn(logits, jbatch["label"])

    jgrads = jax.jit(jax.grad(loss_of))(state.params)
    jstep = jmake_train_step(model, loss_fn, jcfg.task, donate=False)
    jlog = []
    for i in range(STEPS):
        state, m = jstep(state, jbatch, jax.random.PRNGKey(1))
        jlog.append((float(m["loss"]), float(m["acc"])))
        if i == 0:
            jafter1 = flatten_variables(
                {"params": jax.tree.map(np.asarray, state.params),
                 "batch_stats": jax.tree.map(np.asarray,
                                             state.batch_stats)})

    tmodel, tloss_fn = build_classification(cfg)
    tmodel.load_state_dict(flax_to_state_dict(variables, tmodel))
    ttx, _ = make_optimizer(cfg, spe)
    tstate = create_train_state(tmodel, ttx, device="cpu")
    tstep = make_train_step(tloss_fn, cfg.task)
    tlog = []
    for i in range(STEPS):
        tstate, m = tstep(tstate, batch, 0)
        tlog.append((float(m["loss"]), float(m["acc"])))
        if i == 0:
            tgrads = state_dict_to_flax(
                {n: p.grad for n, p in tmodel.named_parameters()}, tmodel,
                params_only=True)
            tafter1 = state_dict_to_flax(tmodel.state_dict(), tmodel)
    logits, metrics = make_eval_step(tloss_fn, cfg.task)(tstate, batch)
    return {"jgrads": flatten_variables({"params": jax.tree.map(
                np.asarray, jgrads)}),
            "tgrads": tgrads, "jlog": jlog, "tlog": tlog,
            "jafter1": jafter1, "tafter1": tafter1, "tstate": tstate,
            "eval": (logits, metrics)}


def test_train_step_loss_and_grads_match_jax(trained):
    jloss, jacc = trained["jlog"][0]
    tloss, tacc = trained["tlog"][0]
    # f32 end to end; XLA and ATen sum matmuls, BN statistics and
    # neighborhoods in different orders
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert tacc == jacc
    jg, tg = trained["jgrads"], trained["tgrads"]
    assert sorted(jg) == sorted(tg)
    for k in jg:
        assert np.abs(tg[k]).sum() > 0, k
        # same f32 rounding argument; BN backward over 64-point batches
        # amplifies reordering in small-norm gradients
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4,
                                   atol=1e-5 * np.abs(jg[k]).max(),
                                   err_msg=k)


def test_train_step_updates_match_jax(trained):
    ja, ta = trained["jafter1"], trained["tafter1"]
    assert sorted(ja) == sorted(ta)
    for k in ja:
        # params move by lr * (momentum trace): gradient tolerance times
        # lr; running statistics are f32 batch moments
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_train_step_losses_track_jax_over_steps(trained):
    jl = np.array([l for l, _ in trained["jlog"]])
    tl = np.array([l for l, _ in trained["tlog"]])
    # the reordering differences compound over the steps
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert trained["tstate"].step == STEPS


def test_eval_step_after_training(trained):
    logits, metrics = trained["eval"]
    assert logits.shape == (8, 8) and torch.isfinite(logits).all()
    assert set(metrics) == {"loss", "acc"}
    assert not trained["tstate"].model.training


def test_sgd_binds_decay_to_matrices_only():
    model = _Toy()
    opt = SGD(lambda c: 0.1, 0.9, 0.01, 0.0).init(model)
    decay, rest = opt.param_groups
    assert decay["weight_decay"] == 0.01 and rest["weight_decay"] == 0.0
    assert [p.ndim for p in decay["params"]] == [2, 2]
    assert [p.ndim for p in rest["params"]] == [1]
