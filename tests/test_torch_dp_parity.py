"""The port's 2-rank data-parallel step against the JAX package's sharded one.

The JAX train step on a 2-device mesh (``make_mesh(2, 1,
devices=jax.devices()[:2])``: one global batch sharded over ``data``,
every BatchNorm statistic, loss mean and gradient global by GSPMD) and
the port's step in 2 gloo ranks on the CPU (``parallel/spawn.py``), each
rank stepping its 8 rows of the same 16-cloud batch, from the same
weights (``convert.flax_to_state_dict``), for the tiny flagship (PosPool
xyz) and the tiny point-wise MLP config (whose BatchNorm statistics come
from the sums of its min/max + statistics kernel's plain version): f32,
dropout 0, the JAX side on its jnp paths (``use_pallas="never"``).

Tolerance, as the single-process f32 step parities
(``tests/test_torch_train.py``, ``tests/test_torch_seg_train.py``):
losses over the 3 steps within rtol 1e-4 (the reordering differences
compound), accuracies equal, the first step's gradients within 1e-4
relative plus 1e-5 of each tensor's largest entry (5e-4 and 5e-5 for the
point-wise MLP); parameters and running statistics after 2 and 3 steps
within rtol 1e-5, atol 1e-6. The point-wise MLP's masked BatchNorm
variance E[h^2] - mean^2 cancels, and its third step moves with the
summation order alone: the JAX package's own single-device and 2-device
steps part there by ~5e-3 (largest absolute difference; after 2 steps
by 2e-6), as do the port's 2 ranks and the JAX 2-device step. There the
port must end no farther from the 2-device step than twice the JAX
package's own gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import torch_dp_worker as worker
from closerlook3d_tpu.models import build_model as jbuild_model
from closerlook3d_tpu.parallel.mesh import (
    make_mesh, replicated_sharding, shard_batch)
from closerlook3d_tpu.train import schedules as jschedules
from closerlook3d_tpu.train.state import create_train_state as jcreate_state
from closerlook3d_tpu.train.step import make_train_step as jmake_train_step
from closerlook3d_tpu_torch.convert import (
    flatten_variables, flax_to_state_dict, state_dict_to_flax)
from closerlook3d_tpu_torch.models import build_classification
from closerlook3d_tpu_torch.parallel.spawn import run_ranks
from closerlook3d_tpu_torch.utils.config import Config
from test_torch_operator_models import _batch, _nest
from test_torch_operator_models import _tiny_jcfg as _operator_jcfg
from test_torch_ops import _one_aten_thread  # noqa: F401

STEPS = 3
KINDS = ("flagship", "pwmlp")


def _jcfg(kind):
    if kind == "pwmlp":
        jcfg = _operator_jcfg("pwmlp")
    else:
        jcfg = graft._flagship_cfg(tiny=True)
        jcfg.use_pallas = "never"
        jcfg.dropout_rate = 0.0
        jcfg.base_learning_rate = 0.1
        jcfg.warmup_epoch = 1
    jcfg.batch_size = 16  # the global batch: 8 clouds a rank
    return jcfg


def _seeded(flat_state):
    """Non-trivial BatchNorm affine parameters and running statistics,
    as ``test_torch_operator_models._seeded_variables`` draws them."""
    rng = np.random.default_rng(8)
    flat = dict(flat_state)
    for k in sorted(flat):
        if k.endswith(("/scale", "/var")):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
        elif k.endswith(("/mean", "/bias")):
            flat[k] = rng.normal(0, 0.2, flat[k].shape).astype(np.float32)
    return _nest(flat)


def _jax_run(kind):
    """The JAX step on the 2-device mesh: the variables it started from,
    the batch, per-step (loss, acc), the first step's gradients and the
    flat variables before the last step and after it; for the point-wise
    MLP also the final variables of the JAX package's single-device
    step."""
    jcfg = _jcfg(kind)
    batch = _batch(jcfg)
    mesh = make_mesh(2, 1, devices=jax.devices()[:2])
    jbatch = shard_batch(batch, mesh)
    model, loss_fn = jbuild_model(jcfg)
    tx, _ = jschedules.make_optimizer(jcfg, 2)
    state = jcreate_state(jcfg, model, tx, jax.random.PRNGKey(0), jbatch,
                          mesh)
    variables = _seeded(flatten_variables(
        {"params": jax.tree.map(np.asarray, state.params),
         "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}))
    rep = replicated_sharding(mesh)
    params = jax.device_put(jax.tree.map(jnp.asarray, variables["params"]),
                            rep)
    state = state.replace(
        params=params,
        batch_stats=jax.device_put(jax.tree.map(
            jnp.asarray, variables["batch_stats"]), rep),
        opt_state=jax.device_put(tx.init(params), rep))
    def loss_of(p):
        logits, _ = model.apply(
            {"params": p, "batch_stats": state.batch_stats}, jbatch["xyz"],
            jbatch["mask"], jbatch["features"], train=True,
            mutable=["batch_stats"])
        return loss_fn(logits, jbatch["label"])

    grads = flatten_variables({"params": jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss_of))(state.params))})
    single = None
    if kind == "pwmlp":  # the JAX package's own single-device step
        dense = {k: jnp.asarray(v) for k, v in batch.items()}
        sstate = jcreate_state(jcfg, model, tx, jax.random.PRNGKey(0), dense)
        p0 = jax.tree.map(jnp.asarray, variables["params"])
        sstate = sstate.replace(params=p0, opt_state=tx.init(p0),
                                batch_stats=jax.tree.map(
                                    jnp.asarray, variables["batch_stats"]))
        sstep = jmake_train_step(model, loss_fn, jcfg.task, donate=False)
        for _ in range(STEPS):
            sstate, _ = sstep(sstate, dense, jax.random.PRNGKey(1))
        single = flatten_variables(
            {"params": jax.tree.map(np.asarray, sstate.params),
             "batch_stats": jax.tree.map(np.asarray, sstate.batch_stats)})
    step = jmake_train_step(model, loss_fn, jcfg.task, mesh, donate=False)
    log = []
    states = []
    for _ in range(STEPS):
        state, m = step(state, jbatch, jax.random.PRNGKey(1))
        log.append((float(m["loss"]), float(m["acc"])))
        states.append(flatten_variables(
            {"params": jax.tree.map(np.asarray, state.params),
             "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}))
    before_last, final = states[-2], states[-1]
    return {"variables": variables, "batch": batch, "log": np.array(log),
            "final": final, "before_last": before_last,
            "cfg": Config(jcfg.to_dict()), "grads": grads,
            "single": single}


@pytest.fixture(scope="module")
def runs():
    jax_runs = {kind: _jax_run(kind) for kind in KINDS}
    jobs = []
    for kind, run in jax_runs.items():
        model, _ = build_classification(run["cfg"])
        weights = {k: v.numpy() for k, v in flax_to_state_dict(
            run["variables"], model).items()}
        keys = ("xyz", "mask", "features", "label")
        jobs.append((kind, "train_steps", (dict(run["cfg"]), weights,
                                           {k: run["batch"][k] for k in keys},
                                           STEPS)))
    ranks = run_ranks(worker.suite, 2, (jobs,), timeout=150, threads=1)
    return jax_runs, ranks


def _port(runs, kind, rank):
    got = runs[1][rank][kind]
    if "error" in got:
        pytest.fail(f"rank {rank}, {kind}:\n{got['error']}")
    return got


def _flax(runs, kind, tensors, params_only=False):
    model, _ = build_classification(runs[0][kind]["cfg"])
    return state_dict_to_flax({k: torch.as_tensor(v)
                               for k, v in tensors.items()}, model,
                              params_only=params_only)


@pytest.mark.parametrize("kind", KINDS)
def test_dp_losses_match_jax_mesh(runs, kind):
    jlog = runs[0][kind]["log"]
    for rank in (0, 1):
        got = _port(runs, kind, rank)["log"]
        np.testing.assert_allclose(got[:, 0], jlog[:, 0], rtol=1e-4)
        np.testing.assert_array_equal(got[:, 1], jlog[:, 1])
    assert jlog[-1, 0] < jlog[0, 0]


@pytest.mark.parametrize("kind", KINDS)
def test_dp_first_step_grads_match_jax_mesh(runs, kind):
    jg = runs[0][kind]["grads"]
    tg = _flax(runs, kind, _port(runs, kind, 0)["grads"], params_only=True)
    assert sorted(tg) == sorted(jg)
    if kind == "pwmlp":
        assert any("pw_kernel_0" in k for k in tg)
    for k in jg:
        assert np.abs(tg[k]).sum() > 0, k
        # as the single-process step parities (test_torch_train.py,
        # test_torch_seg_train.py for the point-wise MLP)
        tol = (dict(rtol=5e-4, atol=5e-5 * np.abs(jg[k]).max())
               if kind == "pwmlp"
               else dict(rtol=1e-4, atol=1e-5 * np.abs(jg[k]).max()))
        np.testing.assert_allclose(tg[k], jg[k], **tol, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_dp_params_and_stats_match_jax_mesh(runs, kind):
    port = _port(runs, kind, 0)
    for when, ours in (("before_last", port["before_last"][0]),
                       ("final", port["state"])):
        want = runs[0][kind][when]
        got = _flax(runs, kind, ours)
        assert sorted(got) == sorted(want)
        if kind == "pwmlp" and when == "final":
            break
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{when} {k}")
    else:
        return
    # the point-wise MLP's third step moves with the summation order
    # alone: the JAX package's single-device step ends ~5e-3 from its
    # 2-device one. The port's 2 ranks must end no farther from the
    # 2-device step than twice that
    own = max(float(np.abs(runs[0][kind]["single"][k] - v).max())
              for k, v in want.items())
    ours = max(float(np.abs(got[k] - v).max()) for k, v in want.items())
    assert 0 < ours <= 2 * own, (ours, own)
