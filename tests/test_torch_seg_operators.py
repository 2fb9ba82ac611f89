"""Segmentation with the operators other than PosPool xyz, and PartNet's
depth, on the CPU against the JAX package.

* Tiny part- and scene-segmentation models (the tiny configs of
  ``tests/test_torch_segmentation.py``: three stages, width 24, f32,
  dropout 0; the scene model with grid sampling, ``ones,rgb,height`` and
  some labels at ``ignore_label``) with the sin/cos PosPool, the adaptive
  weight and the pseudo-grid of ``configs/{shapenetpart,s3dis}/``: eval
  per-point logits, first-step gradients, and loss and accuracy over
  three train steps, against JAX's ``make_train_step`` from the same
  variables and batch.
* A tiny PartNet-shaped model: depth 3 (``configs/partnet/``'s), three
  categories of a stand-in part table (PartNet's own comes from its h5
  files): geometry, eval logits, first-step gradients and the weight
  bridge (``convert.py``) both ways, per-category heads included.
* ``chip_smoke.py``'s runs of every config under ``configs/``: each
  config equal to its file but for the named cuts, and the exact launches
  per train step and eval step that the card run checks
  (``seg_train_launches``), counted here through every kernel wrapper
  replaced by a counting wrapper around its plain version.

The JAX side runs its jnp paths (``use_pallas="never"``). The kernels of
the same steps are held to the plain versions on the card by
``chip_smoke.py``.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import conftest
from closerlook3d_tpu.models import build_model as jbuild_model
from closerlook3d_tpu.models.backbone import (
    compute_geometry as jcompute_geometry)
from closerlook3d_tpu.train import schedules as jschedules
from closerlook3d_tpu.train.state import TrainState as JTrainState
from closerlook3d_tpu.train.step import make_train_step as jmake_train_step
from closerlook3d_tpu_torch.convert import (
    flatten_variables, flax_to_state_dict, state_dict_to_flax)
from closerlook3d_tpu_torch.models import build_model, build_model_and_loss
from closerlook3d_tpu_torch.models.backbone import compute_geometry
from closerlook3d_tpu_torch.ops import (
    aggregation, gather_reduce, grouping, moments, neighbors, pseudo_grid,
    sampling)
from closerlook3d_tpu_torch.train import (
    create_train_state, make_eval_step, make_optimizer, make_train_step)
from closerlook3d_tpu_torch.utils.config import Config, load_config
from test_torch_operator_models import (  # noqa: F401  (a fixture)
    _nest, _one_aten_thread)
from test_torch_segmentation import _seg_batch, _tiny_jcfg

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPERATORS = {"sincos": "pospool_sincos_avg",
             "adaptive": "adaptive_weight_dp_fc1_avg",
             "pgrid": "pseudo_grid"}
DATASETS = {"part_segmentation": "shapenetpart",
            "scene_segmentation": "s3dis"}
STEPS = 3
# a stand-in part table of three categories (PartNet's comes from its h5
# files)
STANDIN_PARTS = [3, 2, 4]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _operator_jcfg(task: str, op: str):
    """The tiny segmentation config with the operator settings of
    ``configs/<dataset>/<op>.yaml``."""
    jcfg = _tiny_jcfg(task)
    full = load_config(os.path.join(
        REPO, "configs", DATASETS[task], OPERATORS[op] + ".yaml"))
    jcfg.local_aggregation_type = full.local_aggregation_type
    for group in ("pospool", "adaptive_weight", "pseudo_grid"):
        for key, value in full[group].items():
            jcfg[group][key] = value
    return _train_settings(jcfg)


def _train_settings(jcfg):
    """Dropout off, a learning rate that moves the tiny models in three
    steps, and no weight decay (``run_both`` reads JAX's gradients from
    its momentum trace)."""
    jcfg.dropout_rate = 0.0
    jcfg.base_learning_rate = 0.1
    jcfg.warmup_epoch = 1
    jcfg.weight_decay = 0.0
    return jcfg


def _partnet_jcfg():
    """The tiny part-segmentation config at PartNet's depth (3) with
    PartNet's operator (``configs/partnet/pospool_xyz_avg.yaml``) and three
    stand-in categories."""
    jcfg = _tiny_jcfg("part_segmentation")
    full = load_config(os.path.join(REPO,
                                    "configs/partnet/pospool_xyz_avg.yaml"))
    jcfg.datasets = full.datasets
    jcfg.depth = full.depth
    jcfg.num_parts = list(STANDIN_PARTS)
    jcfg.num_classes = len(STANDIN_PARTS)
    return _train_settings(jcfg)


def _partnet_batch(jcfg):
    """chip_smoke's synthetic part clouds with labels, over the config's
    categories (cloud 1 padded)."""
    return chip_smoke.seg_train_batch(Config(jcfg.to_dict()), 5,
                                      padded=(1,))


def _loss_args(task, batch):
    if task == "part_segmentation":
        return (batch["labels"], batch["category"], batch["mask"])
    return (batch["labels"], batch["mask"])


def _flax_variables(model, jbatch) -> dict:
    """Flax's init, with non-trivial BatchNorm statistics and biases drawn
    as ``tests/test_torch_operator_models.py::_seeded_variables`` draws
    them: the starting point of the repo's other segmentation parity
    tests. (Weights seeded on the port's side instead put the tiny scene
    model with sin/cos within 1e-6 relative of a point where a max's or a
    ReLU's inputs cross and the gradient jumps: there 2 of 8 draws of a
    1e-6 relative change to the weights moved the port's own gradient by
    6.4e-3 of its largest entry, the gap between JAX and the port.)"""
    flat = flatten_variables(jax.tree.map(np.asarray, dict(jax.jit(
        lambda r, *a: model.init(r, *a, train=False))(
        jax.random.PRNGKey(0), jbatch["xyz"], jbatch["mask"],
        jbatch["features"]))))
    rng = np.random.default_rng(8)
    for k in sorted(flat):
        if k.endswith(("/scale", "/var")):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
        elif k.endswith(("/mean", "/bias")):
            flat[k] = rng.normal(0, 0.2, flat[k].shape).astype(np.float32)
    return _nest(flat)


def _first_trace(opt_state):
    """The momentum trace in optax's SGD state: after the first step from a
    zero trace, without weight decay, the step's gradients."""
    return next(s.trace for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState))


def run_both(jcfg, batch, steps: int, geometry: bool = False) -> dict:
    """JAX and the port from the same variables and numpy batch: eval
    logits, first-step gradients (on the JAX side read from the momentum
    trace of its first train step: the configs here have no weight decay,
    which spares a second compile of the backward), ``steps`` train
    steps' loss and accuracy, and with ``geometry`` the forward's
    geometry."""
    assert jcfg.weight_decay == 0.0 and jcfg.grad_clip == 0.0
    task = jcfg.task
    num_parts = (tuple(jcfg.num_parts) if task == "part_segmentation"
                 else None)
    cfg = Config(jcfg.to_dict())
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp, ops_impl="jnp")
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        model, loss_fn = jbuild_model(jcfg)
        variables = _flax_variables(model, jbatch)
        tx, _ = jschedules.make_optimizer(jcfg, 2)
        state = jax.jit(lambda p, s: JTrainState.create(
            apply_fn=model.apply, params=p, batch_stats=s, tx=tx))(
            *(jax.tree.map(jnp.asarray, variables[k])
              for k in ("params", "batch_stats")))
        jlogits = np.asarray(jax.jit(lambda v, *a: model.apply(
            v, *a, train=False))(variables, jbatch["xyz"], jbatch["mask"],
                                 jbatch["features"]))
        jgeometry = ({k: np.asarray(v) for k, v in jcompute_geometry(
            jcfg, jbatch["xyz"], jbatch["mask"], need_up=True).items()}
            if geometry else {})
        jstep = jmake_train_step(model, loss_fn, task, donate=False,
                                 num_parts=num_parts)
        jlog = []
        for i in range(max(steps, 1)):
            state, m = jstep(state, jbatch, jax.random.PRNGKey(1))
            jlog.append((float(m["loss"]), float(m["acc"])))
            if i == 0:
                jgrads = flatten_variables({"params": jax.tree.map(
                    np.asarray, _first_trace(state.opt_state))})

    tmodel, tloss_fn = build_model_and_loss(cfg)
    tmodel.load_state_dict(flax_to_state_dict(variables, tmodel))
    targs = _t(batch["xyz"], batch["mask"], batch["features"])
    with torch.inference_mode():
        tlogits = tmodel(*targs).numpy()
        tgeometry = ({k: v.numpy() for k, v in compute_geometry(
            cfg, *targs[:2], need_up=True).items()} if geometry else {})
    ttx, _ = make_optimizer(cfg, 2)
    tstate = create_train_state(tmodel, ttx, device="cpu")
    tstep = make_train_step(tloss_fn, task, num_parts)
    tlog = []
    for i in range(max(steps, 1)):
        tstate, m = tstep(tstate, batch, 0)
        tlog.append((float(m["loss"]), float(m["acc"])))
        if i == 0:
            tgrads = state_dict_to_flax(
                {n: p.grad for n, p in tmodel.named_parameters()}, tmodel,
                params_only=True)
    _, emetrics = make_eval_step(tloss_fn, task, num_parts)(tstate, batch)
    return {"task": task, "cfg": cfg, "variables": variables,
            "logits": (tlogits, jlogits),
            "geometry": (tgeometry, jgeometry),
            "grads": (tgrads, jgrads),
            "log": (np.array(tlog[:steps]), np.array(jlog[:steps])),
            "eval": emetrics}


def _check_grads(task, got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.abs(got[k]).sum() > 0, k
        # f32; BN backward over small batches amplifies reordering in
        # small-norm gradients (tests/test_torch_seg_train.py's tolerance)
        tol = dict(rtol=1e-4, atol=1e-5 * np.abs(ref[k]).max())
        if task == "scene_segmentation" and k.endswith(
                "ResNetBackbone_0/ConvBN_0/Dense_0/kernel"):
            # the stem reads ``ones,rgb,height``, which the train-mode
            # BatchNorm centres: a difference of nearly equal f32 sums
            # (tests/test_torch_seg_train.py)
            tol["atol"] = 3e-5 * np.abs(ref[k]).max()
        np.testing.assert_allclose(got[k], ref[k], **tol, err_msg=k)


# ---- the three operators, part and scene segmentation ---------------------

@pytest.fixture(scope="module", params=[
    (task, op) for task in DATASETS for op in OPERATORS],
    ids=lambda p: f"{DATASETS[p[0]]}-{p[1]}")
def trained(request):
    task, op = request.param
    jcfg = _operator_jcfg(task, op)
    batch = _seg_batch(jcfg)
    if task == "scene_segmentation":
        batch["labels"][0, ::7] = -1  # unannotated points
    return dict(run_both(jcfg, batch, STEPS), op=op)


def test_seg_operator_eval_logits_match_jax(trained):
    got, ref = trained["logits"]
    width = 5 if trained["task"] == "part_segmentation" else 4
    assert got.shape == ref.shape == (8, trained["cfg"].num_points, width)
    # f32 end to end; XLA and ATen sum matmuls, BatchNorm and the
    # neighborhoods in different orders (the adaptive weight factorizes
    # through the moments where JAX's jnp path gathers)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_seg_operator_grads_match_jax(trained):
    _check_grads(trained["task"], *trained["grads"])


def test_seg_operator_losses_track_jax_over_steps(trained):
    tl, jl = trained["log"]
    # the reordering differences compound over the steps
    np.testing.assert_allclose(tl[:, 0], jl[:, 0], rtol=1e-4)
    np.testing.assert_allclose(tl[:, 1], jl[:, 1], atol=1e-6)
    assert tl[-1, 0] < tl[0, 0]
    assert np.isfinite(float(trained["eval"]["loss"]))


# ---- PartNet's depth ---------------------------------------------------------

@pytest.fixture(scope="module")
def partnet():
    jcfg = _partnet_jcfg()
    return run_both(jcfg, _partnet_batch(jcfg), steps=0, geometry=True)


def test_partnet_depth3_geometry_matches_jax(partnet):
    got, ref = partnet["geometry"]
    assert sorted(got) == sorted(ref) and "up_1" in ref
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_partnet_depth3_eval_logits_match_jax(partnet):
    got, ref = partnet["logits"]
    assert got.shape == ref.shape == (8, 64, sum(STANDIN_PARTS))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_partnet_depth3_grads_match_jax(partnet):
    tg, jg = partnet["grads"]
    # three blocks a stage
    assert any("/Block_2/" in k or "_2/" in k for k in tg)
    _check_grads("part_segmentation", tg, jg)


def test_partnet_depth3_weight_bridge_round_trips(partnet):
    cfg, variables = partnet["cfg"], partnet["variables"]
    model = build_model(cfg)
    state = flax_to_state_dict(variables, model)
    model.load_state_dict(state, strict=True)
    assert model.head.fc.out_features == sum(STANDIN_PARTS)
    back = state_dict_to_flax(model.state_dict(), model)
    flat = flatten_variables(variables)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    # and back again: the state_dict from the bridged variables is equal
    again = flax_to_state_dict(back, build_model(cfg))
    for k, t in model.state_dict().items():
        assert torch.equal(again[k], t), k


# ---- chip_smoke's runs of every config ----------------------------------------

@pytest.mark.parametrize("name", chip_smoke.CONFIG_RUNS)
def test_chip_smoke_config_runs_are_the_files(name):
    """Each run's config is its file read by ``load_config``, but for the
    batch (8 clouds where the file has 32, PartNet's xyz config at its
    32) and PartNet's stand-in part table."""
    want = load_config(os.path.join(REPO, "configs", name + ".yaml"))
    got = chip_smoke.file_config(name)
    cuts = {}
    if name == chip_smoke.PARTNET_FULL:
        assert got.batch_size == want.batch_size == 32
    else:
        cuts["batch_size"] = chip_smoke.SEG_TRAIN_BATCH
    if want.datasets == "partnet":
        assert list(want.num_parts) == []
        cuts["num_parts"] = list(chip_smoke.PARTNET_STANDIN_PARTS)
    assert got.to_dict() == dict(want.to_dict(), **cuts)
    assert chip_smoke.config_kind(got) in chip_smoke.AGG_KERNELS


def test_chip_smoke_runs_every_config():
    """The config runs and the ModelNet40 training phases' configs are the
    twenty files under ``configs/`` (but the synthetic smoke config); the
    runs that the timing tools name are config runs."""
    files = sorted(
        f"{d}/{f[:-5]}" for d in os.listdir(os.path.join(REPO, "configs"))
        if d != "synthetic"
        for f in os.listdir(os.path.join(REPO, "configs", d)))
    earlier = [f"modelnet40/{n}" for n in (
        "pospool_xyz_avg", "pospool_sincos_avg",
        "adaptive_weight_dp_fc1_avg", "pointwisemlp_dp_fi_df_fc1_max",
        "pseudo_grid")]
    assert len(files) == 20
    assert sorted(earlier + list(chip_smoke.CONFIG_RUNS)) == files
    assert set(chip_smoke.SEG_TRAIN_FILES.values()) <= set(
        chip_smoke.CONFIG_RUNS)
    assert len(set(chip_smoke.PARTNET_STANDIN_PARTS)) > 1
    assert len(chip_smoke.PARTNET_STANDIN_PARTS) == 17


@pytest.mark.parametrize("kind", ["xyz", "sincos", "adaptive"])
def test_chip_smoke_agg_exact_is_the_plain_arithmetic(kind):
    """``chip_smoke.agg_exact``, which judges the bf16 aggregation forwards
    on the card where the plain version strays: on f32 features the plain
    version's arithmetic, to the rounding of its f32 sums; on bf16
    features the plain version's bf16 products and sums within their
    tolerance of it."""
    from closerlook3d_tpu_torch.ops.neighbors import ball_query_plain

    gen = torch.Generator().manual_seed(3)
    s = torch.rand((2, 200, 3), generator=gen) * 2 - 1
    q = s[:, :50].contiguous()
    smask = torch.ones((2, 200), dtype=torch.bool)
    smask[1, 150:] = False
    idx, nmask = ball_query_plain(q, s, 0.5, 16, smask[:, :50], smask)
    plain = chip_smoke.agg_ops(kind)[1]
    f = torch.randn((2, 200, 24), generator=gen)
    for red in ("avg", "sum"):
        exact = chip_smoke.agg_exact(kind, q, s, f, idx, nmask, 0.5, red)
        assert exact.dtype == torch.float64
        torch.testing.assert_close(plain(q, s, f, idx, nmask, 0.5, red),
                                   exact.float(), rtol=1e-5, atol=1e-5)
        fb = f.to(torch.bfloat16)
        exact = chip_smoke.agg_exact(kind, q, s, fb, idx, nmask, 0.5, red)
        got = plain(q, s, fb, idx, nmask, 0.5, red)
        torch.testing.assert_close(
            got.double(), exact,
            **chip_smoke._pospool_fwd_tol(torch.bfloat16, red, kind))
        assert not torch.equal(got.double(), exact)


def _counting(plain):
    def fake(*args, **kwargs):
        fake.launches += 1
        return plain(*args, **kwargs)
    fake.launches = 0
    return fake


@pytest.fixture
def counting_route(monkeypatch):
    """CPU tensors down the kernel route, each kernel wrapper replaced by a
    counting wrapper around its plain version or twin."""
    mods = (aggregation, gather_reduce, grouping, moments, neighbors,
            pseudo_grid, sampling)
    for fn in chip_smoke.kernel_wrappers().values():
        mod = next(m for m in mods if getattr(m, fn.__name__, None) is fn)
        plain = ("knn_plain" if fn.__name__.startswith("knn")
                 else fn.__name__.replace("_cuda", "_plain"))
        monkeypatch.setattr(mod, fn.__name__,
                            _counting(getattr(mod, plain)))
    for mod in mods:
        monkeypatch.setattr(mod, "use_kernel", lambda t: True)
    return chip_smoke.kernel_wrappers()


def _launch_cfg(task: str, kind: str):
    """A tiny config of ``task`` with the aggregation ``kind`` (as
    ``AGG_KERNELS`` names it): part segmentation at PartNet's depth 3,
    whose last stage (8 clouds of 4 points) takes the point-wise MLP's
    K13 + K7 route; scene segmentation on grid budgets."""
    jcfg = (_partnet_jcfg() if task == "part_segmentation"
            else _tiny_jcfg(task))
    cfg = Config(jcfg.to_dict())
    names = {"xyz": "pospool_xyz_avg", "pwmlp":
             "pointwisemlp_dp_fi_df_fc1_max", **OPERATORS}
    full = load_config(os.path.join(REPO, "configs/s3dis",
                                    names[kind] + ".yaml"))
    cfg.local_aggregation_type = full.local_aggregation_type
    for group in ("pospool", "adaptive_weight", "pointwisemlp",
                  "pseudo_grid"):
        cfg[group] = copy.deepcopy(full[group])
    cfg.dropout_rate = 0.0
    return cfg


@pytest.mark.parametrize("kind", chip_smoke.TRAIN_KINDS)
@pytest.mark.parametrize("task", sorted(DATASETS))
def test_chip_smoke_seg_launches_are_exact(counting_route, task, kind):
    """A train step and an eval step of the model launch each kernel
    wrapper exactly as ``seg_train_launches`` says, and a request as
    ``seg_launches`` says."""
    from closerlook3d_tpu_torch.serving import Predictor

    cfg = _launch_cfg(task, kind)
    assert chip_smoke.config_kind(cfg) == kind
    model, loss_fn = build_model_and_loss(cfg)
    num_parts = (list(cfg.num_parts) if task == "part_segmentation"
                 else None)
    batch = chip_smoke.seg_train_batch(cfg, 6, padded=(1,))
    state = create_train_state(model, make_optimizer(cfg, 2)[0],
                               device="cpu")
    wrappers = counting_route
    for mode, run in (
            ("train", lambda: make_train_step(loss_fn, task, num_parts)(
                state, batch, 0)),
            ("forward", lambda: make_eval_step(loss_fn, task, num_parts)(
                state, batch))):
        chip_smoke.reset_counts(wrappers)
        run()
        chip_smoke.check_counts(f"{task} {kind} {mode}",
                                chip_smoke.read_counts(wrappers),
                                chip_smoke.seg_train_launches(cfg, kind,
                                                              mode))
    predictor = Predictor(cfg, state.model.state_dict(), device="cpu")
    chip_smoke.reset_counts(wrappers)
    predictor(batch["xyz"], batch["mask"], batch["features"])
    chip_smoke.check_counts(f"{task} {kind} request",
                            chip_smoke.read_counts(wrappers),
                            chip_smoke.seg_launches(cfg))
    per_step = chip_smoke.seg_train_launches(cfg, kind, "train")
    calls = sum(chip_smoke.agg_calls_per_stage(cfg))
    assert calls == 2 + 2 * (1 + cfg.depth)  # three stages
    if kind == "pwmlp" and task == "part_segmentation":
        # the last stage (8 x 4 queries) on the K13 + K7 route
        assert per_step["neighborhood_sum"] == 1 + cfg.depth
        assert per_step["pwmlp_stats"] == calls - 1 - cfg.depth
