"""Segmentation training on the CPU, against the JAX package.

Seeded numpy inputs go through the JAX function and the port's
counterpart:

* the plain ball query and k-NN in query chunks (512 from 4096 queries
  up, as the JAX backbone chunks its ball query): equal to the unchunked
  result bit for bit at a chunk boundary that does not divide Nq, one
  chunk's distances at a time, and the chunk passed by
  ``compute_geometry``;
* the segmentation losses (masked CE with ignored labels, the
  multi-shape CE over the category slice) and ``category_slice_mask``,
  values and gradients, f32 and bf16 logits;
* the metrics of ``train/metrics.py`` and the step's segmentation
  accuracy (masked to the category slice for part segmentation);
* tiny part- and scene-segmentation models (the tiny configs of
  ``tests/test_torch_segmentation.py``: three stages, width 24, f32,
  dropout 0; the scene model with grid sampling, ``ones,rgb,height`` and
  some labels at ``ignore_label``) and the tiny part-segmentation model
  with the point-wise MLP of ``configs/shapenetpart/
  pointwisemlp_dp_fi_df_fc1_max.yaml``, whose last stage (8 clouds of 4
  points) takes the K13 + K7 route of ``pwmlp_minmax_stats``: first-step
  gradients, and loss and accuracy over three train steps, against JAX's
  ``make_train_step``; the builders and the weight bridge.

The JAX side runs its jnp paths (``use_pallas="never"``). The CUDA path
of the same steps is held to the plain one on the card by
``chip_smoke.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from closerlook3d_tpu.models import build_model as jbuild_model
from closerlook3d_tpu.models import losses as jlosses
from closerlook3d_tpu.train import metrics as jmetrics
from closerlook3d_tpu.train import schedules as jschedules
from closerlook3d_tpu.train.step import make_train_step as jmake_train_step
from closerlook3d_tpu.train.step import task_metrics as jtask_metrics
from closerlook3d_tpu_torch.convert import (
    flatten_variables, flax_to_state_dict, state_dict_to_flax)
from closerlook3d_tpu_torch.models import (
    build_model, build_model_and_loss, build_multi_part_segmentation,
    build_scene_segmentation)
from closerlook3d_tpu_torch.models import losses
from closerlook3d_tpu_torch.ops import neighbors
from closerlook3d_tpu_torch.train import (
    create_train_state, make_eval_step, make_optimizer, make_train_step,
    metrics)
from closerlook3d_tpu_torch.train.step import task_metrics
from closerlook3d_tpu_torch.utils.config import Config, load_config
from test_torch_operator_models import (  # noqa: F401  (a fixture)
    _one_aten_thread, _seeded_variables)
from test_torch_segmentation import _seg_batch, _tiny_jcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- the plain neighbor searches in query chunks -----------------------------

def test_query_chunk_follows_the_jax_backbone():
    assert neighbors.query_chunk(4095) is None
    assert neighbors.query_chunk(4096) == 512
    assert neighbors.query_chunk(15000) == 512


@pytest.mark.parametrize("chunk", [7, 512])
def test_chunked_plain_searches_equal_unchunked_bit_for_bit(chunk):
    """Nq = 1100 is a multiple of neither chunk; duplicated points and a
    padded and an all-masked cloud give ties and padded slots."""
    rng = np.random.default_rng(80)
    s = rng.integers(-8, 9, size=(3, 600, 3)).astype(np.float32) * 0.125
    q = np.concatenate([s, rng.uniform(-1, 1, (3, 500, 3)).astype(
        np.float32)], axis=1)
    smask = np.ones((3, 600), bool)
    smask[1, 400:] = False
    smask[2] = False
    qmask = np.ones((3, 1100), bool)
    qmask[1, 700:] = False
    qt, st, qm, sm = _t(q, s, qmask, smask)
    ref = neighbors.ball_query_plain(qt, st, 0.3, 20, qm, sm)
    got = neighbors.ball_query_plain(qt, st, 0.3, 20, qm, sm,
                                     chunk_size=chunk)
    assert ref[1].any() and not ref[1].all()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k in (1, 3):
        ref = neighbors.knn_plain(qt, st, k, sm)
        got = neighbors.knn_plain(qt, st, k, sm, chunk_size=chunk)
        assert torch.equal(got[0], ref[0])
        # d2 equal to the bit, as integers
        assert torch.equal(got[1].view(torch.int32), ref[1].view(torch.int32))


def test_plain_searches_hold_one_chunk_of_distances(monkeypatch):
    """Each [B, q, Ns] distance block of a chunked call covers at most one
    chunk of queries; unchunked, one block covers them all."""
    blocks = []
    real = neighbors.pairwise_dist2

    def recording(q, s):
        blocks.append(q.shape[1])
        return real(q, s)

    monkeypatch.setattr(neighbors, "pairwise_dist2", recording)
    q, s = _t(*[np.random.default_rng(i).uniform(-1, 1, (2, n, 3)).astype(
        np.float32) for i, n in ((88, 1100), (89, 300))])
    neighbors.ball_query_plain(q, s, 0.3, 8, chunk_size=512)
    neighbors.knn_plain(q, s, 1, chunk_size=512)
    assert blocks == [512, 512, 76] * 2
    blocks.clear()
    neighbors.ball_query(q, s, 0.3, 8)
    neighbors.knn(q, s, 1)
    assert blocks == [1100, 1100]


def test_compute_geometry_passes_the_chunk(monkeypatch):
    """compute_geometry gives each ball query and upsample k-NN the chunk
    of its query count, as the JAX backbone gives its ball queries."""
    from closerlook3d_tpu_torch.models import backbone

    calls = []

    def ball_query(q, s, r, k, query_mask=None, support_mask=None,
                   chunk_size=None):
        calls.append(("ball_query", q.shape[1], chunk_size))
        shape = (*q.shape[:2], k)
        return (torch.zeros(shape, dtype=torch.int32),
                torch.zeros(shape, dtype=torch.bool))

    def knn(q, s, k, support_mask=None, chunk_size=None):
        calls.append(("knn", q.shape[1], chunk_size))
        return (torch.zeros((*q.shape[:2], k), dtype=torch.int32),
                torch.zeros((*q.shape[:2], k)))

    monkeypatch.setattr(backbone, "ball_query", ball_query)
    monkeypatch.setattr(backbone, "knn", knn)
    cfg = Config(_tiny_jcfg("scene_segmentation").to_dict())
    cfg.num_points = 5000
    cfg.npoints = [5000, 4096, 300]
    cfg.sampleDl = 0.01
    xyz = torch.rand((1, 5000, 3)) * 4
    backbone.compute_geometry(cfg, xyz, torch.ones((1, 5000), dtype=bool),
                              need_up=True)
    assert sorted(calls) == sorted([
        ("ball_query", 5000, 512), ("ball_query", 4096, 512),
        ("ball_query", 4096, 512), ("ball_query", 300, None),
        ("ball_query", 300, None), ("knn", 5000, 512), ("knn", 4096, 512)])


# ---- losses ---------------------------------------------------------------------

NUM_PARTS = (4, 2, 3)


def _logits(seed, *shape, scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _port_and_jax(port_fn, jax_fn, logits, dtype, *args):
    """(port value, port d/dlogits, JAX value, JAX d/dlogits) with the
    logits in ``dtype`` on both sides."""
    jl = jnp.asarray(logits).astype(jnp.bfloat16 if dtype == "bf16"
                                    else jnp.float32)
    jv, jg = jax.value_and_grad(lambda x: jax_fn(x, *args[1]))(jl)
    x = torch.from_numpy(logits).to(torch.bfloat16 if dtype == "bf16"
                                    else torch.float32).requires_grad_(True)
    v = port_fn(x, *args[0])
    (g,) = torch.autograd.grad(v, x)
    return (float(v.detach()), g.float().numpy(), float(jv),
            np.asarray(jg.astype(jnp.float32)))


def _check_loss(got, atol=1e-6):
    v, g, jv, jg = got
    assert np.isfinite(v) and np.isfinite(g).all()
    # f32 softmax and sums in another order
    np.testing.assert_allclose(v, jv, rtol=1e-6)
    np.testing.assert_allclose(g, jg, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_masked_cross_entropy_matches_jax(dtype, smoothing):
    rng = np.random.default_rng(81)
    logits = _logits(82, 3, 50, 13)
    labels = rng.integers(0, 13, size=(3, 50)).astype(np.int32)
    labels[0, ::5] = -1  # unannotated points
    mask = np.ones((3, 50), bool)
    mask[1, 30:] = False
    mask[2] = False
    pl, pm = _t(labels, mask)
    _check_loss(_port_and_jax(
        lambda x, *a: losses.masked_cross_entropy(x, *a,
                                                  smoothing=smoothing),
        lambda x, *a: jlosses.masked_cross_entropy(x, *a,
                                                   smoothing=smoothing),
        logits, dtype, (pl, pm), (jnp.asarray(labels), jnp.asarray(mask))))
    # no valid point: 0, not NaN
    v = losses.masked_cross_entropy(torch.from_numpy(logits), pl,
                                    torch.zeros_like(pm))
    assert float(v) == 0.0


def test_category_part_table_and_slice_mask_match_jax():
    np.testing.assert_array_equal(losses.category_part_table(NUM_PARTS),
                                  jlosses.category_part_table(NUM_PARTS))
    cats = np.array([0, 2, 1, 2], np.int32)
    got = losses.category_slice_mask(torch.from_numpy(cats), NUM_PARTS)
    ref = jlosses.category_slice_mask(jnp.asarray(cats), NUM_PARTS)
    assert got.dtype == torch.bool and got.shape == (4, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.sum(1).tolist() == [4, 3, 2, 3]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_multi_shape_cross_entropy_matches_jax(dtype, smoothing):
    """Global part ids inside each sample's slice; logits up to ~3e4 so
    that bf16 logits beside the -1e9 outside the slice would overflow
    if the loss did not cast to f32 first."""
    rng = np.random.default_rng(83)
    cats = np.array([0, 2, 1, 2], np.int32)
    table = jlosses.category_part_table(NUM_PARTS)
    labels = np.stack([rng.integers(table[c, 0], table[c, 0] + table[c, 1],
                                    size=40) for c in cats]).astype(np.int32)
    mask = np.ones((4, 40), bool)
    mask[3, 25:] = False
    logits = _logits(84, 4, 40, 9)
    logits[0, 0] = 3e4
    args = (labels, cats, mask)
    _check_loss(_port_and_jax(
        lambda x, *a: losses.multi_shape_cross_entropy(
            x, *a, num_parts=NUM_PARTS, smoothing=smoothing),
        lambda x, *a: jlosses.multi_shape_cross_entropy(
            x, *a, num_parts=NUM_PARTS, smoothing=smoothing),
        logits, dtype, _t(*args), [jnp.asarray(a) for a in args]),
        atol=1e-6)


# ---- metrics ---------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(85)
    preds = rng.integers(0, 6, size=(3, 200)).astype(np.int32)
    labels = rng.integers(-1, 6, size=(3, 200)).astype(np.int32)
    labels[0, :5] = 7  # beyond num_classes: left out
    mask = rng.random((3, 200)) > 0.2
    for m in (mask, None):
        got = metrics.confusion_matrix(
            *_t(preds, labels), 6, None if m is None else _t(m)[0])
        ref = np.asarray(jmetrics.confusion_matrix(
            preds, labels, 6, None if m is None else jnp.asarray(m)))
        np.testing.assert_array_equal(got.numpy(), ref)
        for a, b in zip(metrics.iou_from_confusion(got),
                        jmetrics.iou_from_confusion(ref)):
            np.testing.assert_allclose(a, b, rtol=1e-12)
    parts = (4, 2, 6)
    cats = [0, 2, 2, 1, 0]
    table = jlosses.category_part_table(parts)
    pl = [rng.integers(table[c, 0], table[c, 0] + table[c, 1], size=64)
          for c in cats]
    ll = [np.where(rng.random(64) > 0.3, p, table[c, 0])
          for p, c in zip(pl, cats)]
    assert metrics.shapenetpart_miou(pl, ll, cats, parts) == \
        jmetrics.shapenetpart_miou(pl, ll, cats, parts)
    assert metrics.shapenetpart_shape_iou(pl[1], ll[1], 2, parts) == \
        jmetrics.shapenetpart_shape_iou(pl[1], ll[1], 2, parts)
    ious = rng.random(7)
    assert metrics.miou_from_shape_ious(ious, [0, 1, 1, 2, 0, 2, 2], 4) == \
        jmetrics.miou_from_shape_ious(ious, [0, 1, 1, 2, 0, 2, 2], 4)
    confs = [rng.integers(0, 20, size=(n, n)) for n in (3, 5)] + [
        np.zeros((2, 2))]
    assert metrics.partnet_miou(confs) == jmetrics.partnet_miou(confs)
    meter, jmeter = metrics.AverageMeter(), jmetrics.AverageMeter()
    for v, n in ((0.5, 3), (2.0, 1)):
        meter.update(v, n)
        jmeter.update(v, n)
    assert meter.avg == jmeter.avg


@pytest.mark.parametrize("task", ["part_segmentation", "scene_segmentation"])
def test_segmentation_accuracy_matches_jax(task):
    rng = np.random.default_rng(86)
    cats = np.array([0, 2, 1], np.int32)
    batch = {"labels": rng.integers(0, 9, size=(3, 30)).astype(np.int32),
             "mask": rng.random((3, 30)) > 0.3, "category": cats}
    logits = _logits(87, 3, 30, 9)
    got = task_metrics(task, torch.from_numpy(logits),
                       dict(zip(batch, _t(*batch.values()))), NUM_PARTS)
    ref = jtask_metrics(task, jnp.asarray(logits),
                        {k: jnp.asarray(v) for k, v in batch.items()},
                        NUM_PARTS)
    np.testing.assert_allclose(float(got["acc"]), float(ref["acc"]),
                               rtol=1e-6)


# ---- tiny segmentation models: train steps against JAX ----------------------

STEPS = 3
PWMLP_YAML = "configs/shapenetpart/pointwisemlp_dp_fi_df_fc1_max.yaml"


def _tiny_train_jcfg(kind):
    jcfg = _tiny_jcfg("scene_segmentation" if kind == "scene"
                      else "part_segmentation")
    if kind == "part_pwmlp":
        full = load_config(os.path.join(REPO, PWMLP_YAML))
        jcfg.local_aggregation_type = full.local_aggregation_type
        for key, value in full.pointwisemlp.items():
            jcfg.pointwisemlp[key] = value
    jcfg.dropout_rate = 0.0
    jcfg.base_learning_rate = 0.1
    jcfg.warmup_epoch = 1
    return jcfg


def run_tiny_seg(kind):
    """First-step gradients and STEPS train steps (loss, accuracy) of one
    tiny segmentation config in JAX and in the port, from the same
    variables and batch."""
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp, ops_impl="jnp")
        jcfg = _tiny_train_jcfg(kind)
        cfg = Config(jcfg.to_dict())
        batch = _seg_batch(jcfg)
        if kind == "scene":
            batch["labels"][0, ::7] = -1  # unannotated points
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        model, loss_fn = jbuild_model(jcfg)
        num_parts = (tuple(jcfg.num_parts) if jcfg.task == "part_segmentation"
                     else None)
        tx, _ = jschedules.make_optimizer(jcfg, 2)
        state, variables = _seeded_variables(jcfg, model, tx, jbatch)

        def loss_of(params):
            logits, _ = model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                jbatch["xyz"], jbatch["mask"], jbatch["features"],
                train=True, mutable=["batch_stats"])
            if jcfg.task == "part_segmentation":
                return loss_fn(logits, jbatch["labels"], jbatch["category"],
                               jbatch["mask"])
            return loss_fn(logits, jbatch["labels"], jbatch["mask"])

        jgrads = flatten_variables({"params": jax.tree.map(
            np.asarray, jax.jit(jax.grad(loss_of))(state.params))})
        jstep = jmake_train_step(model, loss_fn, jcfg.task, donate=False,
                                 num_parts=num_parts)
        jlog = []
        for _ in range(STEPS):
            state, m = jstep(state, jbatch, jax.random.PRNGKey(1))
            jlog.append((float(m["loss"]), float(m["acc"])))

    tmodel, tloss_fn = build_model_and_loss(cfg)
    tmodel.load_state_dict(flax_to_state_dict(variables, tmodel))
    ttx, _ = make_optimizer(cfg, 2)
    tstate = create_train_state(tmodel, ttx, device="cpu")
    tstep = make_train_step(tloss_fn, cfg.task, num_parts)
    tlog = []
    for i in range(STEPS):
        tstate, m = tstep(tstate, batch, 0)
        tlog.append((float(m["loss"]), float(m["acc"])))
        if i == 0:
            tgrads = state_dict_to_flax(
                {n: p.grad for n, p in tmodel.named_parameters()}, tmodel,
                params_only=True)
    _, emetrics = make_eval_step(tloss_fn, cfg.task, num_parts)(tstate, batch)
    return {"kind": kind, "cfg": cfg, "variables": variables,
            "grads": (tgrads, jgrads), "log": (np.array(tlog),
                                               np.array(jlog)),
            "eval": emetrics}


@pytest.fixture(scope="module", params=["part", "scene", "part_pwmlp"])
def trained(request):
    return run_tiny_seg(request.param)


def test_seg_train_step_grads_match_jax(trained):
    tg, jg = trained["grads"]
    assert sorted(tg) == sorted(jg)
    if trained["kind"] == "part_pwmlp":
        assert any("pw_kernel_0" in k for k in tg)
    for k in jg:
        assert np.abs(tg[k]).sum() > 0, k
        # f32; BN backward over small batches amplifies reordering in
        # small-norm gradients (as tests/test_torch_train.py). The point-
        # wise MLP factorizes where JAX's jnp path gathers, and its masked
        # BN variance E[h^2] - mean^2 cancels (JAX's own cross-path
        # tolerance, tests/test_pallas_pwmlp.py)
        tol = (dict(rtol=5e-4, atol=5e-5 * np.abs(jg[k]).max())
               if trained["kind"] == "part_pwmlp"
               else dict(rtol=1e-4, atol=1e-5 * np.abs(jg[k]).max()))
        if trained["kind"] == "scene" and k.endswith(
                "ResNetBackbone_0/ConvBN_0/Dense_0/kernel"):
            # the stem reads ``ones,rgb,height``: constant or near constant
            # over a room's regions, which the train-mode BatchNorm
            # centres, so this gradient is a difference of nearly equal
            # f32 sums (~1e-6 of rounding, 1.4e-5 of the largest entry)
            tol["atol"] = 3e-5 * np.abs(jg[k]).max()
        np.testing.assert_allclose(tg[k], jg[k], **tol, err_msg=k)


def test_seg_train_losses_track_jax_over_steps(trained):
    tl, jl = trained["log"]
    # the reordering differences compound over the steps
    np.testing.assert_allclose(tl[:, 0], jl[:, 0], rtol=1e-4)
    np.testing.assert_allclose(tl[:, 1], jl[:, 1], atol=1e-6)
    assert tl[-1, 0] < tl[0, 0]


def test_seg_eval_step_and_bridge(trained):
    cfg, variables = trained["cfg"], trained["variables"]
    assert np.isfinite(float(trained["eval"]["loss"]))
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    back = state_dict_to_flax(model.state_dict(), model)
    flat = flatten_variables(variables)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("name,path", [
    ("shapenetpart_pwmlp", PWMLP_YAML),
    ("s3dis", "configs/s3dis/pospool_xyz_avg.yaml")])
def test_chip_smoke_seg_train_configs_are_the_yamls(name, path):
    """chip_smoke.py's training configs, set in code: the files as they
    stand, but for ShapeNetPart's 8 clouds a step (its 32 over four
    data-parallel ranks)."""
    import chip_smoke

    want = load_config(os.path.join(REPO, path)).to_dict()
    if name == "shapenetpart_pwmlp":
        assert want["batch_size"] == 32
        want["batch_size"] = chip_smoke.SEG_TRAIN_BATCH
    assert chip_smoke.seg_train_config(name).to_dict() == want
    cfg = chip_smoke.seg_train_config(name)
    kind = chip_smoke.config_kind(cfg)
    per_step = chip_smoke.seg_train_launches(cfg, kind, "train")
    if kind == "pwmlp":  # stage 4 (8 x 8 queries) takes K13 + K7
        assert {k: per_step[k] for k in (
            "pwmlp_stats", "pwmlp_stats_bwd", "neighborhood_sum",
            "neighborhood_sum_bwd", "gather_sub_minmax",
            "gather_sub_minmax_bwd")} == dict(
            pwmlp_stats=11, pwmlp_stats_bwd=11, neighborhood_sum=3,
            neighborhood_sum_bwd=3, gather_sub_minmax=3,
            gather_sub_minmax_bwd=3)
    else:
        assert per_step["pospool_xyz"] == per_step["pospool_xyz_bwd"] == 14
        assert per_step["knn1"] == per_step["knn"] == 2


def test_segmentation_builders_return_model_and_loss():
    """The builders that used to refuse: (model, loss) for both configs;
    ShapeNetPart's loss takes its 50-part table."""
    for name, build in (("shapenetpart", build_multi_part_segmentation),
                        ("s3dis", build_scene_segmentation)):
        cfg = load_config(os.path.join(REPO, f"configs/{name}/"
                                       "pospool_xyz_avg.yaml"))
        cfg.width, cfg.depth = 24, 1  # the builders, not the width
        model, loss_fn = build(cfg)
        assert loss_fn.keywords["smoothing"] == cfg.label_smoothing
        if name == "shapenetpart":
            assert sum(loss_fn.keywords["num_parts"]) == 50
            assert model.head.fc.out_features == 50
        else:
            assert model.head.fc.out_features == 13
        state = create_train_state(model, make_optimizer(cfg, 10)[0],
                                   device="cpu")
        assert state.model is model and state.step == 0
    cfg.task = "detection"
    with pytest.raises(ValueError, match="unknown task"):
        build_model_and_loss(cfg)
