"""The segmentation serving path on the CPU, against the JAX package.

Seeded numpy inputs go through both packages (the JAX side on its jnp
paths, and its chunked 1-NN Pallas kernel K11 interpreted): the k-NN
(``knn_plain``, the plain version of K11/K12) with padded, all-masked
and duplicated supports, k = 1, 3 and k > Ns; the decoder's upsampling
ops; the voxel-grid subsampling and its Morton codes; the geometry of a
forward with grid sampling and upsample indices; the numpy copies of the
synthetic segmentation datasets and of ShapeNetPart's part table; tiny
part- and scene-segmentation models (three stages, width 24, f32; the
scene model with grid sampling and ``ones,rgb,height`` features): eval
per-point logits from converted weights, the weight bridge, and
``Predictor``; and the two configs. The k-NN kernel itself is held to
``knn_plain`` on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import conftest
from closerlook3d_tpu.data import shapenetpart as jshapenetpart
from closerlook3d_tpu.data import synthetic as jsynthetic
from closerlook3d_tpu.data.loader import build_features as jbuild_features
from closerlook3d_tpu.data.spatial_host import morton_sort_batch
from closerlook3d_tpu.models import build_model as jbuild_model
from closerlook3d_tpu.models.backbone import (
    compute_geometry as jcompute_geometry)
from closerlook3d_tpu.ops import interpolate as jinterpolate
from closerlook3d_tpu.ops import neighbors as jneighbors
from closerlook3d_tpu.ops import sampling as jsampling
from closerlook3d_tpu.ops import spatial as jspatial
from closerlook3d_tpu.ops.pallas.neighbors import knn1_pallas_chunked
from closerlook3d_tpu.utils.config import load_config as jload_config
from closerlook3d_tpu_torch.convert import (
    flatten_variables, flax_to_state_dict, state_dict_to_flax)
from closerlook3d_tpu_torch.data import shapenetpart, synthetic
from closerlook3d_tpu_torch.models import build_model
from closerlook3d_tpu_torch.models.backbone import compute_geometry
from closerlook3d_tpu_torch.models.build import (
    build_multi_part_segmentation, build_scene_segmentation, part_counts)
from closerlook3d_tpu_torch.ops import interpolate, neighbors, sampling
from closerlook3d_tpu_torch.ops.spatial import morton_code
from closerlook3d_tpu_torch.serving import Predictor
from closerlook3d_tpu_torch.utils.config import Config, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_CONFIGS = {"shapenetpart": "configs/shapenetpart/pospool_xyz_avg.yaml",
               "s3dis": "configs/s3dis/pospool_xyz_avg.yaml"}


@pytest.fixture(autouse=True)
def _jnp_reference(monkeypatch):
    # JAX entry points take their jnp path; Pallas calls run interpreted
    conftest.pallas_test_mode(monkeypatch, ops_impl="jnp")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _clouds(seed, b, n, grid=False):
    """[b, n, 3] points and masks: cloud 0 full, cloud 1 padded, the last
    cloud all masked; ``grid`` puts the points on a 0.25 lattice
    (duplicates and exact distance ties)."""
    rng = np.random.default_rng(seed)
    if grid:
        xyz = rng.integers(-4, 5, size=(b, n, 3)).astype(np.float32) * 0.25
    else:
        xyz = rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, n * 2 // 3:] = False
    mask[-1] = False
    return xyz, mask


@pytest.mark.parametrize("ns,k,grid", [
    (200, 1, False), (200, 3, False), (200, 3, True), (150, 16, False),
    (5, 8, False),   # k > Ns
    (1, 1, False)])
def test_knn_plain_matches_jax(ns, k, grid):
    s, smask = _clouds(61, 3, ns, grid)
    q, _ = _clouds(62, 3, 70, grid)
    for mask in (smask, None):
        ref_idx, ref_d2 = jneighbors.knn(q, s, k, support_mask=mask)
        idx, d2 = neighbors.knn(*_t(q, s), k,
                                None if mask is None else _t(mask)[0])
        assert idx.dtype == torch.int32 and d2.dtype == torch.float32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        # the same f32 outer difference, but XLA's CPU code may contract
        # a square and its sum into one FMA where the port rounds each
        # step (as its kernel does): within 2 ulp
        np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d2),
                                   rtol=2.4e-7, atol=0)


def test_knn_plain_matches_the_chunked_1nn_kernel(monkeypatch):
    """K11 (``knn1_pallas_chunked``, interpreted) at Ns >= 1024 on padded
    clouds: the same 1-NN and d2. (It moves masked supports to 1e6
    coordinates where the jnp path adds 1e10; the two differ only when a
    cloud has no valid support, which is left out here.)"""
    s, smask = _clouds(63, 2, 1100)
    smask[1] = np.random.default_rng(64).random(1100) > 0.4
    q, _ = _clouds(65, 2, 300)
    ref_idx, ref_d2 = knn1_pallas_chunked(q, s, support_mask=smask)
    idx, d2 = neighbors.knn_plain(*_t(q, s), 1, *_t(smask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d2), rtol=2.4e-7,
                               atol=0)  # as against the jnp path


def test_knn_plain_takes_k_above_the_kernel_list():
    s, smask = _clouds(66, 2, 40)
    idx, _ = neighbors.knn(*_t(s, s), 20, *_t(smask))  # plain: any k
    assert idx.shape == (2, 40, 20)


@pytest.mark.parametrize("op", ["nearest", "three"])
def test_upsampling_ops_match_jax(op):
    s, smask = _clouds(67, 3, 60)
    smask[0, :50] = False  # fewer valid supports than k in cloud 0
    q, _ = _clouds(68, 3, 150)
    f = np.random.default_rng(69).normal(size=(3, 60, 7)).astype(np.float32)
    if op == "nearest":
        ref = jinterpolate.nearest_upsample(q, s, f, support_mask=smask)
        got = interpolate.nearest_upsample(*_t(q, s, f, smask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        ref = jinterpolate.three_interpolate(q, s, f, support_mask=smask)
        got = interpolate.three_interpolate(*_t(q, s, f, smask))
        # f32 weights 1/d2, normalized, then a 3-term sum: rounding
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def test_morton_code_copy_matches_jax():
    cells = np.random.default_rng(70).integers(0, 1024, size=(4, 500, 3))
    cells = cells.astype(np.int32)
    got = morton_code(torch.from_numpy(cells))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jspatial.morton_code(cells)))


@pytest.mark.parametrize("cell,budget", [
    (0.3, 500),   # every voxel fits
    (0.3, 60),    # the highest Morton keys are dropped
    (1.0, 64), (0.05, 3000)])
def test_grid_subsample_matches_jax(cell, budget):
    xyz, mask = _clouds(71, 3, 2000)
    xyz = xyz * 2.0
    ref_xyz, ref_mask = jsampling.grid_subsample(xyz, cell, budget, mask)
    got_xyz, got_mask = sampling.grid_subsample(*_t(xyz), cell, budget,
                                                *_t(mask))
    assert got_xyz.shape == (3, budget, 3) and got_xyz.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    # each voxel's points summed one after another in sorted order, as
    # JAX's scatter-add sums them: equal to the bit
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(ref_xyz))
    assert not got_mask[-1].any()  # the all-masked cloud
    ref_xyz, ref_mask = jsampling.grid_subsample(xyz, cell, budget)
    got_xyz, got_mask = sampling.grid_subsample(*_t(xyz), cell, budget)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(ref_xyz))


def test_synthetic_segmentation_copies_match_jax():
    for got_ds, ref_ds in (
            (synthetic.SyntheticPartSegmentation(4, 300, seed=2,
                                                 label_noise=0.1),
             jsynthetic.SyntheticPartSegmentation(4, 300, seed=2,
                                                  label_noise=0.1)),
            (synthetic.SyntheticSceneSegmentation(3, 500, seed=2),
             jsynthetic.SyntheticSceneSegmentation(3, 500, seed=2))):
        assert got_ds.num_samples == ref_ds.num_samples
        assert getattr(got_ds, "num_parts", None) == getattr(
            ref_ds, "num_parts", None)
        assert getattr(got_ds, "num_classes", None) == getattr(
            ref_ds, "num_classes", None)
        for i in range(len(ref_ds)):
            a, b = got_ds[i], ref_ds[i]
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i}/{k}")


def test_shapenetpart_table_matches_jax():
    assert shapenetpart.CATEGORIES == jshapenetpart.CATEGORIES
    assert shapenetpart.NUM_PARTS == jshapenetpart.NUM_PARTS
    assert sum(shapenetpart.NUM_PARTS) == 50
    cfg = load_config(os.path.join(REPO, SEG_CONFIGS["shapenetpart"]))
    assert part_counts(cfg) == list(jshapenetpart.NUM_PARTS)
    cfg.datasets = "partnet"
    with pytest.raises(ValueError, match="num_parts"):
        part_counts(cfg)


@pytest.mark.parametrize("name", sorted(SEG_CONFIGS))
def test_segmentation_configs_match_jax(name):
    path = os.path.join(REPO, SEG_CONFIGS[name])
    cfg = load_config(path)
    assert cfg.to_dict() == jload_config(path).to_dict()
    import chip_smoke
    assert chip_smoke.seg_config(name).to_dict() == cfg.to_dict()


def test_segmentation_losses_are_refused():
    cfg = load_config(os.path.join(REPO, SEG_CONFIGS["s3dis"]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_scene_segmentation(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_multi_part_segmentation(cfg)


# ---- tiny segmentation models ----------------------------------------------

def _tiny_jcfg(task):
    """The tiny flagship (three stages, width 24, f32) for a segmentation
    task: part segmentation on the synthetic two-category parts; scene
    segmentation with grid sampling (cells 0.4, 0.8 m: the second stage
    drops voxels beyond its 16-point budget) and ones,rgb,height
    features on synthetic rooms."""
    jcfg = graft._flagship_cfg(tiny=True)
    jcfg.task = task
    jcfg.use_pallas = "never"
    if task == "part_segmentation":
        jcfg.datasets = "synthetic_partseg"
        jcfg.num_parts = [2, 3]
    else:
        jcfg.datasets = "s3dis"
        jcfg.num_points = 256
        jcfg.num_classes = 4
        jcfg.sampling = "grid"
        jcfg.sampleDl = 0.2
        jcfg.radius = 0.3
        jcfg.input_features = "ones,rgb,height"
    return jcfg


def _seg_batch(jcfg):
    if jcfg.task == "part_segmentation":
        ds = jsynthetic.SyntheticPartSegmentation(8, jcfg.num_points, seed=4)
    else:
        ds = jsynthetic.SyntheticSceneSegmentation(8, jcfg.num_points, seed=4)
    samples = [ds[i] for i in range(8)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    batch["features"] = jbuild_features(batch, jcfg.input_features)
    batch = morton_sort_batch(batch)
    batch["mask"][3, jcfg.num_points * 2 // 3:] = False  # a padded cloud
    return batch


@pytest.fixture(scope="module", params=["part_segmentation",
                                        "scene_segmentation"])
def seg_model(request):
    """(task, port config, flax variables with seeded BatchNorm
    statistics, batch, JAX's eval logits, JAX's geometry)."""
    with pytest.MonkeyPatch.context() as mp:
        conftest.pallas_test_mode(mp, ops_impl="jnp")
        jcfg = _tiny_jcfg(request.param)
        batch = _seg_batch(jcfg)
        model, _ = jbuild_model(jcfg)
        args = (batch["xyz"], batch["mask"], batch["features"])
        flat = flatten_variables(jax.tree.map(np.asarray, dict(model.init(
            jax.random.PRNGKey(0), *args, train=False))))
        rng = np.random.default_rng(72)
        for k in sorted(flat):
            if k.endswith(("/mean", "/bias")):
                flat[k] = rng.normal(0, 0.2, flat[k].shape).astype(
                    np.float32)
            elif k.endswith(("/var", "/scale")):
                flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(
                    np.float32)
        nested = {}
        for k, v in flat.items():
            node = nested
            *path, leaf = k.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        logits = np.asarray(jax.jit(lambda v, *a: model.apply(
            v, *a, train=False))(nested, *args))
        geometry = {k: np.asarray(v) for k, v in jcompute_geometry(
            jcfg, jnp.asarray(batch["xyz"]), jnp.asarray(batch["mask"]),
            need_up=True).items()}
    return (request.param, Config(jcfg.to_dict()), flat, batch, logits,
            geometry)


def test_segmentation_geometry_matches_jax(seg_model):
    task, cfg, _, batch, _, ref = seg_model
    got = compute_geometry(cfg, *_t(batch["xyz"], batch["mask"]),
                           need_up=True)
    assert sorted(got) == sorted(ref)
    assert {"up_0", "up_1"} <= set(got) and "up_2" not in got
    for k in ref:
        # integer outputs equal; the grid barycenters equal to the bit
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    if task == "scene_segmentation":
        # the grid budget of the last stage cut voxels in some cloud
        assert ref["mask_2"][:3].all(axis=1).any()


def test_segmentation_eval_logits_match_jax(seg_model):
    task, cfg, flat, batch, ref, _ = seg_model
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(flat, model), strict=True)
    with torch.inference_mode():
        got = model(*_t(batch["xyz"], batch["mask"], batch["features"]))
    width = 5 if task == "part_segmentation" else 4
    assert got.shape == ref.shape == (8, cfg.num_points, width)
    assert got.dtype == torch.float32
    # f32 end to end; XLA and ATen sum matmuls, BatchNorm and PosPool
    # neighborhoods in different orders
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_segmentation_weight_bridge_round_trips(seg_model):
    task, cfg, flat, _, _, _ = seg_model
    model = build_model(cfg)
    state = flax_to_state_dict(flat, model)
    model.load_state_dict(state, strict=True)
    head = "MultiPartSegHead_0" if task == "part_segmentation" else \
        "SceneSegHead_0"
    assert {f"params/{head}/_Decoder_0/ConvBN_1/Dense_0/kernel",
            f"params/{head}/ConvBN_0/Dense_0/kernel",
            f"params/{head}/Dense_0/bias"} <= set(flat)
    back = state_dict_to_flax(model.state_dict(), model)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_predictor_serves_segmentation_on_the_cpu(seg_model):
    task, cfg, flat, batch, ref, _ = seg_model
    predictor = Predictor(cfg, flat, device="cpu")
    got = predictor(batch["xyz"], batch["mask"], batch["features"])
    assert got.device.type == "cpu" and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
