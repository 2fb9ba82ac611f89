"""The device Morton sort and the host geometry precompute on the CPU,
against the JAX package.

``ops/spatial.py``'s ``morton_keys``, ``morton_sort`` and
``apply_permutation`` equal the JAX package's exactly, on clouds with
masked tails, an all-masked cloud, repeated points and points sharing a
Morton cell (both argsorts are stable, as ``jnp.argsort`` is). The port's
tiny models of all three tasks sort on the device under
``spatial_sort: always`` and give, in the caller's order, the logits of
``never`` on the host-sorted batch. ``data/geometry.py``'s
``precompute_batch_geometry`` gives the JAX package's ``geom_*`` keys
(integers equal, positions within 1e-6), also through ``BatchIterator``'s
``transform`` hook as ``host_pipeline`` sets it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import conftest
from closerlook3d_tpu.data import geometry as jgeometry
from closerlook3d_tpu.data import synthetic as jsynthetic
from closerlook3d_tpu.data.loader import BatchIterator as JBatchIterator
from closerlook3d_tpu.ops import spatial as jspatial
from closerlook3d_tpu_torch.data import synthetic
from closerlook3d_tpu_torch.data.geometry import precompute_batch_geometry
from closerlook3d_tpu_torch.data.loader import (
    BatchIterator, build_features, host_pipeline)
from closerlook3d_tpu_torch.data.spatial_host import morton_sort_batch
from closerlook3d_tpu_torch.models import build_model
from closerlook3d_tpu_torch.ops import spatial
from closerlook3d_tpu_torch.utils.config import Config
from test_torch_ops import _one_aten_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _jnp_reference(monkeypatch):
    # JAX entry points take their jnp path
    conftest.pallas_test_mode(monkeypatch, ops_impl="jnp")


def _sort_cloud(case: str):
    """(xyz [3, 200, 3] f32, mask [3, 200] bool or None)."""
    rng = np.random.default_rng(17)
    xyz = rng.normal(size=(3, 200, 3)).astype(np.float32)
    mask = np.ones((3, 200), bool)
    if case == "masked":
        mask[1, 120:] = False  # a padded tail
        mask[2] = False  # all masked: every key the sentinel
        xyz[1, 120:] = 0.0
    elif case == "repeated":
        xyz[0, 100:] = xyz[0, :100]  # every point twice
        xyz[1] = np.round(xyz[1] * 2) / 2  # many points a Morton cell
        xyz[2, :] = xyz[2, :1]  # one point 200 times: a zero extent
        mask[0, 150:] = False
    elif case != "no_mask":
        raise ValueError(case)
    return xyz, None if case == "no_mask" else mask


@pytest.mark.parametrize("case", ["masked", "repeated", "no_mask"])
def test_morton_sort_matches_jax(case):
    xyz, mask = _sort_cloud(case)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    keys = spatial.morton_keys(torch.from_numpy(xyz), tm)
    np.testing.assert_array_equal(
        keys.numpy(), np.asarray(jspatial.morton_keys(jnp.asarray(xyz), jm)))
    perm, inv = spatial.morton_sort(torch.from_numpy(xyz), tm)
    jperm, jinv = jspatial.morton_sort(jnp.asarray(xyz), jm)
    assert perm.dtype == inv.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    # equal keys kept their order: the stable-sort trap
    k = keys.numpy()
    sk = np.take_along_axis(k, perm.numpy().astype(np.int64), 1)
    tied = sk[:, 1:] == sk[:, :-1]
    assert tied.any() == (case != "no_mask")
    assert (np.diff(perm.numpy(), axis=1)[tied] > 0).all()


def test_apply_permutation_matches_jax():
    rng = np.random.default_rng(3)
    xyz, mask = _sort_cloud("masked")
    perm, inv = spatial.morton_sort(torch.from_numpy(xyz),
                                    torch.from_numpy(mask))
    jperm = jnp.asarray(perm.numpy())
    for shape in [(3, 200), (3, 200, 5), (3, 200, 2, 4)]:
        x = rng.normal(size=shape).astype(np.float32)
        got = spatial.apply_permutation(torch.from_numpy(x), perm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jspatial.apply_permutation(jnp.asarray(x), jperm)))
        np.testing.assert_array_equal(
            spatial.apply_permutation(got, inv).numpy(), x)
    bools = spatial.apply_permutation(torch.from_numpy(mask), perm)
    assert bools.dtype == torch.bool
    np.testing.assert_array_equal(bools.numpy(), np.asarray(
        jspatial.apply_permutation(jnp.asarray(mask), jperm)))


def _tiny_cfg(task: str) -> Config:
    """The tiny flagship (three stages, width 24, f32) for ``task``."""
    cfg = Config(graft._flagship_cfg(tiny=True).to_dict())
    cfg.task = task
    if task == "part_segmentation":
        cfg.datasets = "synthetic_partseg"
        cfg.num_parts = [2, 3]
    elif task == "scene_segmentation":
        cfg.datasets = "s3dis"
        cfg.num_points = 256
        cfg.num_classes = 4
        cfg.sampling = "grid"
        cfg.sampleDl = 0.2
        cfg.radius = 0.3
        cfg.input_features = "ones,rgb,height"
    return cfg


def _unsorted_batch(cfg, seed: int) -> dict:
    """Four synthetic clouds of the task, in their generators' order (not
    Morton-sorted), the second padded."""
    n = cfg.num_points
    if cfg.task == "classification":
        ds = synthetic.SyntheticClassification(4, n, seed=seed)
    elif cfg.task == "part_segmentation":
        ds = synthetic.SyntheticPartSegmentation(4, n, seed=seed)
    else:
        ds = synthetic.SyntheticSceneSegmentation(4, n, seed=seed)
    samples = [ds[i] for i in range(4)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    batch["mask"][1, n * 2 // 3:] = False
    batch["features"] = build_features(batch, cfg.input_features)
    return batch


@pytest.mark.parametrize("task", ["classification", "part_segmentation",
                                  "scene_segmentation"])
def test_device_sort_gives_host_sorted_logits_in_caller_order(task):
    cfg = _tiny_cfg(task)
    batch = _unsorted_batch(cfg, seed=5)
    # the host sort's permutation, carried by an index array
    n = cfg.num_points
    host = morton_sort_batch(dict(batch, order=np.tile(np.arange(n),
                                                       (4, 1))))
    assert not (host["order"] == np.arange(n)).all()
    models = {mode: build_model(Config(cfg.to_dict(), spatial_sort=mode))
              for mode in ("always", "never")}
    models["never"].load_state_dict(models["always"].state_dict())
    with torch.inference_mode():
        got = models["always"](*[torch.from_numpy(batch[k])
                                 for k in ("xyz", "mask", "features")])
        ref = models["never"](*[torch.from_numpy(host[k])
                                for k in ("xyz", "mask", "features")])
    ref = ref.numpy()
    if task != "classification":
        # per-point logits back in the caller's order
        inv = np.argsort(host["order"], axis=1)
        ref = np.take_along_axis(ref, inv[..., None], 1)
        assert got.shape == (4, n, ref.shape[-1])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _geometry_batch(cfg, seed: int) -> dict:
    if cfg.task == "classification":
        ds = jsynthetic.SyntheticClassification(4, cfg.num_points, seed=seed)
    else:
        ds = jsynthetic.SyntheticSceneSegmentation(4, cfg.num_points,
                                                   seed=seed)
    samples = [ds[i] for i in range(4)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    batch["mask"][2, cfg.num_points // 2:] = False
    batch["features"] = build_features(batch, cfg.input_features)
    return batch


def _d2(q, s, idx):
    """f32 Σ_d (q_d - s_d)², rounded after each step, of each query row of
    ``q`` [B, Nq, 3] to the supports ``idx`` [B, Nq, K] names."""
    nb = np.arange(len(q))[:, None, None]
    d2 = np.zeros(idx.shape, np.float32)
    for d in range(3):
        diff = (q[:, :, None, d] - s[nb, idx, d]).astype(np.float32)
        d2 = (d2 + diff * diff).astype(np.float32)
    return d2


def _geometry_pairs(key: str):
    """(query positions key, support positions key) of an index key."""
    kind, s = key[5:].rsplit("_", 1)
    s = int(s)
    support = {"idx": s, "sidx": s - 1, "up": s + 1}[kind]
    return f"geom_xyz_{s}", f"geom_xyz_{support}"


def _assert_geometry_equal(got: dict, ref: dict) -> None:
    """Positions within 1e-6, masks equal, neighbor indices equal but for
    the order of 1-ulp near-ties: the JAX package's jnp ball query and
    k-NN run under jit, where XLA fuses Σ (q_d - s_d)² into multiply-adds
    and may order two supports whose f32 sums tie (or differ by an ulp)
    the other way; the port rounds each step and takes the lower index.
    Every index that differs names a support at the same distance, to an
    ulp, as the one it replaces."""
    assert sorted(got) == sorted(ref)
    assert any(k.startswith("geom_") for k in ref)
    for k in ref:
        if ref[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        elif not k[5:].startswith(("idx", "sidx", "up")):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            gi, ri = got[k], ref[k]
            if k.startswith("geom_up"):
                gi, ri = gi[..., None], ri[..., None]
            qk, sk = _geometry_pairs(k)
            dg = _d2(got[qk], got[sk], gi.astype(np.int64))
            dr = _d2(got[qk], got[sk], ri.astype(np.int64))
            off = gi != ri
            assert (np.abs(dg - dr)[off]
                    <= np.spacing(np.maximum(dg, dr))[off]).all(), k


@pytest.mark.parametrize("task", ["classification", "scene_segmentation"])
def test_precompute_batch_geometry_matches_jax(task):
    jcfg = graft._flagship_cfg(tiny=True)
    cfg = _tiny_cfg(task)
    for key in ("task", "datasets", "num_points", "num_classes", "sampling",
                "sampleDl", "radius", "input_features"):
        jcfg[key] = cfg[key]
    jcfg.spatial_sort = cfg.spatial_sort = "auto"
    batch = _geometry_batch(cfg, seed=9)
    ref = jgeometry.precompute_batch_geometry(
        {k: v.copy() for k, v in batch.items()}, jcfg)
    got = precompute_batch_geometry(
        {k: v.copy() for k, v in batch.items()}, cfg)
    _assert_geometry_equal(got, ref)
    if task == "scene_segmentation":
        assert "geom_up_0" in got
        # the labels were permuted with the points
        assert not (got["labels"] == batch["labels"]).all()


def test_batch_iterator_transform_hook_matches_jax_trainer():
    """``host_pipeline`` sets the loader as the JAX ``Trainer`` does
    (``closerlook3d_tpu/train/loop.py``): the geometry precompute replaces
    the host sort; without it ``spatial_sort: host`` sorts."""
    import functools

    cfg = _tiny_cfg("classification")
    assert host_pipeline(cfg) == {"transform": None, "spatial_sort": True}
    cfg.spatial_sort = "always"
    assert host_pipeline(cfg)["spatial_sort"] is False
    cfg.spatial_sort = "host"
    cfg.precompute_geometry = True
    opts = host_pipeline(cfg)
    assert opts["spatial_sort"] is False and opts["transform"] is not None

    jcfg = graft._flagship_cfg(tiny=True)
    jcfg.precompute_geometry = True
    ds = jsynthetic.SyntheticClassification(6, cfg.num_points, seed=2)
    ref = list(JBatchIterator(
        ds, 4, shuffle=True, feature_spec="xyz", seed=1, drop_last=False,
        transform=functools.partial(jgeometry.precompute_batch_geometry,
                                    cfg=jcfg), spatial_sort=False))
    got = list(BatchIterator(ds, 4, shuffle=True, feature_spec="xyz",
                             seed=1, drop_last=False, **opts))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _assert_geometry_equal(g, r)
