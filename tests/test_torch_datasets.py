"""The port's dataset readers on the CPU, against the JAX package.

Ports of ``tests/test_datasets.py``'s reader tests (its two ``check_data``
tests wait for the data checker), driving ``closerlook3d_tpu_torch.data``
on the fixture files that file's writers make, in each dataset's own
format (txt trees, json split lists, h5 files, raw S3DIS annotations).
Then the same files through both packages: every sample of every
reader and split equal to the JAX reader's, the augmentations in
``data/transforms.py`` equal draw for draw, ``grid_subsample_np`` and the
processed S3DIS rooms equal, and ``build_dataset``'s config fix-ups
equal. S3DIS's sphere queries go through scipy's kd-tree in both
packages: the JAX package's optional C++ module is not built here, and
the test checks that, so parity cannot pass by accident on another tree.
"""

import os

import numpy as np
import pytest

from closerlook3d_tpu import native as jnative
from closerlook3d_tpu.data import build as jbuild
from closerlook3d_tpu.data import modelnet40 as jmodelnet40
from closerlook3d_tpu.data import partnet as jpartnet
from closerlook3d_tpu.data import s3dis as js3dis
from closerlook3d_tpu.data import shapenetpart as jshapenetpart
from closerlook3d_tpu.data import transforms as jtransforms
from closerlook3d_tpu.utils.config import load_config as jload_config
from closerlook3d_tpu_torch.data import build, modelnet40, partnet, s3dis
from closerlook3d_tpu_torch.data import shapenetpart, transforms
from closerlook3d_tpu_torch.utils.config import Config, load_config
from tests.test_datasets import (
    _s3dis_cfg, _write_modelnet40, _write_partnet, _write_s3dis_raw,
    _write_shapenetpart)
from test_torch_ops import _one_aten_thread  # noqa: F401


def _cfg(tmp_path, **kw) -> Config:
    cfg = load_config()
    cfg.data_root = str(tmp_path)
    for k, v in kw.items():
        cfg[k] = v
    return cfg


def _port_s3dis_cfg(tmp_path) -> Config:
    return Config(_s3dis_cfg(tmp_path).to_dict())


# ---------------------------------------------------------------- ModelNet40


def test_modelnet40_fixture(tmp_path):
    _write_modelnet40(str(tmp_path))
    cfg = _cfg(tmp_path, num_points=48)

    train = modelnet40.ModelNet40(cfg, "train")
    test = modelnet40.ModelNet40(cfg, "test")
    assert len(train) == 4 and len(test) == 2

    s = train[0]
    assert s["xyz"].shape == (48, 3) and s["xyz"].dtype == np.float32
    assert s["normals"].shape == (48, 3)
    assert s["mask"].shape == (48,) and s["mask"].all()
    # label comes from the class-name prefix (multi-token names included)
    labels = sorted({int(train[i]["label"]) for i in range(len(train))})
    assert labels == [0, 23]  # airplane=0, night_stand=23

    # test split is deterministic (no augmentation, no random sampling)
    a, b = test[0], test[0]
    np.testing.assert_array_equal(a["xyz"], b["xyz"])

    # second read hits the .npy cache and must agree
    c = modelnet40.ModelNet40(cfg, "test")[0]
    np.testing.assert_array_equal(a["xyz"], c["xyz"])


def test_modelnet40_pads_short_clouds(tmp_path):
    _write_modelnet40(str(tmp_path), n_points=20)
    cfg = _cfg(tmp_path, num_points=32)
    s = modelnet40.ModelNet40(cfg, "test")[0]
    assert s["xyz"].shape == (32, 3)
    assert s["mask"].sum() == 20 and not s["mask"][20:].any()


# -------------------------------------------------------------- ShapeNetPart


def test_shapenetpart_fixture(tmp_path):
    assert sum(shapenetpart.NUM_PARTS) == 50  # official benchmark invariant
    _write_shapenetpart(str(tmp_path))
    cfg = _cfg(tmp_path, num_points=64)

    train = shapenetpart.ShapeNetPart(cfg, "trainval")  # train+val lists
    test = shapenetpart.ShapeNetPart(cfg, "test")
    assert len(train) == 3 and len(test) == 3

    cats = set()
    for i in range(len(test)):
        s = test[i]
        assert s["xyz"].shape == (64, 3)
        assert s["labels"].shape == (64,)
        cat = int(s["category"])
        cats.add(cat)
        lo = {0: 0, 4: 12}[cat] if cat in (0, 4) else None
        assert lo is not None
        valid = s["mask"]
        assert ((s["labels"][valid] >= lo)
                & (s["labels"][valid] < lo + 4)).all()
    assert cats == {0, 4}  # Airplane, Chair


# ------------------------------------------------------------------- PartNet


def test_partnet_fixture_levels(tmp_path):
    _write_partnet(str(tmp_path), 3, ["Chair", "Lamp"], [4, 3])
    _write_partnet(str(tmp_path), 1, ["Chair"], [2])
    cfg = _cfg(tmp_path, num_points=64)

    ds3 = partnet.PartNet(cfg, "train", level=3)
    assert ds3.categories == ["Chair-3", "Lamp-3"]
    assert ds3.num_parts == [4, 3]
    assert len(ds3) == 6  # 3 rows per category
    # labels are offset to global ids by category order
    seen = {0: set(), 1: set()}
    for i in range(len(ds3)):
        s = ds3[i]
        assert s["xyz"].shape == (64, 3)
        cat = int(s["category"])
        seen[cat].update(s["labels"][s["mask"]].tolist())
    assert seen[0] <= set(range(0, 4))
    assert seen[1] <= set(range(4, 7))

    ds1 = partnet.PartNet(cfg, "test", level=1)
    assert ds1.categories == ["Chair-1"] and ds1.num_parts == [2]
    assert len(ds1) == 2


def test_partnet_level_config_wiring(tmp_path):
    """cfg.partnet_level reaches the loader via build_dataset."""
    _write_partnet(str(tmp_path), 1, ["Chair"], [2])
    cfg = _cfg(tmp_path, datasets="partnet", num_points=64, partnet_level=1)
    ds = build.build_dataset(cfg, "train")
    assert ds.categories == ["Chair-1"]
    assert cfg.num_parts == [2]


# --------------------------------------------------------------------- S3DIS


def test_s3dis_prep_and_loader(tmp_path):
    rng = np.random.default_rng(3)
    _write_s3dis_raw(str(tmp_path), rng)
    cache = s3dis.prepare_rooms(str(tmp_path), cell=0.08)
    files = sorted(os.listdir(cache))
    assert files == ["Area_1__office_1.npz", "Area_5__office_5.npz"]
    z = np.load(os.path.join(cache, files[0]))
    assert len(z["sub_xyz"]) < len(z["full_xyz"])  # actually subsampled
    assert set(np.unique(z["sub_labels"])) == {
        s3dis.CLASS_NAMES.index("floor"), s3dis.CLASS_NAMES.index("ceiling")}

    cfg = _port_s3dis_cfg(tmp_path)
    train = s3dis.S3DIS(cfg, "train")
    test = s3dis.S3DIS(cfg, "test")
    assert train.room_names == ["Area_1__office_1"]  # test area excluded
    assert test.room_names == ["Area_5__office_5"]
    assert len(train) == cfg.num_steps * cfg.batch_size

    s = train[0]
    assert s["xyz"].shape == (128, 3)
    assert s["rgb"].shape == (128, 3) and s["rgb"].max() <= 1.0
    assert s["height"].shape == (128, 1)
    assert s["labels"].shape == (128,)
    assert s["mask"].any()
    # xyz is recentred; height keeps absolute z
    assert abs(float(s["xyz"][s["mask"]].mean())) < 1.5
    assert float(s["height"].max()) > 1.5 or float(s["height"].max()) < 0.5


def test_s3dis_potential_coverage(tmp_path):
    """Min-potential picking must spread spheres across the room."""
    rng = np.random.default_rng(4)
    _write_s3dis_raw(str(tmp_path), rng)
    s3dis.prepare_rooms(str(tmp_path), cell=0.08)
    ds = s3dis.S3DIS(_port_s3dis_cfg(tmp_path), "train")
    covered = np.zeros(len(ds.xyz[0]), bool)
    for _ in range(12):
        room_idx, center, idx = ds.pick_center()
        assert room_idx == 0
        covered[idx] = True
    assert covered.mean() > 0.9  # near-total coverage after a few picks


# ------------------------------------------------------ parity with the JAX


def _assert_samples_equal(got: dict, ref: dict, what: str) -> None:
    assert sorted(got) == sorted(ref), what
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, (what, k)
        np.testing.assert_array_equal(g, r, err_msg=f"{what}/{k}")


def _readers(name: str, root: str, split: str, cfg, jcfg):
    """(port dataset, JAX dataset) of ``name`` on the fixture files."""
    if name == "modelnet40":
        return (modelnet40.ModelNet40(cfg, split),
                jmodelnet40.ModelNet40(jcfg, split))
    if name == "shapenetpart":
        return (shapenetpart.ShapeNetPart(cfg, split),
                jshapenetpart.ShapeNetPart(jcfg, split))
    if name == "partnet":
        return (partnet.PartNet(cfg, split, level=3),
                jpartnet.PartNet(jcfg, split, level=3))
    return s3dis.S3DIS(cfg, split), js3dis.S3DIS(jcfg, split)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    _write_modelnet40(root)
    _write_shapenetpart(root)
    _write_partnet(root, 3, ["Chair", "Lamp"], [4, 3])
    _write_s3dis_raw(root, np.random.default_rng(5))
    js3dis.prepare_rooms(root, cell=0.08)
    return root


@pytest.mark.parametrize("name,split", [
    ("modelnet40", "train"), ("modelnet40", "test"),
    ("shapenetpart", "trainval"), ("shapenetpart", "test"),
    ("partnet", "train"), ("partnet", "test"),
    ("s3dis", "train"), ("s3dis", "test")])
def test_readers_match_jax(fixture_root, name, split):
    """Every sample of the split, read twice where reads draw from a
    generator (S3DIS's spheres and potentials advance with each read)."""
    assert not jnative.HAVE_NATIVE  # both packages query scipy's kd-tree
    jcfg = _s3dis_cfg(fixture_root) if name == "s3dis" else jload_config()
    jcfg.data_root = fixture_root
    jcfg.num_points = 128 if name == "s3dis" else 48
    cfg = Config(jcfg.to_dict())
    got, ref = _readers(name, fixture_root, split, cfg, jcfg)
    if name == "s3dis" and split == "test":
        # the JAX package's __len__ fails on its test split (ROADMAP C10)
        n = 4 * sum(max(len(x) // 128, 1) for x in ref.xyz)
    else:
        n = len(ref)
    assert len(got) == n and n > 0
    for i in list(range(min(n, 8))) * 2:
        _assert_samples_equal(got[i], ref[i], f"{name}/{split}/{i}")
    if name == "s3dis":
        for p, q in zip(got.potentials, ref.potentials):
            np.testing.assert_array_equal(p, q)


def test_s3dis_prep_matches_jax(tmp_path):
    """``prepare_rooms`` writes the JAX package's arrays, bit for bit, and
    ``grid_subsample_np`` equals its numpy path with and without
    features and labels."""
    _write_s3dis_raw(str(tmp_path / "a"), np.random.default_rng(6))
    _write_s3dis_raw(str(tmp_path / "b"), np.random.default_rng(6))
    got = s3dis.prepare_rooms(str(tmp_path / "a"), cell=0.08)
    ref = js3dis.prepare_rooms(str(tmp_path / "b"), cell=0.08)
    assert sorted(os.listdir(got)) == sorted(os.listdir(ref))
    for fn in sorted(os.listdir(ref)):
        with np.load(os.path.join(got, fn)) as g, \
                np.load(os.path.join(ref, fn)) as r:
            _assert_samples_equal(dict(g), dict(r), fn)
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    feats = rng.random((3000, 4)).astype(np.float32)
    labs = rng.integers(0, 5, 3000).astype(np.int32)
    for args in [(pts, 0.1), (pts, 0.07, feats, labs), (pts, 0.3, None,
                                                        labs)]:
        for a, b in zip(s3dis.grid_subsample_np(*args),
                        js3dis.grid_subsample_np(*args)):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["none", "z", "so3", "perturb"])
def test_transforms_match_jax(mode):
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    nrm = np.random.default_rng(2).normal(size=(50, 3)).astype(np.float32)
    got, ref = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        rot = transforms.rotation_matrix(mode, got, 0.1, 0.2, 0.3)
        np.testing.assert_array_equal(
            rot, jtransforms.rotation_matrix(mode, ref, 0.1, 0.2, 0.3))
        for a, b in zip(transforms.rotate(pts, rot, nrm),
                        jtransforms.rotate(pts, rot, nrm)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            transforms.scale_and_jitter(pts, got, 0.7, 1.3, (True, False,
                                                               True),
                                        0.01, 0.03, 0.2),
            jtransforms.scale_and_jitter(pts, ref, 0.7, 1.3, (True, False,
                                                               True),
                                         0.01, 0.03, 0.2))
        np.testing.assert_array_equal(
            transforms.color_drop(nrm, got, 0.5),
            jtransforms.color_drop(nrm, ref, 0.5))
        for n, rng_pair in [(30, (got, ref)), (80, (got, ref)),
                            (30, (None, None)), (80, (None, None))]:
            (ga, gm), (ra, rm) = (
                transforms.sample_or_pad([pts, nrm], n, rng_pair[0]),
                jtransforms.sample_or_pad([pts, nrm], n, rng_pair[1]))
            np.testing.assert_array_equal(gm, rm)
            for a, b in zip(ga, ra):
                np.testing.assert_array_equal(a, b)
    assert got.random() == ref.random()  # as many draws on each side


@pytest.mark.parametrize("name", ["modelnet40", "shapenetpart", "partnet",
                                  "s3dis", "synthetic", "synthetic_partseg",
                                  "synthetic_scene"])
def test_build_dataset_matches_jax(fixture_root, name):
    """The factory's config fix-ups (task, class and part counts) and the
    dataset it builds, against the JAX package's."""
    jcfg = _s3dis_cfg(fixture_root) if name == "s3dis" else jload_config()
    jcfg.datasets = name
    jcfg.data_root = fixture_root
    jcfg.num_points = 128 if name == "s3dis" else 48
    cfg = Config(jcfg.to_dict())
    for split in ("train", "test"):
        got = build.build_dataset(cfg, split)
        ref = jbuild.build_dataset(jcfg, split)
        assert type(got).__name__ == type(ref).__name__
        assert cfg.task == jcfg.task
        assert cfg.num_classes == jcfg.num_classes
        assert list(cfg.num_parts) == list(jcfg.num_parts)
        if name != "s3dis" or split == "train":  # ROADMAP C10
            assert len(got) == len(ref)
        _assert_samples_equal(got[0], ref[0], f"{name}/{split}")
    with pytest.raises(ValueError, match="unknown dataset"):
        build.build_dataset(Config(cfg, datasets="nope"), "train")
