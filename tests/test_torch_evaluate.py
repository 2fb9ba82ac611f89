"""The port's evaluators on the CPU, against the JAX package.

Ports of ``tests/test_evaluators.py`` (S3DIS voting with an oracle:
perfect scores, bounded sphere batches, full coverage; part mIoU by an
oracle, by votes and by a constant predictor; vote augmentation;
classification votes), driving ``closerlook3d_tpu_torch.train.evaluate``.
Then both packages on the same fixture rooms and batches with the same
seeded, non-oracle logits: S3DIS voting gives the same sphere batches,
potentials and sub-cloud confusion, and the same full-cloud confusion but
for points that are f32 near-ties of the 1-NN projection (the port's
``knn`` in f32, lowest index first; the JAX package's kd-tree in f64);
part segmentation and classification give the same results, votes
included. ``project_to_full``'s Morton-sorted search gives ``knn_plain``'s
distances everywhere and its indices wherever the nearest sub-point is
unique. A logger past round 50 gets ``local_min`` (ROADMAP C2: the
reference raises ``NameError`` there). The collectives are the identity
in one process.
"""

import logging
import types

import numpy as np
import pytest
import torch

from closerlook3d_tpu.data import s3dis as js3dis
from closerlook3d_tpu.data.loader import BatchIterator as JBatchIterator
from closerlook3d_tpu.train import evaluate as jev
from closerlook3d_tpu.utils.config import load_config as jload_config
from closerlook3d_tpu_torch.data import s3dis
from closerlook3d_tpu_torch.data.loader import BatchIterator
from closerlook3d_tpu_torch.ops.neighbors import knn_plain
from closerlook3d_tpu_torch.parallel import collectives
from closerlook3d_tpu_torch.train import evaluate as ev
from closerlook3d_tpu_torch.utils.config import Config, load_config
from tests.test_datasets import _s3dis_cfg, _write_s3dis_raw
from tests.test_evaluators import _TinyClsDataset, _TinyPartDataset
from test_torch_ops import _one_aten_thread  # noqa: F401


def _oracle_logits_factory(num_classes):
    def fn(state, batch):
        del state
        lab = np.asarray(batch["labels"])
        return np.eye(num_classes, dtype=np.float32)[lab] * 10.0
    return fn


def _rooms(tmp_path, seed: int):
    """Two prepared fixture rooms (cell 0.08 m) and the port's config."""
    _write_s3dis_raw(str(tmp_path), np.random.default_rng(seed))
    s3dis.prepare_rooms(str(tmp_path), cell=0.08)
    return Config(_s3dis_cfg(tmp_path).to_dict())


# ------------------------------------------- ports of test_evaluators.py


def test_evaluate_s3dis_voting_oracle(tmp_path):
    cfg = _rooms(tmp_path, 5)
    cfg.num_votes = 2
    ds = s3dis.S3DIS(cfg, "test")
    res = ev.evaluate_s3dis_voting(cfg, ds, state=None,
                                   eval_logits_fn=_oracle_logits_factory(13))
    assert res["sphere_batches"] < 200
    assert res["subcloud_miou"] == pytest.approx(1.0)
    assert res["subcloud_oa"] == pytest.approx(1.0)
    assert res["miou"] == pytest.approx(1.0)
    assert res["oa"] == pytest.approx(1.0)
    # per-class IoU: only floor(1)/ceiling(0) appear; others are 0-denom
    iou = np.array(res["iou_per_class"])
    assert iou[0] == pytest.approx(1.0) and iou[1] == pytest.approx(1.0)


def test_evaluate_s3dis_voting_vote_coverage(tmp_path):
    """Every sub-point receives >= num_votes worth of potential; the
    logits function runs once a sphere batch."""
    cfg = _rooms(tmp_path, 6)
    cfg.num_votes = 1
    ds = s3dis.S3DIS(cfg, "test")
    real_fn = _oracle_logits_factory(13)
    calls = {"n": 0}

    def counting_fn(state, batch):
        calls["n"] += 1
        return real_fn(state, batch)

    res = ev.evaluate_s3dis_voting(cfg, ds, None, counting_fn)
    assert calls["n"] == res["sphere_batches"] >= 1
    assert min(p.min() for p in ds.potentials) >= cfg.num_votes


def test_evaluate_partseg_oracle():
    ds = _TinyPartDataset()
    cfg = load_config()
    cfg.num_parts = list(ds.num_parts)
    # batch of 2 over 5 shapes -> final batch is padded (batch_pad path)
    it = BatchIterator(ds, 2, shuffle=False, feature_spec="xyz",
                       drop_last=False)
    res = ev.evaluate_partseg(cfg, ds, None, _oracle_logits_factory(5),
                              iter(it))
    assert res["ins_miou"] == pytest.approx(1.0)
    assert res["cls_miou"] == pytest.approx(1.0)
    assert res["category_miou"] == pytest.approx(1.0)


def test_vote_augment():
    """Vote 0 is the clean pass; later votes rotate+scale per cloud,
    rotate normals with the cloud, and rebuild features."""
    cfg = load_config()
    cfg.augment_rotation = "so3"
    cfg.input_features = "xyz"
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, size=(3, 16, 3)).astype(np.float32)
    nrm = rng.normal(size=(3, 16, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    batch = {"xyz": xyz, "normals": nrm,
             "mask": np.ones((3, 16), bool), "features": xyz.copy()}

    assert ev.vote_augment(batch, cfg, np.random.default_rng(1), 0) is batch
    out = ev.vote_augment(batch, cfg, np.random.default_rng(1), 1)
    assert not np.allclose(out["xyz"], xyz)  # actually augmented
    np.testing.assert_array_equal(batch["xyz"], xyz)  # input untouched
    np.testing.assert_allclose(
        np.linalg.norm(out["normals"], axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(out["features"], out["xyz"])
    r0 = out["xyz"][0] @ np.linalg.pinv(xyz[0])
    r1 = out["xyz"][1] @ np.linalg.pinv(xyz[1])
    assert not np.allclose(r0, r1, atol=1e-3)
    # the JAX package's draws and arithmetic
    ref = jev.vote_augment(batch, cfg, np.random.default_rng(1), 1)
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_evaluate_partseg_vote_averaging():
    """cfg.vote_eval honors num_votes outside S3DIS."""
    ds = _TinyPartDataset()
    cfg = load_config()
    cfg.num_parts = list(ds.num_parts)
    cfg.vote_eval = True
    cfg.num_votes = 3
    calls = {"n": 0}
    oracle = _oracle_logits_factory(5)

    def fn(state, batch):
        calls["n"] += 1
        return oracle(state, batch)

    it = BatchIterator(ds, 2, shuffle=False, feature_spec="xyz",
                       drop_last=False)
    res = ev.evaluate_partseg(cfg, ds, None, fn, iter(it))
    assert calls["n"] == len(it) * 3
    assert res["ins_miou"] == pytest.approx(1.0)


def test_evaluate_classification_voting():
    ds = _TinyClsDataset()
    cfg = load_config()
    cfg.input_features = "xyz"
    calls = {"n": 0}

    def mask_oracle(state, batch):
        calls["n"] += 1
        n_valid = np.asarray(batch["mask"]).sum(-1)
        # a tensor, as the port's eval functions return
        return torch.from_numpy(np.eye(3, dtype=np.float32)[n_valid - 10]
                                * 10.0)

    it = BatchIterator(ds, 4, shuffle=False, feature_spec="xyz",
                       drop_last=False)
    res = ev.evaluate_classification(cfg, None, mask_oracle, iter(it))
    assert res["accuracy"] == pytest.approx(1.0)
    assert res["num_votes"] == 1 and calls["n"] == len(it)

    cfg.vote_eval = True
    cfg.num_votes = 4
    calls["n"] = 0
    res = ev.evaluate_classification(cfg, None, mask_oracle, iter(it))
    assert res["accuracy"] == pytest.approx(1.0)
    assert res["num_votes"] == 4 and calls["n"] == len(it) * 4


def test_evaluate_partseg_constant_predictor():
    """Always the first part of the category slice: instance mIoU per
    shape = IoU(part0) / parts."""
    ds = _TinyPartDataset(n_shapes=2)
    cfg = load_config()
    cfg.num_parts = list(ds.num_parts)

    def const_fn(state, batch):
        b, n = np.asarray(batch["labels"]).shape
        logits = np.zeros((b, n, 5), np.float32)
        logits[..., 0] = 5.0
        logits[..., 2] = 4.0
        return logits

    it = BatchIterator(ds, 2, shuffle=False, feature_spec="xyz",
                       drop_last=False)
    res = ev.evaluate_partseg(cfg, ds, None, const_fn, iter(it))
    frac0 = (ds[0]["labels"] == 0).mean()
    frac1 = (ds[1]["labels"] == 2).mean()
    expect = np.mean([frac0 / 2, frac1 / 3])
    assert res["ins_miou"] == pytest.approx(expect)
    assert res["cls_miou"] == pytest.approx(expect)


# ------------------------------------------------ parity with the JAX


def _linear_logits(in_dim: int, classes: int, seed: int, as_tensor: bool,
                   pool: bool = False):
    """A seeded linear map of each point's features (and position),
    averaged over the cloud with ``pool``: the same logits for the same
    batch in both packages, not an oracle."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(in_dim, classes)).astype(np.float32)
    wx = rng.normal(size=(3, classes)).astype(np.float32)

    def fn(state, batch):
        out = batch["features"] @ w + batch["xyz"] @ wx
        if pool:
            out = out.mean(1)
        return torch.from_numpy(out) if as_tensor else out
    return fn


def _recording(monkeypatch, module, name: str) -> list:
    """Wrap ``module.name`` so each call's arguments and result are kept."""
    calls = []
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, wrapper)
    return calls


def test_s3dis_voting_matches_jax(tmp_path, monkeypatch):
    jcfg = _s3dis_cfg(tmp_path)
    jcfg.num_votes = 3
    _write_s3dis_raw(str(tmp_path), np.random.default_rng(8))
    js3dis.prepare_rooms(str(tmp_path), cell=0.08)
    cfg = Config(jcfg.to_dict())
    jds, ds = js3dis.S3DIS(jcfg, "test"), s3dis.S3DIS(cfg, "test")
    jconf = _recording(monkeypatch, jev, "iou_from_confusion")
    conf = _recording(monkeypatch, ev, "iou_from_confusion")
    proj = _recording(monkeypatch, ev, "project_to_full")
    state = types.SimpleNamespace(model=torch.nn.Linear(1, 1))  # the CPU
    ref = jev.evaluate_s3dis_voting(
        jcfg, jds, None, _linear_logits(5, 13, 3, as_tensor=False))
    got = ev.evaluate_s3dis_voting(
        cfg, ds, state, _linear_logits(5, 13, 3, as_tensor=True))
    assert got["sphere_batches"] == ref["sphere_batches"] > 1
    for p, q in zip(ds.potentials, jds.potentials):
        np.testing.assert_array_equal(p, q)
    # iou_from_confusion runs on the full cloud's confusion, then the
    # sub-cloud's
    full, sub = conf[0][0][0], conf[1][0][0]
    jfull, jsub = jconf[0][0][0], jconf[1][0][0]
    np.testing.assert_array_equal(sub, jsub)
    for k in ("subcloud_miou", "subcloud_oa"):
        assert got[k] == ref[k]
    # the projection: the port's f32 nearest against the kd-tree's f64
    assert len(proj) == len(ds.xyz)
    near_ties = 0
    for r, (args, (idx, d2)) in enumerate(proj):
        full_xyz, _ = ds.full_cloud(r)
        kd = jds.trees[r].query(full_xyz, k=1)[1]
        sub_xyz = ds.xyz[r]
        d2_kd = ((full_xyz - sub_xyz[kd]) ** 2).sum(-1, dtype=np.float32)
        np.testing.assert_array_equal(
            d2, ((full_xyz - sub_xyz[idx]) ** 2).sum(-1, dtype=np.float32))
        off = idx != kd
        # where they differ, both are nearest to f32 rounding
        assert (np.abs(d2 - d2_kd)[off]
                <= 4 * np.spacing(np.maximum(d2, d2_kd))[off]).all()
        near_ties += int(off.sum())
    # each near-tie moves at most one count between two cells
    assert np.abs(full - jfull).sum() <= 2 * near_ties
    if near_ties == 0:
        assert got == ref


def test_partseg_and_classification_match_jax():
    """Non-oracle logits, with and without votes: the same results."""
    pds, cds = _TinyPartDataset(), _TinyClsDataset()
    for votes in (False, True):
        jcfg = jload_config()
        jcfg.num_parts = list(pds.num_parts)
        jcfg.input_features = "xyz"
        jcfg.vote_eval = votes
        jcfg.num_votes = 3
        cfg = Config(jcfg.to_dict())
        part_fn = _linear_logits(3, 5, 11, as_tensor=False)
        got = ev.evaluate_partseg(cfg, pds, None, part_fn, iter(
            BatchIterator(pds, 2, False, "xyz", drop_last=False)))
        ref = jev.evaluate_partseg(jcfg, pds, None, part_fn, iter(
            JBatchIterator(pds, 2, False, "xyz", drop_last=False)))
        assert got == ref and 0.0 < got["ins_miou"] < 1.0
        cls_fn = _linear_logits(3, 3, 12, as_tensor=False, pool=True)
        got = ev.evaluate_classification(cfg, None, cls_fn, iter(
            BatchIterator(cds, 4, False, "xyz", drop_last=False)))
        ref = jev.evaluate_classification(jcfg, None, cls_fn, iter(
            JBatchIterator(cds, 4, False, "xyz", drop_last=False)))
        assert got == ref


def test_project_to_full_morton_equals_knn_plain_but_exact_ties():
    """The Morton-sorted search gives ``knn_plain``'s d2 at every query
    and its index wherever the nearest sub-point is unique; where its
    index differs, the two sub-points are exactly as far (ties, made
    here by a grid of sub-points and queries on the midpoints)."""
    rng = np.random.default_rng(4)
    g = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1)
    sub = (g.reshape(-1, 3) * 0.25).astype(np.float32)
    sub = sub[rng.permutation(len(sub))]  # neither Morton nor scan order
    full = np.concatenate([
        rng.uniform(0, 2.75, (3000, 3)),
        sub[:500] + np.float32(0.125) * rng.integers(0, 2, (500, 3)),
    ]).astype(np.float32)
    ref_idx, ref_d2 = knn_plain(torch.from_numpy(full)[None],
                                torch.from_numpy(sub)[None], 1)
    ref_idx, ref_d2 = ref_idx[0, :, 0].numpy(), ref_d2[0, :, 0].numpy()
    idx, d2 = ev.project_to_full(sub, full, torch.device("cpu"))
    assert idx.dtype == np.int64 and d2.dtype == np.float32
    np.testing.assert_array_equal(d2, ref_d2)
    off = idx != ref_idx
    assert off.any()  # the sorted order breaks some ties anew
    # every differing index is an exact tie: the same f32 d2
    d2_idx = ((full - sub[idx]) ** 2).sum(-1, dtype=np.float32)
    d2_ref = ((full - sub[ref_idx]) ** 2).sum(-1, dtype=np.float32)
    np.testing.assert_array_equal(d2_idx[off], d2_ref[off])
    # and a unique nearest is always found
    dall = ((full[:, None] - sub[None]) ** 2).sum(-1, dtype=np.float32)
    unique = (dall == dall.min(1, keepdims=True)).sum(1) == 1
    assert unique.any() and not (off & unique).any()


def test_s3dis_voting_logs_local_min_past_round_50(tmp_path, caplog):
    """ROADMAP C2: the reference names an undefined ``min_pot`` in its
    round-50 log line and raises ``NameError`` with a logger; the port
    logs ``local_min``."""
    cfg = _rooms(tmp_path, 9)
    cfg.num_votes = 12
    cfg.batch_size = 1
    ds = s3dis.S3DIS(cfg, "test")
    logger = logging.getLogger("cl3d_torch.test_evaluate")
    with caplog.at_level(logging.INFO, logger=logger.name):
        res = ev.evaluate_s3dis_voting(cfg, ds, None,
                                       _oracle_logits_factory(13),
                                       logger=logger)
    assert res["sphere_batches"] >= 50
    lines = [r.getMessage() for r in caplog.records
             if r.name == logger.name]
    assert len(lines) == res["sphere_batches"] // 50
    assert lines[0].startswith("s3dis eval: 50 sphere batches, "
                               "min potential ")
    assert 0.0 < float(lines[0].rsplit(" ", 1)[1]) < cfg.num_votes


def test_collectives_single_process():
    """The identity in one process; across processes
    ``tests/test_torch_parallel.py`` holds them at world size 2."""
    tree = (np.arange(3.0), 4, [np.eye(2)])
    assert collectives.all_processes_sum(tree) is tree
    assert collectives.all_processes_min(2.5) == 2.5
    x = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(collectives.all_processes_concat(x), x)
    t = torch.arange(3.0)
    assert collectives.all_reduce_sum(t) is t
    assert collectives.reduce_sum(t) is t
    assert collectives.world() == (1, 0)


def test_model_device_and_host_copies():
    assert ev.model_device(None) == torch.device("cpu")
    state = types.SimpleNamespace(model=torch.nn.Linear(2, 2))
    assert ev.model_device(state) == torch.device("cpu")
    t = torch.ones(2, 3, dtype=torch.bfloat16)
    out = ev._fetch_local(t)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    assert ev._fetch_local([[1.0]]).shape == (1, 1)
