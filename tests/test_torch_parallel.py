"""The port's data parallelism on the CPU: 2 gloo ranks against one process.

Two ranks (``parallel/spawn.py::run_ranks``: spawned processes, a
``file://`` rendezvous in a temporary directory, ATen on one thread, each
run bounded by its own time limit, past which the test fails and names
the ranks still running) run ``tests/torch_dp_worker.py``'s cases once,
in one module fixture; each test then holds one case to its reference:

* ``BatchIterator``'s process shards equal the JAX package's (numpy on
  both sides), wrap included, with equal batch counts on every process;
* the host collectives at world size 2 (a pytree's sum, the min, a ragged
  concat), as ``tests/multihost_worker.py`` checks the JAX ones, and
  ``all_reduce_sum``'s backward;
* sync ``BatchNorm`` and ``MaskedBatchNorm`` (uneven masks), forward and
  backward, equal to one process on the concatenated input;
* 3 train steps of four tiny configs (classification with dropout on,
  the point-wise MLP, part segmentation, scene segmentation with uneven
  masks and ``ignore_label``) equal to one process stepping the
  concatenated batch: losses, accuracies, every gradient and parameter,
  running statistics; parameters bit-equal across the ranks;
* ``Trainer.fit`` for 2 epochs in a shared workdir, then a resume: one
  writer, equal best and resumed step on both ranks; a NaN in one rank's
  model stops every rank at the same step; ``cli.train``'s main, then
  ``cli.evaluate``'s, in a group the ranks joined before, which both
  leave up;
* the classification and part-segmentation evaluators over 2 ranks equal
  to the JAX evaluators run on each rank's shard in turn; S3DIS voting
  over 2 ranks on two generated rooms: each room voted by its owner
  alone, equal rounds, summed confusions.

f32 tolerance of the step parity: the two runs sum the same terms in
another order (each rank's partial sums, then across ranks), so losses
agree within rtol 1e-5 (1e-4 for the point-wise MLP, whose BatchNorm
variance E[h^2] - mean^2 cancels), the first step's gradients and the
last step's (from the ranks' own state before it) within 1e-4 relative
plus 1e-5 of each tensor's largest entry, and parameters and running
statistics after 3 steps within ``STATE_TOL``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import torch_dp_worker as worker
from closerlook3d_tpu.data import synthetic as jsynthetic
from closerlook3d_tpu.data.loader import BatchIterator as JBatchIterator
from closerlook3d_tpu.train import evaluate as jev
from closerlook3d_tpu_torch.data.loader import BatchIterator
from closerlook3d_tpu_torch.data.synthetic import SyntheticClassification
from closerlook3d_tpu_torch.models.build import build_model_and_loss
from closerlook3d_tpu_torch.parallel import collectives, mesh
from closerlook3d_tpu_torch.parallel.spawn import run_ranks
from closerlook3d_tpu_torch.utils.config import Config, load_config
from test_torch_evaluate import _rooms
from tests.test_cli import OVERRIDES as CLI_OVERRIDES
from tests.test_datasets import _write_s3dis_raw
from test_torch_operator_models import _tiny_jcfg as _operator_jcfg
from test_torch_ops import _one_aten_thread  # noqa: F401
from test_torch_segmentation import _seg_batch, _tiny_jcfg
from tests.test_multihost import _IdxDataset
from tests.test_train import tiny_cfg as jtiny_cfg

RANKS = 2
STEPS = 3
TIMEOUT = 150.0
EVAL_SAMPLES, EVAL_POINTS = 11, 48  # 11 over 2 ranks: one sample wraps


# ---- the loader's shards (no ranks needed) ---------------------------------

@pytest.mark.parametrize("n,count,shuffle,drop_last", [
    (24, 4, True, True), (10, 3, False, False), (11, 2, True, True),
    (11, 2, False, False), (5, 4, True, False)])
def test_batch_iterator_shards_equal_jax(n, count, shuffle, drop_last):
    shards = []
    for p in range(count):
        # labels are the sample indices
        ours = BatchIterator(_IdxDataset(n), 2, shuffle=shuffle,
                             feature_spec="xyz", seed=3, drop_last=drop_last,
                             process_index=p, process_count=count)
        ref = JBatchIterator(_IdxDataset(n), 2, shuffle=shuffle,
                             feature_spec="xyz", seed=3, drop_last=drop_last,
                             process_index=p, process_count=count)
        ours.set_epoch(1)
        ref.set_epoch(1)
        assert len(ours) == len(ref)
        pairs = list(zip(ours, ref))
        assert len(pairs) == len(ref) == len(list(ref))
        for a, b in pairs:
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        shards.append([b["label"] for b in ours])
    # every process yields the same number of batches (lockstep steps)
    assert len({len(s) for s in shards}) == 1
    if not drop_last:  # the wrap pads: every sample is seen
        assert {int(x) for s in shards for b in s for x in b} == set(
            range(n))


def test_one_process_layout(monkeypatch):
    """Without torchrun's environment nothing joins a group; the layout
    is one process, the backend follows from the layout alone."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.maybe_initialize_distributed("cpu") is False
    lay = mesh.make_mesh(-1, 1, mesh.layout("cpu"))
    assert (lay.world_size, lay.rank, lay.backend) == (1, 0, None)
    assert mesh.plan_layout("cpu", 2, 1, 1, 2).backend == "gloo"
    with pytest.raises(ValueError, match="needs world_size and rank"):
        mesh.maybe_initialize_distributed("cpu", init_method="file:///x")
    batch = mesh.shard_batch({"xyz": np.ones((2, 3), np.float32),
                              "mask": np.ones(2, bool)}, lay)
    assert batch["xyz"].dtype == torch.float32
    assert batch["mask"].dtype == torch.bool


# ---- the cases the ranks run -------------------------------------------------

def _weights(cfg, seed: int) -> dict:
    torch.manual_seed(seed)
    model, _ = build_model_and_loss(cfg)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _cls_case():
    jcfg = graft._flagship_cfg(tiny=True)
    jcfg.dropout_rate = 0.5  # dropout on: the global mask, rows per rank
    jcfg.base_learning_rate = 0.1
    jcfg.warmup_epoch = 1
    cfg = Config(jcfg.to_dict())
    batch = next(iter(BatchIterator(
        SyntheticClassification(16, cfg.num_points, num_classes=8, seed=7),
        16, shuffle=True, feature_spec="xyz", seed=1, spatial_sort=True)))
    batch = {k: batch[k] for k in ("xyz", "mask", "features", "label")}
    batch["mask"][3, 50:] = False
    batch["mask"][12, 20:] = False
    return cfg, batch


def _pwmlp_case():
    cfg = Config(_operator_jcfg("pwmlp").to_dict())
    _, batch = _cls_case()
    return cfg, batch


def _seg_case(task):
    jcfg = _tiny_jcfg(task)
    jcfg.dropout_rate = 0.5
    jcfg.base_learning_rate = 0.1
    jcfg.warmup_epoch = 1
    batch = _seg_batch(jcfg)
    if task == "scene_segmentation":
        batch["labels"][0, ::7] = -1  # unannotated points, rank 0
        batch["labels"][1, :40] = -1
        # rank 1's clouds hold far fewer valid points than rank 0's
        batch["mask"][4:, jcfg.num_points // 5:] = False
    else:
        batch["mask"][5, 10:] = False
    keys = ("xyz", "mask", "features", "labels", "category")
    return Config(jcfg.to_dict()), {k: batch[k] for k in keys if k in batch}


STEP_CASES = ("cls", "pwmlp", "part", "scene")
# parameters and running statistics after 3 steps: the two runs' rounding
# differences (~1e-7 after the first step) are amplified by the later
# steps where a train-mode BatchNorm's variance nearly cancels (the point-
# wise MLP's E[h^2] - mean^2, the scene model's coarse stage over few
# valid points); the step itself is held tightly by the test of the last
# step from the ranks' own state
STATE_TOL = {"cls": dict(rtol=1e-5, atol=2e-6),
             "part": dict(rtol=1e-5, atol=2e-6),
             "pwmlp": dict(rtol=1e-4, atol=1e-4),
             "scene": dict(rtol=1e-4, atol=1e-4)}


def _step_case(name):
    if name == "cls":
        return _cls_case()
    if name == "pwmlp":
        return _pwmlp_case()
    return _seg_case("part_segmentation" if name == "part"
                     else "scene_segmentation")


def _bn_case():
    rng = np.random.default_rng(21)
    x = (rng.normal(size=(6, 10, 5)) * 2 + 1).astype(np.float32)
    mask = rng.random((6, 10)) < 0.7
    mask[3:, 4:] = False  # rank 1: fewer valid rows
    dy = rng.normal(size=x.shape).astype(np.float32)
    weights = {"weight": rng.uniform(0.5, 1.5, 5).astype(np.float32),
               "bias": rng.normal(size=5).astype(np.float32),
               "running_mean": rng.normal(size=5).astype(np.float32),
               "running_var": rng.uniform(0.5, 1.5, 5).astype(np.float32)}
    return x, mask, dy, weights


def _two_test_rooms(root):
    """Two generated rooms in the test area (``Area_5``), prepared, and
    the port's S3DIS config over them."""
    raw = "Stanford3dDataset_v1.2_Aligned_Version/Area_5"
    _write_s3dis_raw(str(root / "other"), np.random.default_rng(10))
    os.makedirs(root / "rooms" / raw)
    shutil.move(str(root / "other" / raw / "office_5"),
                str(root / "rooms" / raw / "office_6"))
    cfg = _rooms(root / "rooms", 9)  # adds Area_1 and Area_5's office_5
    cfg.num_votes = 3
    cfg.batch_size = 2
    return cfg


def _eval_cfg():
    cfg = load_config(overrides={"batch_size": 4, "input_features": "xyz",
                                 "num_parts": [2, 3]})
    return dict(cfg)


def _trainer_cfg():
    cfg = Config(jtiny_cfg().to_dict())
    for k, v in {"epochs": 2, "save_interval": 1, "val_interval": 1,
                 "log_interval": 1, "synthetic_train_size": 48,
                 "synthetic_val_size": 20, "data_parallel": RANKS,
                 "keep_checkpoints": 2}.items():
        cfg[k] = v
    return cfg


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    steps = {name: _step_case(name) for name in STEP_CASES}
    weights = {name: _weights(cfg, 5) for name, (cfg, _) in steps.items()}
    rooms = _two_test_rooms(root)
    workdir = str(root / "shared_run")
    jobs = [("collectives", "collective_cases", ()),
            ("bn", "batchnorm_cases", _bn_case())]
    jobs += [(name, "train_steps", (dict(cfg), weights[name], batch, STEPS))
             for name, (cfg, batch) in steps.items()]
    jobs += [("eval", "evaluator_cases", (_eval_cfg(), EVAL_SAMPLES,
                                          EVAL_POINTS, dict(rooms))),
             ("trainer", "trainer_run", (dict(_trainer_cfg()), workdir)),
             ("nan", "nan_abort", (dict(_trainer_cfg(), epochs=1),
                                   str(root / "nan_run"))),
             ("cli", "cli_mains_in_group", (CLI_ARGV, str(root / "cli")))]
    ranks = run_ranks(worker.suite, RANKS, (jobs,), timeout=TIMEOUT,
                      threads=1)
    # the single-process references, in this process (no process group)
    single = {name: worker.train_steps(dict(cfg), weights[name], batch,
                                       STEPS)
              for name, (cfg, batch) in steps.items()}
    single["bn"] = worker.batchnorm_cases(*_bn_case())
    return {"ranks": ranks, "single": single, "workdir": workdir,
            "steps": steps}


def _result(cases, name, rank):
    got = cases["ranks"][rank][name]
    if "error" in got:
        pytest.fail(f"rank {rank}, case {name}:\n{got['error']}")
    return got


def test_ranks_are_processes_of_their_own(cases):
    pids = {r["pid"] for r in cases["ranks"]}
    assert len(pids) == RANKS and os.getpid() not in pids
    assert collectives.world() == (1, 0)  # this process joined no group


def test_collectives_two_ranks(cases):
    for rank in range(RANKS):
        got = _result(cases, "collectives", rank)
        assert got["world"] == RANKS
        np.testing.assert_array_equal(got["sum"]["a"], np.arange(4.0) * 3)
        assert got["sum"]["b"][0] == 3 and isinstance(got["sum"]["b"], tuple)
        np.testing.assert_array_equal(got["sum"]["b"][1][0], np.eye(2))
        assert got["sum_int"] == 3 and isinstance(got["sum_int"], int)
        assert got["min"] == 4.0
        np.testing.assert_array_equal(got["concat"],
                                      [[0, 0], [1, 1], [1, 1]])
        assert got["concat_empty"].shape == (2, 3)
        assert got["concat_empty"].dtype == np.float32


def test_all_reduce_sum_forward_and_backward(cases):
    for rank in range(RANKS):
        got = _result(cases, "collectives", rank)
        # sum over ranks of x * (r + 1) = 3x
        np.testing.assert_array_equal(got["reduced"], np.arange(3.0) * 3)
        # every rank's loss reads the sum: the cotangents (r + 2) of both
        # ranks (2 + 3) reach each rank's input, times its (r + 1)
        np.testing.assert_array_equal(got["grad"], np.full(3, 5.0 * (rank
                                                                     + 1)))


@pytest.mark.parametrize("kind", ["bn", "masked"])
def test_sync_batchnorm_equals_one_process(cases, kind):
    ref = cases["single"]["bn"][kind]
    for rank in range(RANKS):
        got = _result(cases, "bn", rank)[kind]
        rows = slice(rank * 3, (rank + 1) * 3)
        # f32 sums of the same rows in another order
        np.testing.assert_allclose(got["y"], ref["y"][rows], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["dx"], ref["dx"][rows], rtol=1e-4,
                                   atol=1e-5)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6,
                                       atol=1e-6)
    # the parameter gradients are per rank: their sum is the whole's
    for k in ("dweight", "dbias"):
        total = sum(_result(cases, "bn", r)[kind][k] for r in range(RANKS))
        np.testing.assert_allclose(total, ref[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", STEP_CASES)
def test_dp_step_equals_one_process(cases, name):
    ref = cases["single"][name]
    got = _result(cases, name, 0)
    np.testing.assert_allclose(got["log"][:, 0], ref["log"][:, 0],
                               rtol=1e-4 if name == "pwmlp" else 1e-5)
    np.testing.assert_array_equal(got["log"][:, 1], ref["log"][:, 1])
    assert got["step"] == ref["step"] == STEPS
    assert sorted(got["grads"]) == sorted(ref["grads"])
    for k, g in ref["grads"].items():  # the first step's
        assert np.abs(g).sum() > 0, k
        np.testing.assert_allclose(got["grads"][k], g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)
    for k, v in ref["state"].items():
        np.testing.assert_allclose(got["state"][k], v, **STATE_TOL[name],
                                   err_msg=k)


@pytest.mark.parametrize("name", STEP_CASES)
def test_dp_last_step_equals_one_process_from_its_state(cases, name):
    """The last step's gradients of the ranks against one process's
    stepping the whole batch from the state the ranks held before it:
    the step itself, apart from the drift of the run before it."""
    cfg, batch = cases["steps"][name]
    got = _result(cases, name, 0)
    ref = worker.last_step_grads(dict(cfg), got["before_last"], batch,
                                 STEPS)
    for k, g in ref.items():
        np.testing.assert_allclose(got["last_grads"][k], g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)


@pytest.mark.parametrize("name", STEP_CASES)
def test_dp_ranks_stay_bit_equal(cases, name):
    a, b = (_result(cases, name, r) for r in range(RANKS))
    np.testing.assert_array_equal(a["log"], b["log"])
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=k)
    for k in a["grads"]:
        np.testing.assert_array_equal(a["grads"][k], b["grads"][k],
                                      err_msg=k)
    # no collective in one process; in two, a fixed number a step
    assert cases["single"][name]["collectives_per_step"] == 0
    assert a["collectives_per_step"] == b["collectives_per_step"] > 0


def test_trainer_fit_two_ranks(cases):
    wd = cases["workdir"]
    runs = [_result(cases, "trainer", r) for r in range(RANKS)]
    firsts = [r["first"] for r in runs]
    # 48 clouds over 2 ranks of 8: 3 steps an epoch
    assert firsts[0]["train_batches"] == firsts[1]["train_batches"] == 3
    assert firsts[0]["val_batches"] == firsts[1]["val_batches"] == 2
    assert firsts[0]["best"] == firsts[1]["best"]
    assert firsts[0]["step"] == firsts[1]["step"] == 6
    assert firsts[0]["ckpt"] == [3, 6] and firsts[0]["best_steps"] in (
        [3], [6])
    assert sorted(os.listdir(os.path.join(wd, "ckpt"))) == [
        "ckpt_6.pt", "ckpt_9.pt"]  # keep 2 after the resumed epoch
    rows = [json.loads(ln) for ln in open(os.path.join(wd, "scalars.jsonl"))]
    keys = [(r["tag"], r["step"]) for r in rows]
    assert len(keys) == len(set(keys)), "two writers"
    assert {"train/loss", "val/acc"} <= {r["tag"] for r in rows}
    with open(os.path.join(wd, "log.txt")) as f:
        assert "2 process(es) of 8 clouds a step on cpu (gloo)" in f.read()


def test_trainer_resumes_two_ranks(cases):
    runs = [_result(cases, "trainer", r)["resumed"] for r in range(RANKS)]
    for r in runs:
        assert (r["start_epoch"], r["step"]) == (3, 6)
        assert r["final_step"] == 9
    assert runs[0]["best"] == runs[1]["best"]
    for k in runs[0]["state"]:  # restored alike, and trained alike
        np.testing.assert_array_equal(runs[0]["state"][k],
                                      runs[1]["state"][k])
        np.testing.assert_array_equal(runs[0]["final"][k],
                                      runs[1]["final"][k])


# 32 clouds over 2 ranks of 8: 2 steps, one epoch, validated
CLI_ARGV = CLI_OVERRIDES + ["epochs=1", "val_interval=1",
                            "synthetic_train_size=32",
                            "synthetic_val_size=16"]


def test_cli_mains_keep_the_callers_group(cases):
    """``cli.train``'s main, then ``cli.evaluate``'s, in a group the ranks
    joined before: neither leaves it, and the evaluation reduces over
    both ranks."""
    runs = [_result(cases, "cli", r) for r in range(RANKS)]
    for r in runs:
        assert r["in_group"] == [True, True]
        assert r["world"][0] == RANKS
    assert runs[0]["best"] == runs[1]["best"]
    assert runs[0]["results"] == runs[1]["results"]
    assert 0.0 <= runs[0]["results"]["accuracy"] <= 1.0


def test_nan_loss_stops_every_rank(cases):
    """A NaN in one rank's model reaches the global loss: every rank
    raises at the same step, and none waits in a collective (the run
    ends within its limit)."""
    got = [_result(cases, "nan", r) for r in range(RANKS)]
    for g in got:
        assert g["raised"] and "non-finite training loss" in g["raised"]
    assert got[0]["raised"] == got[1]["raised"]
    assert got[0]["step"] == got[1]["step"] == 1


def _jax_shard_batches(dataset, cfg):
    """The JAX ``BatchIterator``'s batches of rank 0's shard, then rank
    1's: what the ranks evaluate, in rank order."""
    out = []
    for p in range(RANKS):
        out += list(JBatchIterator(dataset, cfg["batch_size"], shuffle=False,
                                   feature_spec=cfg["input_features"],
                                   drop_last=False, process_index=p,
                                   process_count=RANKS))
    return out


def test_classification_evaluator_two_ranks_equals_jax(cases):
    cfg = Config(_eval_cfg())
    ds = jsynthetic.SyntheticClassification(EVAL_SAMPLES, EVAL_POINTS,
                                            num_classes=8, seed=3)
    ref = jev.evaluate_classification(cfg, None,
                                      worker.oracle_logits(8, True),
                                      _jax_shard_batches(ds, cfg))
    for rank in range(RANKS):
        assert _result(cases, "eval", rank)["cls"] == ref


def test_partseg_evaluator_two_ranks_equals_jax(cases):
    cfg = Config(_eval_cfg())
    ds = jsynthetic.SyntheticPartSegmentation(EVAL_SAMPLES, EVAL_POINTS,
                                              seed=4)
    ref = jev.evaluate_partseg(cfg, ds, None, worker.oracle_logits(5, False),
                               _jax_shard_batches(ds, cfg))
    for rank in range(RANKS):
        # the same shape IoUs in the same order, and integer confusions
        assert _result(cases, "eval", rank)["part"] == ref


def test_s3dis_voting_two_ranks(cases):
    votes = [_result(cases, "eval", r)["voting"] for r in range(RANKS)]
    locs = [v["local"] for v in votes]
    rounds = [loc[2] for loc in locs]
    assert rounds[0] == rounds[1] > 0  # the ranks voted in lockstep
    for rank, v in enumerate(votes):
        # rank r owns room r: the other's potentials stayed pinned
        pots = v["potentials_min"]
        assert pots[rank] >= 3 and pots[1 - rank] == np.inf
        # its confusions count its own room's points alone
        assert locs[rank][0].sum() == v["full_points"][rank]
        conf, sub_conf, nround = v["reduced"]
        np.testing.assert_array_equal(conf, locs[0][0] + locs[1][0])
        np.testing.assert_array_equal(sub_conf, locs[0][1] + locs[1][1])
        assert nround == 2 * rounds[0]
        assert v["result"] == votes[0]["result"]
        assert v["result"]["sphere_batches"] == 2 * rounds[0]


# ---- the launcher's limits ---------------------------------------------------

def test_run_ranks_names_the_failed_rank():
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[1(, 0)?\] failed, "
                       r"rank 1 first(.|\n)*rank one fails here"):
        run_ranks(worker.fail_rank_one, RANKS, timeout=60, threads=1)


def test_run_ranks_times_out_and_kills_the_ranks():
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[0, 1\] of 2 still "
                       r"running after 12 s"):
        run_ranks(worker.hang_rank_one, RANKS, timeout=12, threads=1)
