"""The port's training engine on the CPU, against the JAX package.

``Trainer`` of both packages on ``tests/test_train.py``'s tiny config
(f32, dropout 0, the JAX side on its jnp paths), 2 epochs on small
synthetic splits, from the same initial weights (the JAX ``Trainer``'s,
through ``convert.flax_to_state_dict``): the same batches in the same
order, the same ``scalars.jsonl`` tags and steps with losses and
accuracies within f32 tolerance, and final parameters within it. Then
ports of ``tests/test_train.py``'s six single-process tests (overfit,
checkpoint round trip, schedules, kill and resume, best checkpoint, NaN
abort), the resumed run bit-equal to an uninterrupted one; AdamW against
``optax.adamw``; and ``PrefetchIterator``, with a regression test of the
JAX package's dropped end marker (ROADMAP C7). Tests that wait on a
thread bound the wait themselves.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from closerlook3d_tpu.data import loader as jloader
from closerlook3d_tpu.data import synthetic as jsynthetic
from closerlook3d_tpu.train import schedules as jschedules
from closerlook3d_tpu.train.loop import Trainer as JTrainer
from closerlook3d_tpu.train.loop import device_batch as jdevice_batch
from closerlook3d_tpu.utils.config import load_config as jload_config
from closerlook3d_tpu_torch.convert import (
    flatten_variables, flax_to_state_dict, key_map, state_dict_to_flax)
from closerlook3d_tpu_torch.data.loader import BatchIterator, PrefetchIterator
from closerlook3d_tpu_torch.data.synthetic import SyntheticClassification
from closerlook3d_tpu_torch.models import build_classification
from closerlook3d_tpu_torch.models.build import build_model
from closerlook3d_tpu_torch.train import (
    create_train_state, make_lr_schedule, make_optimizer, make_train_step)
from closerlook3d_tpu_torch.train.checkpoints import CheckpointManager
from closerlook3d_tpu_torch.train.loop import Trainer, device_batch
from closerlook3d_tpu_torch.train.schedules import AdamW
from closerlook3d_tpu_torch.utils.config import Config, load_config
from tests.test_train import tiny_cfg as jtiny_cfg
from test_torch_ops import _one_aten_thread  # noqa: F401


def tiny_cfg(**changes) -> Config:
    """``tests/test_train.py::tiny_cfg`` as a port config."""
    cfg = Config(jtiny_cfg().to_dict())
    for k, v in changes.items():
        cfg[k] = v
    return cfg


def make_batch(cfg, seed=0):
    ds = SyntheticClassification(cfg.batch_size, cfg.num_points,
                                 cfg.num_classes, seed=seed)
    samples = [ds[i] for i in range(cfg.batch_size)]
    return {"xyz": np.stack([s["xyz"] for s in samples]),
            "mask": np.stack([s["mask"] for s in samples]),
            "features": np.stack([s["xyz"] for s in samples]),
            "label": np.stack([s["label"] for s in samples])}


def state_tensors(state) -> dict:
    """Parameters, BatchNorm buffers and the optimizer's per-parameter
    state of a train state."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for idx, per in state.optimizer.state_dict()["state"].items():
        out.update({f"opt/{idx}/{k}": v for k, v in per.items()
                    if isinstance(v, torch.Tensor)})
    return out


def assert_bit_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert sorted(ta) == sorted(tb)
    assert any(k.startswith("opt/") for k in ta)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def scalars(workdir):
    with open(os.path.join(workdir, "scalars.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def run_with_limit(fn, seconds):
    """fn() in a daemon thread; fails if it has not returned in
    ``seconds`` (a hang fails the test instead of stalling the worker)."""
    out, err = [], []

    def target():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err.append(e)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still running after {seconds} s"
    if err:
        raise err[0]
    return out[0]


# ---- JAX Trainer vs the port's, same config and initial weights ------------

PARITY = dict(dropout_rate=0.0, use_pallas="never", epochs=2,
              synthetic_train_size=32, synthetic_val_size=16,
              log_interval=1, val_interval=1, save_interval=1)


def _trainers(tmp_path_factory):
    """A JAX and a port ``Trainer`` on the PARITY config, the port's
    weights set to the JAX one's initial variables."""
    jcfg = jtiny_cfg()
    for k, v in PARITY.items():
        setattr(jcfg, k, v)
    jt = JTrainer(jcfg, str(tmp_path_factory.mktemp("jax_run")))
    t = Trainer(Config(jcfg.to_dict()), str(tmp_path_factory.mktemp("run")),
                device="cpu")
    load_jax_state(t, jt)
    return jt, t


def _jax_flat(jt) -> dict:
    return flatten_variables(
        {"params": jax.tree.map(np.asarray, jt.state.params),
         "batch_stats": jax.tree.map(np.asarray, jt.state.batch_stats)})


def load_jax_state(t, jt):
    """The JAX trainer's parameters, BatchNorm statistics, momentum and
    step into the port trainer's state."""
    model = t.state.model
    model.load_state_dict(flax_to_state_dict(
        {"params": jax.tree.map(np.asarray, jt.state.params),
         "batch_stats": jax.tree.map(np.asarray, jt.state.batch_stats)},
        model))
    traces = [s.trace for s in jax.tree_util.tree_leaves(
        jt.state.opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    if traces:
        flat = flatten_variables({"params": jax.tree.map(np.asarray,
                                                         traces[0])})
        to_flax = {tk: (fk, tr) for fk, tk, tr in key_map(model)}
        for name, p in model.named_parameters():
            fk, transposed = to_flax[name]
            a = flat[fk].T if transposed else flat[fk]
            t.state.optimizer.state[p]["momentum_buffer"] = \
                torch.from_numpy(np.array(a, order="C"))
    t.state.step = int(jt.state.step)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Both trainers' ``fit`` from the same initial weights, and the
    batches each iterator gives."""
    jt, t = _trainers(tmp_path_factory)
    batches = {}
    for name, (ours, ref) in {"train": (t.train_iter, jt.train_iter),
                              "val": (t.val_iter, jt.val_iter)}.items():
        for epoch in (1, 2):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            batches[name, epoch] = (list(ours), list(ref))
    jbest, best = jt.fit(), t.fit()
    return {"batches": batches, "jscalars": scalars(jt.workdir),
            "scalars": scalars(t.workdir), "best": (jbest, best),
            "jfinal": _jax_flat(jt), "jstep": int(jt.state.step),
            "final": state_dict_to_flax(t.state.model.state_dict(),
                                        t.state.model),
            "step": t.state.step, "workdir": t.workdir}


def test_trainer_batches_match_jax(parity):
    for (name, epoch), (ours, ref) in parity["batches"].items():
        assert len(ours) == len(ref) == {"train": 4, "val": 2}[name]
        for a, b in zip(ours, ref):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(
                    a[k], b[k], err_msg=f"{name} epoch {epoch} {k}")


def test_trainer_scalars_match_jax(parity):
    ours, ref = parity["scalars"], parity["jscalars"]
    assert [(r["tag"], r["step"]) for r in ours] == \
        [(r["tag"], r["step"]) for r in ref]
    assert {r["tag"] for r in ours} == {
        "train/loss", "train/acc", "train/lr", "train/batch_time",
        "val/loss", "val/acc"}
    for a, b in zip(ours, ref):
        if a["tag"] == "train/batch_time":
            continue
        if a["tag"].endswith("acc"):
            # a prediction flips only at a near-tie of two logits
            assert a["value"] == b["value"], (a, b)
        else:
            # two free-running f32 trajectories: each step matches to
            # ~2e-7 from the same state (test_trainer_steps_match_jax),
            # but the ~1e-7 differences a step leaves in the parameters
            # grow over 8 steps at lr 0.05 (2.5e-4 at step 5)
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-3,
                                       err_msg=str(a))
    assert parity["best"][0] == parity["best"][1]
    assert os.path.exists(os.path.join(parity["workdir"], "log.txt"))


def test_trainer_final_params_match_jax(parity):
    assert parity["step"] == parity["jstep"] == 8
    ref, ours = parity["jfinal"], parity["final"]
    assert sorted(ref) == sorted(ours)
    total = sum(np.sum(np.square(ref[k])) for k in ref)
    diff = sum(np.sum(np.square(ours[k] - ref[k])) for k in ref)
    # the trajectories' drift (see above): 1e-3 of the whole state in
    # L2, and 3e-2 of any one tensor (the BatchNorm biases, small and
    # moved by small gradients, drift most: 1.4e-2)
    assert np.sqrt(diff / total) < 1e-3
    for k in ref:
        assert (np.linalg.norm(ours[k] - ref[k])
                <= 3e-2 * np.linalg.norm(ref[k]) + 1e-7), k


def test_trainer_steps_match_jax(tmp_path_factory):
    """Step by step from the same state: before each of the 8 steps of two
    epochs, the JAX trainer's whole state (parameters, statistics,
    momentum, step) goes into the port's; the port's step then equals
    the JAX one's within f32 tolerance, loss and updated state."""
    jt, t = _trainers(tmp_path_factory)
    for epoch in (1, 2):
        jt.train_iter.set_epoch(epoch)
        for batch in jt.train_iter:
            load_jax_state(t, jt)
            t.state, m = t.train_step(t.state, device_batch(batch), t.seed)
            jt.state, jm = jt.train_step(
                jt.state, jdevice_batch(batch, jt.mesh), jt.rng)
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=1e-5)
            assert float(m["acc"]) == float(jm["acc"])
            ref = _jax_flat(jt)
            ours = state_dict_to_flax(t.state.model.state_dict(),
                                      t.state.model)
            for k in ref:
                # as test_torch_train.py's one-step update tolerance
                np.testing.assert_allclose(
                    ours[k], ref[k], rtol=1e-5,
                    atol=2e-5 * np.abs(ref[k]).max() + 1e-7, err_msg=k)
    assert t.state.step == int(jt.state.step) == 8


# ---- ports of tests/test_train.py ------------------------------------------

def test_overfit_minibatch():
    """A correct trunk must overfit one small batch quickly."""
    cfg = tiny_cfg()
    model, loss_fn = build_classification(cfg)
    # long horizon: the cosine schedule must not hit zero mid-test
    optimizer, _ = make_optimizer(cfg, steps_per_epoch=20)
    state = create_train_state(model, optimizer, device="cpu")
    step = make_train_step(loss_fn, cfg.task)
    batch = make_batch(cfg)
    first = None
    for _ in range(50):
        state, metrics = step(state, batch, 1)
        if first is None:
            first = float(metrics["loss"])
    last, acc = float(metrics["loss"]), float(metrics["acc"])
    assert last < first * 0.5, (first, last)
    assert acc >= 0.75, acc


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_checkpoint_roundtrip(tmp_path, optimizer):
    cfg = tiny_cfg(optimizer=optimizer)
    model, loss_fn = build_classification(cfg)
    tx, _ = make_optimizer(cfg, steps_per_epoch=1)
    state = create_train_state(model, tx, device="cpu")
    state, _ = make_train_step(loss_fn, cfg.task)(state, make_batch(cfg), 1)

    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    mgr.save(state.step, state, extra={"epoch": 3})
    mgr.wait()

    template = create_train_state(
        build_model(cfg, torch.Generator().manual_seed(7)), tx, device="cpu")
    restored, extra, step_no = mgr.restore(template)
    assert step_no == state.step == restored.step == 1
    assert extra == {"epoch": 3}
    assert_bit_equal(restored, state)
    mgr.close()


def test_checkpoint_keep_k_and_partial_saves(tmp_path):
    cfg = tiny_cfg()
    model, _ = build_classification(cfg)
    state = create_train_state(model, make_optimizer(cfg, 1)[0], "cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore(state) == (None, None, None)
    for step in (3, 7, 11):
        mgr.save(step, state, extra={"epoch": step})
    assert mgr.steps() == [7, 11]
    # a save killed before its rename leaves only the temporary file
    with open(os.path.join(str(tmp_path), "ckpt_20.pt.tmp"), "wb") as f:
        f.write(b"partial")
    assert mgr.latest_step() == 11
    assert mgr.restore(state)[1:] == ({"epoch": 11}, 11)
    with pytest.raises(TypeError, match="numeric"):
        mgr.save(12, state, extra={"note": "text"})
    assert mgr.steps() == [7, 11]


def test_lr_schedules_and_adamw():
    cfg = tiny_cfg()
    for sched in ("cosine", "step", "multistep"):
        cfg.lr_scheduler = sched
        cfg.lr_milestones = [5, 8]
        fn = make_lr_schedule(cfg, steps_per_epoch=10)
        assert fn(cfg.epochs * 10 - 1) <= fn(0)
    cfg.lr_scheduler = "cosine"
    cfg.warmup_epoch = 2
    fn = make_lr_schedule(cfg, steps_per_epoch=10)
    assert fn(0) < fn(19)  # warming up

    # AdamW sets every group's LR from the schedule at each update
    cfg.optimizer = "adamw"
    model, loss_fn = build_classification(cfg)
    tx, sched = make_optimizer(cfg, steps_per_epoch=10)
    assert isinstance(tx, AdamW)
    state = create_train_state(model, tx, device="cpu")
    assert isinstance(state.optimizer, torch.optim.AdamW)
    step = make_train_step(loss_fn, cfg.task)
    batch = make_batch(cfg)
    for i in range(3):
        state, _ = step(state, batch, 1)
        assert [g["lr"] for g in state.optimizer.param_groups] == \
            [sched(i)] * 2
    with pytest.raises(ValueError):
        make_optimizer(tiny_cfg(optimizer="lamb"), 10)


def _resume_cfg():
    return tiny_cfg(epochs=4, save_interval=1, val_interval=10**9,
                    log_interval=10**9, synthetic_train_size=64)


def test_kill_resume_fault_injection(tmp_path):
    """A run that dies mid-job resumes from the latest checkpoint on
    restart, and ends bit-equal to a run that was never interrupted:
    parameters, BatchNorm statistics and momentum (dropout on, drawn
    from the step)."""
    wd = str(tmp_path / "run")
    a = Trainer(_resume_cfg(), wd, device="cpu")
    assert a.start_epoch == 1  # fresh dir: nothing to resume
    for epoch in (1, 2):
        a.train_one_epoch(epoch)
        a.ckpt.save(a.state.step, a.state, extra={"epoch": epoch})
    a.ckpt.wait()
    step_at_kill = a.state.step
    del a  # the "kill": in-flight training state is discarded

    b = Trainer(_resume_cfg(), wd, device="cpu")
    assert b.start_epoch == 3  # resumed past the completed epochs
    assert b.state.step == step_at_kill == 16
    b.fit()  # completes epochs 3..4 only
    assert b.state.step == 32

    c = Trainer(_resume_cfg(), wd, device="cpu")  # post-completion restart
    assert c.start_epoch == 5

    whole = Trainer(_resume_cfg(), str(tmp_path / "whole"), device="cpu")
    whole.fit()
    assert_bit_equal(b.state, whole.state)
    assert_bit_equal(c.state, whole.state)


def test_best_checkpoint_saved(tmp_path):
    """fit() keeps the best-val model in ckpt_best even when a later
    (worse) epoch is the last one saved to the keep-k latest slot."""
    cfg = tiny_cfg(epochs=3, save_interval=1, val_interval=1,
                   log_interval=10**9, synthetic_train_size=16)
    t = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    canned = iter([{"acc": 0.5}, {"acc": 0.8}, {"acc": 0.6}])
    best_steps = []
    t.validate = lambda epoch: next(canned)
    orig_save = t.ckpt_best.save
    t.ckpt_best.save = lambda step, state, extra=None: (
        best_steps.append((step, extra)), orig_save(step, state, extra))[1]
    assert t.fit() == 0.8
    # saved at epochs 1 and 2 (improvements), not at epoch 3 (worse)
    assert len(best_steps) == 2
    assert best_steps[-1][1] == {"epoch": 2, "value": 0.8}
    # the surviving on-disk best checkpoint is the epoch-2 one
    assert t.ckpt_best.steps() == [best_steps[-1][0]]
    # and the latest slot moved past it
    assert t.ckpt.latest_step() > t.ckpt_best.latest_step()


def test_nan_loss_aborts_training(tmp_path):
    """A diverged step kills training loudly at the next fetch."""
    cfg = tiny_cfg(epochs=1, log_interval=1, synthetic_train_size=16)
    t = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    orig = t.train_step

    def poisoned(state, batch, seed):
        state, metrics = orig(state, batch, seed)
        return state, dict(metrics, loss=metrics["loss"] * float("nan"))

    t.train_step = poisoned
    with pytest.raises(FloatingPointError, match="non-finite"):
        t.fit()


def test_trainer_refuses_data_parallel(tmp_path):
    """One process is one data-parallel rank: data_parallel must be -1 or
    the world size (1 here), and nothing is sharded over a model axis."""
    with pytest.raises(ValueError, match="data_parallel=2 with 1 "
                       "process"):
        Trainer(tiny_cfg(data_parallel=2), str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="model_parallel=2"):
        Trainer(tiny_cfg(model_parallel=2), str(tmp_path), device="cpu")
    t = Trainer(tiny_cfg(data_parallel=1, epochs=1), str(tmp_path),
                device="cpu")
    assert (t.layout.world_size, t.layout.backend) == (1, None)


# ---- AdamW vs optax.adamw --------------------------------------------------

class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(5, 4))
        self.k = torch.nn.Parameter(torch.zeros(3, 2))
        self.b = torch.nn.Parameter(torch.zeros(5))


@pytest.mark.parametrize("grad_clip", [0.0, 3.0])
def test_adamw_matches_optax(grad_clip):
    """Four updates through warmup with the same gradients: moments, bias
    correction, decay on the matrices alone, clipping (the second
    gradient is scaled past the clip norm)."""
    overrides = {"optimizer": "adamw", "grad_clip": grad_clip,
                 "weight_decay": 0.05, "base_learning_rate": 0.1,
                 "warmup_epoch": 1, "epochs": 10}
    spe = 2
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(5, 4)), "k": rng.normal(size=(3, 2)),
              "b": rng.normal(size=5)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    grads = [{k: (rng.normal(size=v.shape) * scale).astype(np.float32)
              for k, v in params.items()} for scale in (0.3, 5.0, 0.5, 1.0)]

    tx, _ = jschedules.make_optimizer(jload_config(overrides=overrides), spe)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)

    model = _Toy()
    with torch.no_grad():
        for k, v in params.items():
            getattr(model, k).copy_(torch.from_numpy(v))
    ours, _ = make_optimizer(load_config(overrides=overrides), spe)
    opt = ours.init(model)
    decay, rest = opt.param_groups
    assert decay["weight_decay"] == 0.05 and rest["weight_decay"] == 0.0
    assert [p.ndim for p in decay["params"]] == [2, 2]
    for count, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, v in g.items():
            getattr(model, k).grad = torch.from_numpy(v.copy())
        ours.update(opt, count)
        for k in params:
            # f32: torch folds the bias corrections into the step size
            # and decays before the Adam step; optax divides each moment
            # and adds the decay to the update. Where a gradient turns
            # against its moment, m cancels and m / sqrt(v) keeps ~1e-5
            # of the update's size (lr 0.1) as rounding
            np.testing.assert_allclose(
                getattr(model, k).detach().numpy(), np.asarray(jparams[k]),
                rtol=1e-6, atol=5e-6, err_msg=f"step {count} {k}")


# ---- PrefetchIterator ------------------------------------------------------

class _Items:
    """A batch iterable of ``n`` dicts, made at once."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        for i in range(self.n):
            yield {"i": i}


def test_prefetch_iterator_matches_and_reraises():
    def check():
        ds = SyntheticClassification(num_samples=10, num_points=32,
                                     num_classes=4)
        base = BatchIterator(ds, 3, shuffle=True, feature_spec="xyz", seed=3)
        pre = PrefetchIterator(BatchIterator(ds, 3, shuffle=True,
                                             feature_spec="xyz", seed=3))
        assert len(pre) == len(base) == 3
        base.set_epoch(2)
        pre.set_epoch(2)
        got_a, got_b = list(base), list(pre)
        assert len(got_a) == len(got_b)
        for a, b in zip(got_a, got_b):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        # two epochs in sequence reuse the wrapper cleanly
        assert len(list(pre)) == len(got_b)

        class _Boom(_Items):
            def __iter__(self):
                yield {"i": 0}
                raise RuntimeError("producer boom")

        with pytest.raises(RuntimeError, match="producer boom"):
            list(PrefetchIterator(_Boom(1)))

    run_with_limit(check, 30)


def test_prefetch_iterator_abandoned_consumer_stops_producer():
    """Abandoning the generator (next() once, then close) releases the
    producer thread instead of leaving it blocked on a full queue."""
    def check():
        before = threading.active_count()
        it = iter(PrefetchIterator(_Items(50)))
        assert next(it)["i"] == 0
        it.close()  # GeneratorExit -> finally -> stop + join
        deadline = time.time() + 5
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.02)
        assert threading.active_count() <= before

    run_with_limit(check, 20)


def test_prefetch_iterator_lagging_consumer_reaches_the_end():
    """ROADMAP C7: the producer finishes while the queue is full (the
    consumer lags), and the end marker must still arrive; the JAX
    package's prefetcher drops it there and its consumer waits forever."""
    def consume():
        got = []
        for item in PrefetchIterator(_Items(6), depth=2):
            time.sleep(0.3)  # the producer is done long before
            got.append(item["i"])
        return got

    assert run_with_limit(consume, 20) == list(range(6))


def test_prefetch_iterator_matches_jax_batches():
    ds = jsynthetic.SyntheticClassification(9, 32, num_classes=4, seed=2)
    ref = list(jloader.BatchIterator(ds, 4, shuffle=False,
                                     feature_spec="xyz", drop_last=False))
    ours = run_with_limit(lambda: list(PrefetchIterator(BatchIterator(
        SyntheticClassification(9, 32, num_classes=4, seed=2), 4,
        shuffle=False, feature_spec="xyz", drop_last=False))), 30)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
