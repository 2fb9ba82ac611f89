"""What the ranks of the port's data-parallel tests run.

Each function here runs in one rank of ``parallel/spawn.py::run_ranks``
(or, with ``rank=0`` and no process group, in the test's own process as
the single-process reference). This module imports the port and numpy
only, so that a rank starts without the JAX package.
"""

from __future__ import annotations

import copy
import os
import time
import traceback

import numpy as np
import torch

from closerlook3d_tpu_torch.models.build import (
    build_model_and_loss, part_counts)
from closerlook3d_tpu_torch.parallel import collectives
from closerlook3d_tpu_torch.parallel.collectives import (
    all_processes_concat, all_processes_min, all_processes_sum,
    all_reduce_sum, world)
from closerlook3d_tpu_torch.train import (
    create_train_state, make_optimizer, make_train_step)
from closerlook3d_tpu_torch.utils.config import Config


def rows(global_batch: dict, rank: int, ranks: int) -> dict:
    """Rank ``rank``'s rows of a global batch split in ``ranks`` equal
    shares."""
    n = next(iter(global_batch.values())).shape[0] // ranks
    return {k: v[rank * n:(rank + 1) * n] for k, v in global_batch.items()}


def _np(tensors: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def _train_state(cfg, weights: dict):
    model, loss_fn = build_model_and_loss(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    tx, _ = make_optimizer(cfg, 2)
    num_parts = (part_counts(cfg) if cfg.task == "part_segmentation"
                 else None)
    return (create_train_state(model, tx, device="cpu"),
            make_train_step(loss_fn, cfg.task, num_parts))


def train_steps(cfg: dict, weights: dict, batch: dict, steps: int,
                seed: int = 0) -> dict:
    """``steps`` train steps of ``cfg`` from ``weights`` on this rank's
    rows of the global ``batch`` (all of it in one process): per-step
    loss and accuracy, the first and the last step's gradients, the
    state before the last step (``before_last``: the model's and the
    optimizer's state_dicts), the final state_dict and the device
    collectives a step."""
    cfg = Config(cfg)
    ranks, rank = world()
    state, step = _train_state(cfg, weights)
    model = state.model
    local = rows(batch, rank, ranks)
    log = []
    collectives.reset_counts()
    for i in range(steps):
        if i == steps - 1:
            before_last = (_np(model.state_dict()),
                           copy.deepcopy(state.optimizer.state_dict()))
        state, m = step(state, local, seed)
        log.append((float(m["loss"]), float(m["acc"])))
        if i == 0:
            grads = _np({n: p.grad for n, p in model.named_parameters()})
    return {"log": np.array(log), "grads": grads,
            "last_grads": _np({n: p.grad
                               for n, p in model.named_parameters()}),
            "before_last": before_last, "state": _np(model.state_dict()),
            "collectives_per_step": collectives.COUNTS["calls"] / steps,
            "step": state.step}


def last_step_grads(cfg: dict, before_last: tuple, batch: dict, steps: int,
                    seed: int = 0) -> dict:
    """The gradients of ``train_steps``' last step in one process, from
    the state another run held before it."""
    cfg = Config(cfg)
    model_sd, opt_sd = before_last
    state, step = _train_state(cfg, model_sd)
    state.optimizer.load_state_dict(opt_sd)
    state.step = steps - 1
    step(state, batch, seed)
    return _np({n: p.grad for n, p in state.model.named_parameters()})


def collective_cases() -> dict:
    """The host collectives at this rank's inputs (``multihost_worker``'s
    cases) and ``all_reduce_sum``'s forward and backward."""
    ranks, rank = world()
    out = {
        "sum": all_processes_sum({"a": np.arange(4.0) * (rank + 1),
                                  "b": (rank + 1, [np.eye(2) * rank])}),
        "sum_int": all_processes_sum(rank + 1),
        "min": all_processes_min(float(5 - rank)),
        # ragged: rank r contributes r + 1 rows
        "concat": all_processes_concat(
            np.full((rank + 1, 2), rank, np.int64)),
        "concat_empty": all_processes_concat(
            np.zeros((0 if rank == 0 else 2, 3), np.float32)),
    }
    x = torch.arange(3.0, requires_grad=True) * 1.0
    x.retain_grad()
    y = all_reduce_sum(x * (rank + 1))
    # rank r's loss weighs the sum by (r + 2); d/dx_r = (r + 1) * sum(w)
    (y * (rank + 2)).sum().backward()
    out["reduced"] = y.detach().numpy()
    out["grad"] = x.grad.numpy()
    out["world"] = ranks
    return out


def batchnorm_cases(x: np.ndarray, mask: np.ndarray, dy: np.ndarray,
                    weights: dict) -> dict:
    """Train-mode ``BatchNorm`` and ``MaskedBatchNorm`` on this rank's
    rows of x [B, N, C] (mask [B, N], cotangent dy): outputs, input and
    parameter gradients, running statistics."""
    from closerlook3d_tpu_torch.models.nn_utils import (
        BatchNorm, MaskedBatchNorm)

    ranks, rank = world()
    part = rows({"x": x, "mask": mask, "dy": dy}, rank, ranks)
    out = {}
    for name, cls in (("bn", BatchNorm), ("masked", MaskedBatchNorm)):
        mod = cls(x.shape[-1])
        mod.load_state_dict({k: torch.as_tensor(v)
                             for k, v in weights.items()})
        mod.train()
        xt = torch.tensor(part["x"], requires_grad=True)
        args = (xt,) if name == "bn" else (xt, torch.as_tensor(part["mask"]))
        y = mod(*args)
        (y * torch.as_tensor(part["dy"])).sum().backward()
        out[name] = {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
                     "dweight": mod.weight.grad.numpy(),
                     "dbias": mod.bias.grad.numpy(),
                     "running_mean": mod.running_mean.numpy(),
                     "running_var": mod.running_var.numpy()}
    return out


def oracle_logits(num_out: int, per_cloud: bool):
    """A deterministic eval_logits_fn: logits that are a fixed linear
    function of the features (averaged over each cloud's points where
    ``per_cloud``), so that a batch's logits depend on its samples
    alone."""
    w = np.random.default_rng(11).normal(size=(64, num_out)).astype(
        np.float32)

    def fn(state, batch):
        del state
        feats = np.asarray(batch["features"], np.float32)
        lg = feats @ w[:feats.shape[-1]]
        return lg.mean(axis=1) if per_cloud else lg
    return fn


def eval_datasets(n: int, points: int):
    """The classification (8 classes) and part-segmentation test sets of
    the evaluator cases: the port's synthetic sets, ``n`` samples each."""
    from closerlook3d_tpu_torch.data.synthetic import (
        SyntheticClassification, SyntheticPartSegmentation)

    return (SyntheticClassification(n, points, num_classes=8, seed=3),
            SyntheticPartSegmentation(n, points, seed=4))


def evaluator_cases(cfg: dict, n: int, points: int, rooms_cfg: dict) -> dict:
    """The classification and part-segmentation evaluators on this
    rank's shard of ``eval_datasets(n, points)``, and S3DIS voting on the
    generated rooms of ``rooms_cfg``, with oracle logits; the inputs and
    outputs of the voting's final sum are recorded."""
    from closerlook3d_tpu_torch.data import s3dis
    from closerlook3d_tpu_torch.data.loader import BatchIterator
    from closerlook3d_tpu_torch.train import evaluate as ev

    ranks, rank = world()
    c = Config(cfg)
    cls_set, part_set = eval_datasets(n, points)
    out = {}
    for name, ds in (("cls", cls_set), ("part", part_set)):
        it = BatchIterator(ds, c.batch_size, shuffle=False,
                           feature_spec=c.input_features, drop_last=False,
                           process_index=rank, process_count=ranks)
        if name == "cls":
            out[name] = ev.evaluate_classification(
                c, None, oracle_logits(8, True), it)
        else:
            out[name] = ev.evaluate_partseg(
                c, ds, None, oracle_logits(int(sum(c.num_parts)), False), it)
    rc = Config(rooms_cfg)
    sums = []
    plain_sum = ev.all_processes_sum

    def recording(tree):
        got = plain_sum(tree)
        sums.append((tree, got))
        return got

    ev.all_processes_sum = recording
    try:
        ds = s3dis.S3DIS(rc, "test")
        res = ev.evaluate_s3dis_voting(rc, ds, None, oracle_logits(13, False))
    finally:
        ev.all_processes_sum = plain_sum
    (local, reduced), = sums
    out["voting"] = {"result": res, "local": local, "reduced": reduced,
                     "potentials_min": [float(p.min())
                                        for p in ds.potentials],
                     "full_points": [len(ds.full_cloud(r)[0])
                                     for r in range(len(ds.xyz))]}
    return out


def trainer_run(cfg: dict, workdir: str) -> dict:
    """``Trainer.fit`` for ``cfg.epochs`` epochs in the shared
    ``workdir``, then a resumed ``Trainer`` one epoch further."""
    from closerlook3d_tpu_torch.train.loop import Trainer

    c = Config(cfg)
    t = Trainer(c, workdir, device="cpu")
    best = t.fit()
    first = {"best": best, "step": t.state.step,
             "ckpt": t.ckpt.steps(), "best_steps": t.ckpt_best.steps(),
             "train_batches": len(t.train_iter),
             "val_batches": len(t.val_iter)}
    c2 = Config(cfg)
    c2.epochs = c.epochs + 1
    r = Trainer(c2, workdir, device="cpu")
    resumed = {"start_epoch": r.start_epoch, "step": r.state.step,
               "state": _np(r.state.model.state_dict())}
    best2 = r.fit()
    resumed.update(best=best2, final_step=r.state.step,
                   final=_np(r.state.model.state_dict()))
    return {"first": first, "resumed": resumed}


def nan_abort(cfg: dict, workdir: str) -> dict:
    """``Trainer.fit`` where rank 1's model holds a NaN: the exception
    each rank raises (both must stop at the same step, or one would wait
    in the next step's collectives)."""
    from closerlook3d_tpu_torch.train.loop import Trainer

    t = Trainer(Config(cfg), workdir, device="cpu")
    if world()[1] == 1:
        with torch.no_grad():
            next(t.state.model.parameters()).view(-1)[0] = float("nan")
    try:
        t.fit()
    except FloatingPointError as e:
        return {"raised": str(e), "step": t.state.step}
    return {"raised": None, "step": t.state.step}


def cli_mains_in_group(argv: list, workdir: str) -> dict:
    """``cli.train``'s main, then ``cli.evaluate``'s, in the process group
    this rank joined before (as one torchrun launch can run both): each
    leaves the group it did not join as it found it."""
    import torch.distributed as dist

    from closerlook3d_tpu_torch.cli import evaluate, train

    run = os.path.join(workdir, "run")
    best = train.main(["--device", "cpu", "--log_dir", run, *argv])
    in_group = [dist.is_initialized()]
    results = evaluate.main(
        ["--device", "cpu", "--log_dir", os.path.join(workdir, "eval"),
         "--load_path", os.path.join(run, "ckpt"), *argv])
    in_group.append(dist.is_initialized())
    return {"best": best, "results": results, "in_group": in_group,
            "world": world()}


def fail_rank_one(rank: int) -> None:
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank one fails here")
    all_processes_sum(1)


def hang_rank_one(rank: int) -> None:
    """Rank 1 never reaches the collective rank 0 waits in."""
    if rank == 1:
        time.sleep(600)
    all_processes_sum(1)


def suite(rank: int, jobs: list) -> dict:
    """Run ``jobs`` [(name, function name, args), ...] in order; each
    result, or the traceback of its failure, by name."""
    torch.manual_seed(0)
    results = {}
    for name, fn, args in jobs:
        try:
            results[name] = globals()[fn](*args)
        except Exception:  # noqa: BLE001 - reported by the test
            results[name] = {"error": traceback.format_exc()}
    results["pid"] = os.getpid()
    return results
