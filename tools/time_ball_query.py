"""The ball query's device time per call, and each train config's device
busy time per step by kernel, on the card; optionally against the same
readings of another checkout, taken in turns.

    python3 tools/time_ball_query.py [--parent DIR] [--reps 20]

Needs a CUDA card and ``nvcc``. Each reading runs in a process of its
own that imports ``closerlook3d_tpu_torch`` from one checkout (this one,
or ``DIR``) and builds that checkout's kernels from its own sources, so
every C entry is called by its own wrapper. The helpers come from this
checkout's ``chip_smoke.py``. A reading holds:

* the ball query (``ball_query_cuda``) at the 9 calls of the ModelNet40
  xyz train step, the S3DIS train step and a flagship request
  (``chip_smoke._bq_timing``: device time per call from torch.profiler,
  CUDA events over eager launches, the bound and the all-pairs figure),
  each call first held equal in idx and mask to ``ball_query_plain``;
* each train config of ``chip_smoke.py`` (the five ModelNet40 configs
  and the two segmentation ones, same batches and weights): 4 bf16 steps
  on one batch, then 3 under torch.profiler; the device busy ms a step
  (union of kernel intervals) and each device op's ms a step, the ball
  query's ops apart.

Without ``--parent`` one reading of this checkout is taken. With it the
readings go parent, this, this, parent, and the summary gives each
checkout's mean of two and what changed: per call, per step and, per
config, the busy time, the ball query's share and the other ops that
rose or fell most. The card's name and power limit are printed first;
everything goes to ``chiprun_out/time_ball_query.json``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (imports no part of the port at load)



def _setup(name: str):
    """(train step, state, batch) of a ``chip_smoke.py`` train config, as
    its training phases build them: warmup off, seeded weights, bf16."""
    import closerlook3d_tpu_torch.models as models
    from closerlook3d_tpu_torch.models.build import part_counts
    from closerlook3d_tpu_torch.train import (
        create_train_state, make_optimizer, make_train_step)

    if name in chip_smoke.TRAIN_KINDS:
        cfg = copy.deepcopy(chip_smoke.train_config(name))
        cfg.warmup_epoch = 0
        model, loss_fn = models.build_classification(cfg)
        tx, _ = make_optimizer(cfg, chip_smoke.STEPS_PER_EPOCH)
        step = make_train_step(loss_fn, cfg.task)
        batch = chip_smoke.train_batch(cfg, chip_smoke.SEED + 500)
    else:
        cfg = copy.deepcopy(chip_smoke.seg_train_config(name))
        cfg.warmup_epoch = 0
        model, loss_fn = models.build_model_and_loss(cfg)
        tx, _ = make_optimizer(cfg, chip_smoke.SEG_STEPS_PER_EPOCH)
        step = make_train_step(loss_fn, cfg.task, part_counts(cfg)
                               if cfg.task == "part_segmentation" else None)
        batch = chip_smoke.seg_train_batch(cfg, chip_smoke.SEED + 1300,
                                           padded=(1,))
    state = create_train_state(model, tx, device=chip_smoke.DEVICE)
    return step, state, batch


def profiled_ops(run, n: int) -> dict:
    """``run()`` ``n`` times under torch.profiler: device busy ms a run
    (``busy_ms``) and each device op's ms a run (``ops_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if chip_smoke._is_device_op(e):
            ops[e.name] = (ops.get(e.name, 0.0)
                           + (e.time_range.end - e.time_range.start) / n / 1e3)
    return {"busy_ms": chip_smoke._busy_us(prof) / n / 1e3, "ops_ms": ops}


def step_profile(name: str, bq_ops: set, warm: int = 4, n: int = 3) -> dict:
    """Device busy ms a train step of config ``name`` and each device op's
    ms a step, over ``n`` profiled steps after ``warm``."""
    import torch

    torch.manual_seed(chip_smoke.SEED)
    step, state, batch = _setup(name)
    for _ in range(warm):
        state, _ = step(state, batch, chip_smoke.SEED)
    torch.cuda.synchronize()

    def run():
        nonlocal state
        state, _ = step(state, batch, chip_smoke.SEED)

    out = profiled_ops(run, n)
    bq = sum(v for k, v in out["ops_ms"].items()
             if chip_smoke._op_name(k) in bq_ops)
    out["ball_query_ms"] = bq
    chip_smoke.log("step-profile", f"{name}: device busy "
                   f"{out['busy_ms']:.3f} ms a step, ball query {bq:.5f} ms")
    return out


def reading(tree: str, reps: int) -> dict:
    """One reading of checkout ``tree`` (see the module's docstring)."""
    sys.path.insert(0, tree)
    import torch

    import closerlook3d_tpu_torch
    from closerlook3d_tpu_torch.ops import kernels
    from closerlook3d_tpu_torch.ops.neighbors import (ball_query_cuda,
                                                      ball_query_plain)

    pkg = os.path.dirname(os.path.abspath(closerlook3d_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(tree):
        raise AssertionError(f"imported the port from {pkg}, not {tree}")
    kernels.build_all(n[:-3] for n in os.listdir(kernels.CSRC)
                      if n.endswith(".cu"))
    for step in chip_smoke.BQ_STEPS:
        for name, a in chip_smoke.bq_step_calls(step, chip_smoke.SEED + 600):
            chip_smoke._idx_err(f"ball_query {step} {name}",
                                ball_query_cuda(*a),
                                ball_query_plain(*a, chunk_size=512))
    out = {"tree": tree, "bq_timing": chip_smoke._bq_timing(reps)}
    bq_ops = _bq_op_names([out])
    out["steps"] = {}
    for name in chip_smoke.TRAIN_KINDS + chip_smoke.SEG_TRAIN_NAMES:
        out["steps"][name] = step_profile(name, bq_ops)
        torch.cuda.empty_cache()
    return out


def _mean(xs):
    return sum(xs) / len(xs)


def compare(parent: list, this: list) -> dict:
    """Each checkout's mean of its readings, and what changed."""
    out = {"bq": {}, "steps": {}}
    for step in chip_smoke.BQ_STEPS:
        calls = []
        for i, row in enumerate(this[0]["bq_timing"][step]["calls"]):
            p = _mean([r["bq_timing"][step]["calls"][i]["device_ms"]
                       for r in parent])
            t = _mean([r["bq_timing"][step]["calls"][i]["device_ms"]
                       for r in this])
            calls.append({"call": row["call"], "parent_device_ms": p,
                          "device_ms": t, "bound_ms": row["bound_ms"],
                          "all_pairs_ms": row["all_pairs_ms"]})
            chip_smoke.log("compare", f"ball query {step} {row['call']}: "
                           f"device {t:.5f} ms, parent {p:.5f} ms")
        tot = {k: sum(c[k] for c in calls) for k in
               ("parent_device_ms", "device_ms", "bound_ms", "all_pairs_ms")}
        out["bq"][step] = {"calls": calls, **tot}
        chip_smoke.log("compare", f"ball query {step} per step: device "
                       f"{tot['device_ms']:.5f} ms, parent "
                       f"{tot['parent_device_ms']:.5f} ms")
    bq_ops = _bq_op_names(parent + this)
    for name in this[0]["steps"]:
        row = {}
        for key in ("busy_ms", "ball_query_ms"):
            row["parent_" + key] = _mean([r["steps"][name][key]
                                          for r in parent])
            row[key] = _mean([r["steps"][name][key] for r in this])
        # every other op, by name: this checkout's mean less the parent's
        names = set()
        for r in parent + this:
            names |= set(r["steps"][name]["ops_ms"])
        delta = {}
        for op in names:
            if chip_smoke._op_name(op) in bq_ops:
                continue
            delta[op] = (
                _mean([r["steps"][name]["ops_ms"].get(op, 0.0) for r in this])
                - _mean([r["steps"][name]["ops_ms"].get(op, 0.0)
                         for r in parent]))
        order = sorted(delta, key=delta.get)
        row["other_ops_delta_ms"] = sum(delta.values())
        row["fell_most"] = [(op[:90], delta[op]) for op in order[:3]]
        row["rose_most"] = [(op[:90], delta[op]) for op in order[::-1][:3]]
        out["steps"][name] = row
        chip_smoke.log(
            "compare", f"{name}: busy {row['busy_ms']:.3f} ms a step, parent "
            f"{row['parent_busy_ms']:.3f}; ball query "
            f"{row['ball_query_ms']:.5f}, parent "
            f"{row['parent_ball_query_ms']:.5f}; other ops "
            f"{row['other_ops_delta_ms']:+.4f} ms; rose most "
            + "; ".join(f"{op} {d:+.4f}" for op, d in row["rose_most"]))
    return out


def _bq_op_names(readings) -> set:
    return {chip_smoke._op_name(op) for r in readings
            for t in r["bq_timing"].values() for c in t["calls"]
            for op in c["device_ms_by_op"]}


def readings_in_turns(script: str, parent, reps: int, out_dir: str,
                      argv=()):
    """The readings of a ``--parent`` timing tool (``script``, run as
    ``script --reading tree:path`` plus ``argv`` in a process each): this
    checkout once, or with ``parent`` the order parent, this, this, parent.
    Returns {"parent": [...], "this": [...]} of the readings' records."""
    os.makedirs(out_dir, exist_ok=True)
    order = [("this", REPO)]
    if parent:
        parent = os.path.abspath(parent)
        order = [("parent", parent), ("this", REPO), ("this", REPO),
                 ("parent", parent)]
    readings = {"parent": [], "this": []}
    for i, (label, tree) in enumerate(order):
        path = os.path.join(out_dir, f"{i}-{label}.json")
        chip_smoke.log("reading", f"{i}: {label} ({tree})")
        subprocess.run([sys.executable, os.path.abspath(script),
                        "--reps", str(reps), *argv, "--reading",
                        f"{tree}{os.pathsep}{path}"], check=True)
        with open(path) as f:
            readings[label].append(json.load(f))
    return readings


def tool_main(script: str, doc: str, reading_fn, compare_fn,
              name: str, options=()) -> int:
    """The command line of a ``--parent`` timing tool: one reading in
    this process (``--reading``), or the readings in turns, compared,
    into ``chiprun_out/<name>.json``. ``options`` are the tool's own
    (flag, argparse keywords) pairs; their values go to every reading
    (``reading_fn(tree, reps, **values)``)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout, read in turns with this one")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--reading", default=None, help=argparse.SUPPRESS)
    for flag, kw in options:
        ap.add_argument(flag, **kw)
    args = ap.parse_args()
    values = {dest: getattr(args, dest) for dest in (
        flag.lstrip("-").replace("-", "_") for flag, _ in options)}
    if args.reading:  # one reading, in this process
        tree, path = args.reading.split(os.pathsep)
        with open(path, "w") as f:
            json.dump(reading_fn(tree, args.reps, **values), f, default=str)
        return 0

    print(chip_smoke.gpu_line(), flush=True)
    record = {"device": chip_smoke.phase_device(), "options": values}
    argv = [a for (flag, _), v in zip(options, values.values())
            for a in (flag, str(v))]
    record["readings"] = readings_in_turns(
        script, args.parent, args.reps,
        os.path.join(REPO, "chiprun_out", name), argv)
    if args.parent:
        record["compare"] = compare_fn(record["readings"]["parent"],
                                       record["readings"]["this"])
    with open(os.path.join(REPO, "chiprun_out", f"{name}.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    return 0


def main() -> int:
    return tool_main(__file__, __doc__, reading, compare, "time_ball_query")


if __name__ == "__main__":
    sys.exit(main())
