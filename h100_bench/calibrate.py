"""Readings that the limits of ``limits/<workload>.json`` are set from.

    python3 h100_bench/calibrate.py --workload <cell> --seeds <n> \\
        --control-seeds <m> [--fault-seeds <k>] [--seconds <s>] [--out <file>]

One process, so that the kernels build once. For each of ``--seeds``
seeds the program's numbers against the reference (the lower reading is
their largest); for each of the first ``--control-seeds`` the control's:
the reference computed in float8 (``reference/precision.py``) put in the
program's place (the upper reading is their smallest). For train cells
``--fault-seeds`` seeds also read the program with half of each batch
left out of its steps (the loss the mean over the rest). Writes one JSON
line a reading to ``--out`` and prints the summary. Not run by the
benchmark's runs; needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from h100_bench import check, core, spec  # noqa: E402
from h100_bench.reference import precision  # noqa: E402


def half_batch(step_fn):
    """A train step that steps on the first half of each batch."""
    def step(state, batch, seed):
        half = next(iter(batch.values())).shape[0] // 2
        return step_fn(state, {k: v[:half] for k, v in batch.items()}, seed)
    return step


def control_numbers(loop, ref, rd) -> dict:
    """The reference computed with ``rd`` in the program's place."""
    ctl = loop.reference(rd)
    if loop.kind == "serve":
        return check.serve_numbers(ctl, ref)
    wd = loop.rcfg["weight_decay"]
    bufs = {n: g + wd * loop.init[n] if g.ndim >= 2 else g
            for n, g in ctl["first_grads"].items()}
    return check.train_numbers(loop.init, bufs, ctl["params"],
                               ctl["losses"], ref, wd)


def _worst(look: dict, n: int = 5) -> dict:
    """The leaves with the largest gaps, for the record."""
    return {"losses": look["losses"], "ref_losses": look["ref_losses"],
            **{k: sorted(([name, *map(float, v)] for name, v in
                          look[k].items()), key=lambda r: -r[1])[:n]
               for k in ("grad", "change")}}


def reading(cell, seed: int, seconds: float, control: bool,
            fault: bool = False, device="cuda") -> dict:
    loop = core.LOOPS[cell.traffic["mode"]](cell, seed, device)
    if fault:
        from closerlook3d_tpu_torch.train import step as step_mod
        make = step_mod.make_train_step
        step_mod.make_train_step = lambda *a, **k: half_batch(make(*a, **k))
        try:
            loop.setup()
        finally:
            step_mod.make_train_step = make
    else:
        loop.setup()
    if loop.kind == "serve":
        loop.window(seconds)
    loop.free()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ref = loop.reference()
    look = {} if loop.kind == "train" else None
    numbers = loop.compare(ref, look) if look is not None else loop.compare(
        ref)
    out = {"seed": seed, "kind": "fault_half_batch" if fault else "program",
           "numbers": numbers, "reference_s": time.perf_counter() - t0}
    if look:
        out["look"] = _worst(look)
    if control:
        out["control"] = control_numbers(loop, ref, precision.fp8())
    del loop, ref
    core.free_memory()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--precision", default=None,
                    help="a witness: run the program in this precision "
                         "(f32) in place of the configuration's")
    args = ap.parse_args()
    cell = spec.Cell(spec.benchmark(), args.workload)
    if args.precision:
        cell.config["config"]["precision"] = args.precision
    rows = []
    for i in range(args.seeds):
        rows.append(reading(cell, args.first_seed + 7919 * i, args.seconds,
                            i < args.control_seeds))
        print(json.dumps(rows[-1]), flush=True)
    for i in range(args.fault_seeds):
        rows.append(reading(cell, args.first_seed + 104729 * (i + 1),
                            args.seconds, False, fault=True))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    prog = [r["numbers"] for r in rows if r["kind"] == "program"]
    ctl = [r["control"] for r in rows if "control" in r]
    flt = [r["numbers"] for r in rows if r["kind"] == "fault_half_batch"]
    for name in prog[0]:
        line = {"number": name,
                "lower_program_max": max(p[name] for p in prog),
                "control_min": min(c[name] for c in ctl) if ctl else None,
                "fault_half_batch_min": (min(f[name] for f in flt)
                                         if flt else None)}
        print("summary " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
