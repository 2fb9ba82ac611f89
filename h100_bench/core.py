"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, and the result line.

A traffic mix's ``mode`` names its loop: ``train_closed`` (train steps,
each started when the host is free, the window closed by one
synchronize) or ``serve_closed`` (one client; a request's latency runs
from the call to its logits synchronized on the card, the input copy
included).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from . import check, flops, imports, spec, tracing, traffic, weights
from .reference import model as ref_model

OUT_DIR = os.path.join(spec.HERE, "_out")
CACHE_DIR = os.path.join(spec.HERE, "_cache")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        after_comm = f.read().rsplit(")", 1)[1].split()
    start = int(after_comm[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def program_config(cell: spec.Cell):
    from closerlook3d_tpu_torch.utils.config import load_config

    return load_config(overrides=spec.flatten(cell.config["config"]))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_memory() -> None:
    """Collect garbage and hand cached device memory back, so that what
    runs next (the reference) starts from the program's freed state."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded in the run's process."""


class TrainLoop:
    """Closed loop of ``train_step(state, batch, seed)`` over a pool of
    batches on the device. Set-up's first ``checked_steps`` steps, on
    the pool's first batches, are the ones the reference follows."""

    kind = "train"

    def __init__(self, cell: spec.Cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.mix, self.rcfg = cell.traffic, cell.ref_config()
        self.points = self.mix["clouds"] * self.mix["points"]
        self.used: List[int] = []
        self.marks: List[tuple] = []  # (set-up stage, its end)

    def setup(self) -> None:
        from closerlook3d_tpu_torch.models import build
        from closerlook3d_tpu_torch.train import schedules, state, step

        cfg = program_config(self.cell)
        with torch.device("meta"):
            model, loss_fn = build.build_model_and_loss(cfg)
        self.init = weights.make([(n, tuple(t.shape)) for n, t in
                                  model.state_dict().items()], self.seed,
                                 self.device)
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.init)
        tx, _ = schedules.make_optimizer(cfg,
                                         self.cell.config["steps_per_epoch"])
        self.state = state.create_train_state(model, tx, device=self.device)
        self.step = step.make_train_step(loss_fn, cfg.task,
                                         num_parts=list(cfg.num_parts))
        self.marks.append(("model, weights, state", time.perf_counter()))
        self.pool = traffic.pool(self.mix, self.rcfg, self.seed, self.device)
        _sync(self.device)
        self.marks.append(("traffic pool", time.perf_counter()))
        named = dict(self.state.model.named_parameters())
        losses = []
        for i in range(self.mix["checked_steps"]):
            _, metrics = self.step(self.state, self.pool[i], self.seed)
            losses.append(metrics["loss"].detach().clone())
            _sync(self.device)
            self.marks.append((f"checked step {i + 1}", time.perf_counter()))
            if i == 0:
                opt_state = self.state.optimizer.state
                self.bufs1 = {
                    n: opt_state[p]["momentum_buffer"].detach().clone()
                    for n, p in named.items()
                    if "momentum_buffer" in opt_state.get(p, {})}
        self.params_after = {n: p.detach().clone() for n, p in named.items()}
        self.losses = [float(x) for x in losses]
        self.count = self.mix["checked_steps"]
        _sync(self.device)

    def model(self) -> torch.nn.Module:
        return self.state.model

    def unit(self, _i: int = 0) -> None:
        k = self.count % len(self.pool)
        self.used.append(k)
        self.step(self.state, self.pool[k], self.seed)
        self.count += 1

    def window(self, seconds: float) -> dict:
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.unit()
            n += 1
        _sync(self.device)
        dt = time.perf_counter() - t0
        return {"units": n, "seconds": dt,
                "metrics": {"train_points_per_s": n * self.points / dt}}

    def free(self) -> None:
        """Drop the program's state, keeping what the comparison reads."""
        self.pool = self.pool[:self.mix["checked_steps"]]
        del self.state, self.step
        free_memory()

    def reference(self, rd=None) -> dict:
        return ref_model.train_steps(self.init, self.rcfg, self.pool,
                                     self.seed, rd)

    def compare(self, ref: dict, look: dict = None) -> Dict[str, float]:
        return check.train_numbers(self.init, self.bufs1, self.params_after,
                                   self.losses, ref,
                                   self.rcfg["weight_decay"], look)


class ServeLoop:
    """One client in a closed loop of ``Predictor(...)`` requests over a
    pool of host (numpy) requests. The outputs of requests drawn from the
    seed among the first ``check_from`` are kept for the comparison."""

    kind = "serve"

    def __init__(self, cell: spec.Cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.mix, self.rcfg = cell.traffic, cell.ref_config()
        self.points = self.mix["clouds"] * self.mix["points"]
        rng = np.random.default_rng(seed)
        self.picks = sorted(int(i) for i in rng.choice(
            self.mix["check_from"], self.mix["check_requests"],
            replace=False))
        self.kept: Dict[int, torch.Tensor] = {}
        self.used: List[int] = []
        self.marks: List[tuple] = []  # (set-up stage, its end)
        self.count = 0

    def setup(self) -> None:
        from closerlook3d_tpu_torch.models import build
        from closerlook3d_tpu_torch.serving import predictor

        cfg = program_config(self.cell)
        with torch.device("meta"):
            model = build.build_model(cfg)
        self.init = weights.make([(n, tuple(t.shape)) for n, t in
                                  model.state_dict().items()], self.seed,
                                 self.device)
        _sync(self.device)
        self.marks.append(("weights", time.perf_counter()))
        self.predictor = predictor.Predictor(cfg, self.init, self.device)
        self.marks.append(("Predictor", time.perf_counter()))
        self.pool = traffic.pool(self.mix, self.rcfg, self.seed, self.device)
        self.marks.append(("traffic pool", time.perf_counter()))
        for i in range(self.mix["warm_requests"]):
            self._request(i % len(self.pool))
            self.marks.append((f"warm request {i + 1}", time.perf_counter()))

    def model(self) -> torch.nn.Module:
        return self.predictor.model

    def _request(self, k: int) -> torch.Tensor:
        b = self.pool[k]
        out = self.predictor(b["xyz"], b["mask"], b["features"])
        _sync(self.device)
        return out

    def unit(self, _i: int = 0) -> float:
        """One request; its host-clock seconds."""
        k = self.count % len(self.pool)
        self.used.append(k)
        t0 = time.perf_counter()
        out = self._request(k)
        dt = time.perf_counter() - t0
        if self.count in self.picks and self.count not in self.kept:
            self.kept[self.count] = out.clone()
            _sync(self.device)
        self.count += 1
        return dt

    def window(self, seconds: float) -> dict:
        lat, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            lat.append(self.unit())
        dt = time.perf_counter() - t0
        return {"units": len(lat), "seconds": dt, "metrics": {
            "serve_points_per_s": len(lat) * self.points / dt,
            "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3}}

    def free(self) -> None:
        del self.predictor
        free_memory()

    def reference(self, rd=None) -> List[torch.Tensor]:
        """The reference's logits of the sampled requests."""
        out = []
        for i in self.picks:
            b = self.pool[i % len(self.pool)]
            t = {k: torch.as_tensor(b[k], device=self.device)
                 for k in ("xyz", "mask", "features")}
            out.append(ref_model.serve_logits(self.init, self.rcfg, t["xyz"],
                                              t["mask"], t["features"], rd))
        return out

    def compare(self, ref: List[torch.Tensor]) -> Dict[str, float]:
        """A sampled request the window never finished reads NaN."""
        prog = [self.kept.get(i, torch.full_like(r, float("nan")))
                for i, r in zip(self.picks, ref)]
        return check.serve_numbers(prog, ref)


LOOPS = {"train_closed": TrainLoop, "serve_closed": ServeLoop}


def _trace(loop, cell: spec.Cell, units: int, window_rate: float):
    """Two traced stretches of ``units`` units each: device activity alone
    (busy and window, device ops, the top device ops), then with the host
    ops and the benchmark's module spans (device time per layer, idle gaps
    by host op). Returns what a per-layer metric's reader reads: ``kind``
    ("train" or "serve"), ``units`` traced, the window's ``rate``
    (units/s), ``flops_per_unit`` and ``peak_flops``, device seconds per
    layer file (``layer_s``) and least seconds (``least_s``) over the
    traced units, ``device_ops``, ``busy_s`` and ``window_s``; the
    breakdown; lines for standard error."""
    layers = spec.layers()
    classes = {c for ly in layers for c in ly.get("modules", [])}
    os.makedirs(OUT_DIR, exist_ok=True)
    sync = lambda: _sync(loop.device)  # noqa: E731
    base = os.path.join(OUT_DIR, cell.name)
    dev_path, host_path = base + ".device.trace.json", base + ".trace.json"
    window_s = tracing.profile_units(loop.unit, units, dev_path, sync,
                                     host=False)
    device = tracing.read_trace(dev_path, [])
    spans = tracing.ModuleSpans(loop.model(), classes)
    start = len(loop.used)
    tracing.profile_units(loop.unit, units, host_path, sync)
    spans.remove()
    used = loop.used[start + 1:]  # after the discarded warm-up unit
    summary = tracing.read_trace(host_path, layers)
    rcfg, train = loop.rcfg, loop.kind == "train"
    censuses = {k: flops.census(rcfg, loop.pool[k]) for k in set(used)}
    fl = sum(flops.model_flops(rcfg, censuses[k], train) for k in used)
    least = {"aggregation": sum(flops.aggregation_least_s(
                 rcfg, censuses[k], train) for k in used),
             "geometry": sum(flops.geometry_least_s(rcfg, censuses[k])
                             for k in used)}
    ctx = SimpleNamespace(kind=loop.kind, units=len(used), rate=window_rate,
                          flops_per_unit=fl / len(used),
                          peak_flops=flops.PEAK_FLOPS[rcfg["precision"]],
                          layer_s=summary["per_layer_s"], least_s=least,
                          device_ops=device["device_ops"],
                          busy_s=device["busy_s"], window_s=window_s)
    breakdown = {"device_ops": device["breakdown"]["device_ops"],
                 "idle_gaps": summary["breakdown"]["idle_gaps"]}
    lines = [f"device trace: {dev_path}; {units} units, busy "
             f"{device['busy_s']} s of {window_s} s, "
             f"{device['device_ops']} device ops",
             f"host and device trace: {host_path}; {len(used)} units, "
             f"{summary['device_ops']} device ops"]
    total = max(sum(summary["per_layer_s"].values())
                + summary["unclaimed_s"], 1e-30)
    for name, s in summary["per_layer_s"].items():
        lines.append(f"layer {name}: {s} s device, {100 * s / total} %")
    lines.append(f"unclaimed by any layer: {summary['unclaimed_s']} s "
                 f"device, {100 * summary['unclaimed_s'] / total} %")
    first = censuses[used[0]]
    shares = {key: round(v / (first["points"][int(key.lstrip('s'))] * k), 5)
              for key, (v, k) in first["slots"].items()}
    lines.append(f"valid neighbour slots per list (share of slots): {shares}")
    return ctx, breakdown, lines


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda") -> tuple:
    """(result dict, stderr lines) of one run."""
    lines: List[str] = []
    dev = torch.device(device)
    loop = LOOPS[cell.traffic["mode"]](cell, seed, dev)
    before, t0 = process_age_s(), time.perf_counter()
    loop.setup()
    setup_s = process_age_s()
    stages, last = [], t0
    for name, t in loop.marks:
        stages.append(f"{name} {t - last:.3f}")
        last = t
    lines.append(f"set-up: {before} s to reach the cell's set-up (start, "
                 f"imports, card), {setup_s - before} s in it: "
                 + ", ".join(stages))
    found = imports.forbidden_loaded()
    if found:
        raise ForbiddenImport(f"loaded before the window: {found}")
    win = loop.window(seconds)
    found = imports.forbidden_loaded()
    if found:
        raise ForbiddenImport(f"loaded after the window: {found}")
    metrics = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips}
    breakdown = None
    if trace:
        rate = win["units"] / win["seconds"]
        ctx, breakdown, tl = _trace(loop, cell, cell.traffic["trace_units"],
                                    rate)
        lines.extend(tl)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = ctx.busy_s
        device_info["window_s"] = ctx.window_s
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        for name, value in {**win["metrics"], "setup_s": setup_s}.items():
            metrics[name] = {"value": value, "unit": units[name]}
    device_info["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    loop.free()
    numbers = loop.compare(loop.reference())
    lines.append(f"reference and comparison: {time.perf_counter() - t0} s")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    found = imports.forbidden_loaded()
    if found:
        raise ForbiddenImport(f"loaded by the end of the run: {found}")
    correct, rows = check.judge(numbers, cell.limits)
    lines.append(f"window: {win['units']} units in {win['seconds']} s; "
                 f"set-up {setup_s} s")
    others = {k: v for k, v in numbers.items() if k not in cell.limits}
    if others:
        lines.append(f"readings not compared: {others}")
    for name, value, limit in rows:
        lines.append(f"check {name}: {value} limit {limit}")
    result = {"correct": correct, "attempted": win["units"], "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    return result, lines


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not readable"
    return f"card: {out}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.benchmark(), args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, devices: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    print(_card_line(), file=sys.stderr)
    try:
        result, lines = run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace))
    except ForbiddenImport as e:
        print(f"forbidden modules: {e}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0
