"""Reading a traced window: ``torch.profiler``'s chrome trace, device time
attributed to layers, the device's busy time, and the breakdown.

Attribution: each device op (kernel, memcpy, memset) is tied through its
correlation id to the host call that launched it, and so to the host ops
that enclosed that call, innermost first. Backward ops run inside an
autograd node, which the trace ties by its sequence number to the
forward op that made it; the forward op's enclosing ops follow the
node's. The first name on that chain that a layer's ``match`` list
(``layers/<layer>.json``, regular expressions) takes decides the layer.
Spans ``bench::<Module class>`` come from the benchmark's own forward
hooks on the modules that a layer file lists. Device time that no layer
takes is reported as unclaimed.
"""

from __future__ import annotations

import bisect
import json
import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation"}
BACKWARD = "autograd::engine::evaluate_function:"
SPAN = "bench::"


class ModuleSpans:
    """Forward hooks that wrap each forward of the named module classes
    in a ``record_function("bench::<class>")`` span; ``remove()`` takes
    them off."""

    def __init__(self, model: torch.nn.Module, classes):
        self.handles = []
        self.stack = []
        for mod in model.modules():
            name = type(mod).__name__
            if name in classes:
                self.handles.append(mod.register_forward_pre_hook(
                    self._enter(SPAN + name)))
                self.handles.append(mod.register_forward_hook(self._exit))

    def _enter(self, name):
        def hook(module, args):
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self.stack.append(rf)
        return hook

    def _exit(self, module, args, output):
        self.stack.pop().__exit__(None, None, None)

    def remove(self):
        for h in self.handles:
            h.remove()


def profile_units(unit: Callable[[int], None], n: int, path: str,
                  sync: Callable[[], None], host: bool = True) -> float:
    """Trace ``n`` calls of ``unit(i)`` after one traced and discarded
    warm-up call (the first device events after tracing starts can go
    missing); write the chrome trace to ``path``; return the window's
    host-clock seconds, from the first call to the closing ``sync()``.
    ``host=False`` records device activity alone, which adds little to
    the host's time, so that the window's idle share is the run's own."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    acts = acts or [ProfilerActivity.CPU]  # a machine without a card
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        unit(-1)
        sync()
        prof.step()
        t0 = time.perf_counter()
        for i in range(n):
            unit(i)
        sync()
        window = time.perf_counter() - t0
        prof.step()
    prof.export_chrome_trace(path)
    return window


class _Op:
    __slots__ = ("name", "ts", "end", "tid", "parent", "seq", "leaf")

    def __init__(self, e, leaf: bool = False):
        self.leaf = leaf  # a launch call: encloses nothing
        self.name = e["name"]
        self.ts = float(e["ts"])
        self.end = self.ts + float(e.get("dur", 0.0))
        self.tid = (e.get("pid"), e.get("tid"))
        self.parent: Optional[_Op] = None
        self.seq = (e.get("args") or {}).get("Sequence number")


def _nest(items: List[_Op]) -> None:
    """Set each item's innermost enclosing item on its thread."""
    by_tid = defaultdict(list)
    for it in items:
        by_tid[it.tid].append(it)
    for seq in by_tid.values():
        seq.sort(key=lambda o: (o.ts, -(o.end - o.ts)))
        stack: List[_Op] = []
        for it in seq:
            while stack and stack[-1].end < it.end:
                stack.pop()
            it.parent = stack[-1] if stack else None
            if not it.leaf:
                stack.append(it)


def _chain(op: Optional[_Op], forward_of: Dict[int, _Op]) -> List[str]:
    """Names from ``op`` outwards; after a backward node's own chain, the
    chain of the forward op that made it."""
    names, node = [], None
    while op is not None:
        names.append(op.name)
        if node is None and op.name.startswith(BACKWARD):
            node = op
        op = op.parent
    if node is not None and node.seq in forward_of:
        names.extend(_chain(forward_of[node.seq], {}))
    return names


def _union(spans) -> List[tuple]:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def read_trace(path: str, layers: List[dict]) -> dict:
    """Device seconds per layer file and unclaimed, device ops, busy
    seconds, and the breakdown (top device ops, idle gaps by the host op
    running in them)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat", "").lower() in DEVICE_CATS]
    hosts = [_Op(e) for e in events if e.get("cat", "").lower() in HOST_CATS]
    launches = {}
    launch_ops = []
    for e in events:
        if e.get("cat", "").lower() in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                op = _Op(e, leaf=True)
                launches[corr] = op
                launch_ops.append(op)
    _nest(hosts + launch_ops)
    forward_of: Dict[int, _Op] = {}
    for op in sorted(hosts, key=lambda o: o.ts):
        if op.seq is None or op.name.startswith(BACKWARD):
            continue
        chain = _chain(op, {})
        if any(n.startswith(BACKWARD) for n in chain):
            continue
        forward_of[op.seq] = op  # the innermost (latest) forward op wins
    pats = [(ly["file"], [re.compile(p) for p in ly["match"]])
            for ly in layers]
    per_layer = {ly["file"]: 0.0 for ly in layers}
    unclaimed = 0.0
    by_name = defaultdict(float)
    spans = []
    for e in device:
        dur = float(e.get("dur", 0.0)) * 1e-6
        start = float(e["ts"])
        spans.append((start, start + float(e.get("dur", 0.0))))
        by_name[e["name"]] += dur
        corr = (e.get("args") or {}).get("correlation")
        launch = launches.get(corr)
        names = _chain(launch.parent, forward_of) if launch else []
        layer = _first_layer(names, pats)
        if layer is None:
            unclaimed += dur
        else:
            per_layer[layer] += dur
    busy = _union(spans)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = defaultdict(float)
    host_sorted = sorted(hosts, key=lambda o: o.ts)
    starts = [o.ts for o in host_sorted]
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        gaps[_host_at(mid, host_sorted, starts)] += (s1 - e0) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"per_layer_s": per_layer, "unclaimed_s": unclaimed,
            "device_ops": len(device), "busy_s": busy_s,
            "breakdown": {
                "device_ops": [[_short(n), s] for n, s in top],
                "idle_gaps": [[_short(n), s] for n, s in sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:10]]}}


def _first_layer(names, pats) -> Optional[str]:
    for n in names:
        for file, ps in pats:
            if any(p.search(n) for p in ps):
                return file
    return None


def _host_at(t: float, ops: List[_Op], starts: List[float]) -> str:
    """The innermost host op running at ``t`` (the latest started one that
    has not ended), or "no_host_op"."""
    i = bisect.bisect_right(starts, t)
    best = None
    for op in reversed(ops[max(0, i - 4000):i]):
        if op.end >= t and (best is None or op.ts > best.ts):
            best = op
            break
    return best.name if best is not None else "no_host_op"


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.]+", "_", name)[:64]
