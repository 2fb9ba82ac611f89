"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<workload>.json``, ``layers/*.json`` and ``metrics/<name>.py``
under this folder."""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix,
    limits and the metrics it reports."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = _load(os.path.join(
            HERE, "configs", self.workload["config"] + ".json"))
        self.traffic = _load(os.path.join(
            HERE, "traffic", self.workload["traffic"] + ".json"))
        self.limits = _load(os.path.join(HERE, "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]

    def ref_config(self) -> dict:
        """The configuration as the reference reads it: the program's
        keys and ``steps_per_epoch``."""
        return {**self.config["config"],
                "steps_per_epoch": self.config["steps_per_epoch"]}


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def flatten(d: dict, prefix: str = "") -> Dict[str, Any]:
    """{"a": {"b": 1}} -> {"a.b": 1}: dotted overrides."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def layers() -> List[dict]:
    """Every ``layers/*.json``: {"layer", "match", "modules"}, with
    ``file`` its name."""
    out = []
    for path in sorted(glob.glob(os.path.join(HERE, "layers", "*.json"))):
        d = _load(path)
        d["file"] = os.path.splitext(os.path.basename(path))[0]
        out.append(d)
    return out


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
