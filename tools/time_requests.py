"""Request latency of the serving configs through ``Predictor``, on the
card; optionally against the same readings of another checkout, taken in
turns.

    python3 tools/time_requests.py [--parent DIR] [--reps 20]

Needs a CUDA card and ``nvcc``. Each reading runs in a process of its
own that imports ``closerlook3d_tpu_torch`` from one checkout (this one,
or ``DIR``) and builds that checkout's kernels from its own sources; the
configs, batches and seeded weights come from this checkout's
``chip_smoke.py`` (the flagship, 16 x 1024 points, and the ShapeNetPart
and S3DIS serving configs). A reading serves 3 warm-up requests of each
config, then ``--reps`` requests on the host's clock, each ending in a
synchronize (input copy included), and counts the kernel launches of
one request. Without ``--parent`` one reading of this checkout is
taken; with it the readings go parent, this, this, parent, and the
summary gives each checkout's median of each config over both of its
readings. The card's name and power limit are printed first; everything
goes to ``chiprun_out/time_requests.json``.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import chip_smoke  # noqa: E402  (imports no part of the port at load)
import time_ball_query  # noqa: E402

CONFIGS = ("flagship", "shapenetpart", "s3dis")


def request_times(name: str, reps: int) -> dict:
    """Sorted host-clock ms of ``reps`` requests of serving config
    ``name`` and the launches of one request."""
    import torch

    from closerlook3d_tpu_torch.serving import Predictor

    if name == "flagship":
        cfg = chip_smoke.flagship_config()
        bt = chip_smoke.make_batch(chip_smoke.SEED + 1)
    else:
        cfg = chip_smoke.seg_config(name)
        bt = chip_smoke.seg_batch(cfg, chip_smoke.SEED + 900)
    weights = chip_smoke.seeded_weights(
        cfg, torch.Generator().manual_seed(chip_smoke.SEED + 20))
    predictor = Predictor(cfg, weights, device=chip_smoke.DEVICE)
    wrappers = chip_smoke.kernel_wrappers()
    chip_smoke.reset_counts(wrappers)
    predictor(bt["xyz"], bt["mask"], bt["features"])
    torch.cuda.synchronize()
    launches = {k: v for k, v in chip_smoke.read_counts(wrappers).items()
                if v}
    lat = chip_smoke._request_latencies(predictor, [bt] * 2, reps)
    med = lat[len(lat) // 2]
    chip_smoke.log("requests", f"{name}: median {med:.3f} ms over {reps} "
                   f"(min {lat[0]:.3f}, max {lat[-1]:.3f}); launches "
                   f"{launches}")
    return {"ms": lat, "median_ms": med, "launches": launches}


def reading(tree: str, reps: int) -> dict:
    """One reading of checkout ``tree`` (see the module's docstring)."""
    sys.path.insert(0, tree)
    import torch

    import closerlook3d_tpu_torch
    from closerlook3d_tpu_torch.ops import kernels

    pkg = os.path.dirname(os.path.abspath(closerlook3d_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(tree):
        raise AssertionError(f"imported the port from {pkg}, not {tree}")
    kernels.build_all(n[:-3] for n in os.listdir(kernels.CSRC)
                      if n.endswith(".cu"))
    out = {"tree": tree, "requests": {}}
    for name in CONFIGS:
        out["requests"][name] = request_times(name, reps)
        torch.cuda.empty_cache()
    return out


def compare(parent: list, this: list) -> dict:
    """Per config: each checkout's median over all requests of its two
    readings, and the launches of a request (which must agree)."""
    import numpy as np

    out = {}
    for name in CONFIGS:
        row = {}
        for label, rs in (("parent", parent), ("this", this)):
            row[f"{label}_median_ms"] = float(np.median(
                [t for r in rs for t in r["requests"][name]["ms"]]))
            row[f"{label}_reading_medians_ms"] = [
                r["requests"][name]["median_ms"] for r in rs]
        launches = {str(r["requests"][name]["launches"])
                    for r in parent + this}
        if len(launches) != 1:
            raise AssertionError(f"{name}: launches differ between "
                                 f"readings: {launches}")
        row["launches"] = parent[0]["requests"][name]["launches"]
        out[name] = row
        chip_smoke.log("compare", f"{name}: request median this "
                       f"{row['this_median_ms']:.3f} ms "
                       f"{row['this_reading_medians_ms']}, parent "
                       f"{row['parent_median_ms']:.3f} ms "
                       f"{row['parent_reading_medians_ms']}; launches "
                       f"{row['launches']}")
    return out


def main() -> int:
    return time_ball_query.tool_main(__file__, __doc__, reading, compare,
                                     "time_requests")


if __name__ == "__main__":
    sys.exit(main())
