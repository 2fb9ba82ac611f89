"""Where one serving request of the PyTorch/CUDA port spends its time.

    python3 tools/profile_torch_serving.py [--requests 5]

Needs a CUDA card (the port's kernels build at first use, as in
``chip_smoke.py``). Serves the full-width flagship model (batch 16 x 1024
points, bf16, seeded random weights) and traces ``--requests`` requests
with ``torch.profiler``. Prints the device time by kernel, the device's
busy and idle share of the traced wall time, and each kernel wrapper's
host cost per call (host clock over many calls ending in one
synchronize) beside its device time. The Chrome trace goes to
``chiprun_out/serving_trace.json``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from chip_smoke import _busy_us, _device_us  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    from closerlook3d_tpu_torch.serving import Predictor

    print(chip_smoke.gpu_line(), flush=True)
    cfg = chip_smoke.flagship_config()
    weights = chip_smoke.seeded_weights(cfg, torch.Generator().manual_seed(0))
    predictor = Predictor(cfg, weights, device="cuda")
    batches = [chip_smoke.make_batch(1 + r) for r in range(3)]
    for bt in batches:  # warm-up, kernel builds
        predictor(bt["xyz"], bt["mask"], bt["features"])
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(args.requests):
            bt = batches[r % len(batches)]
            predictor(bt["xyz"], bt["mask"], bt["features"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = [e for e in prof.key_averages() if _device_us(e) > 0]
    avgs.sort(key=_device_us, reverse=True)
    dev_total = sum(_device_us(e) for e in avgs)
    busy = _busy_us(prof)
    n = args.requests
    print(f"traced {n} requests: wall {wall_us / n / 1e3:.3f} ms/request, "
          f"device busy {busy / n / 1e3:.3f} ms/request "
          f"({100 * busy / wall_us:.1f}% busy, "
          f"{100 * (1 - busy / wall_us):.1f}% idle); kernel time sum "
          f"{dev_total / n / 1e3:.3f} ms/request", flush=True)
    print("device time by kernel (per request):")
    for e in avgs[:30]:
        print(f"  {_device_us(e) / n / 1e3:9.4f} ms  {e.count / n:6.1f} "
              f"calls  {e.key[:100]}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(REPO, "chiprun_out",
                                          "serving_trace.json"))

    # host cost of each kernel wrapper per call, beside its device time
    dev = torch.device("cuda")
    b = batches[0]
    bq, fps, pp = chip_smoke.path_calls(
        cfg, torch.from_numpy(b["xyz"]).to(dev),
        torch.from_numpy(b["mask"]).to(dev))
    wrappers = chip_smoke.kernel_wrappers()
    name, (q, s, idx, nmask, r), c, _ = pp[0]
    f = torch.randn((s.shape[0], s.shape[1], c), device=dev).to(
        torch.bfloat16)
    calls = {"ball_query": (wrappers["ball_query"], bq[0][1]),
             "fps": (wrappers["fps"], fps[-1][1]),
             "pospool_xyz": (wrappers["pospool_xyz"],
                             (q, s, f, idx, nmask, r, "avg"))}
    for k, (fn, a) in calls.items():
        fn(*a)
        torch.cuda.synchronize()
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*a)
        t_host = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p2:
            for _ in range(20):
                fn(*a)
            torch.cuda.synchronize()
        kern = sum(_device_us(e) for e in p2.key_averages()) / 20
        print(f"{k} ({name if k == 'pospool_xyz' else 'first path call'}): "
              f"host {t_host:.1f} us/call to enqueue, device "
              f"{kern:.1f} us/call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
