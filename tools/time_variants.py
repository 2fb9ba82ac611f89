"""Source variants of the redesigned kernels, timed against each other
call by call in one process, on the card: the forwards K10f
(``csrc/pseudo_grid.cu``), K5f (``csrc/pospool_sincos.cu``), K1f
(``csrc/pospool_xyz.cu``), K9f (``csrc/moments.cu``), K6f and K7f
(``csrc/gather_reduce.cu``), K8f (``csrc/neighborhood_max.cu``), FPS
(K4, ``csrc/fps.cu``), the k-NN (``csrc/knn.cu``) and the ball query, or
the backwards K6b, K10b, K5b, K9b, K1b, K8b (``csrc/neighborhood_max.cu``)
and K7b (``csrc/gather_reduce.cu``).

    python3 tools/time_variants.py VARIANTS.json [--kernels forward]

VARIANTS.json maps a variant's name to the edits that make it from this
checkout's ``csrc/``: ``{"file under csrc/": [[old, new], ...]}`` (each
``old`` must occur), or ``{"__dir__": "a csrc directory, relative to the
repository"}`` for another design's sources, whose C entries must take
this checkout's wrappers' arguments; ``{}`` is this checkout as it
stands. ``--kernels`` takes the choices of ``tools/time_backward.py``
(``forward``, the default; ``backward``; ``all``), or kernel names there
joined by commas (``pospool_sincos_bwd,moments_bwd``; ``fps``). Needs a
CUDA card and ``nvcc``. Each variant builds the sources of the chosen kernels into
the git-ignored ``csrc/_build/variants/``, all at once, and prints their
kernels' registers and spills. Then, at every call of the ModelNet40 bf16 train
steps that ``tools/time_backward.py`` times them at, on its inputs, each
variant's library takes the wrapper's place in turn (``kernels._LIBS``;
the k-NN and the ball query at the requests' and forwards' calls of
``tools/time_backward.py``):
its output's bits against the first variant's, and its device time
(``chip_smoke._device_time``) read twice, in the variants' order and
then reversed. A reading whose profile window recorded no device events
is printed as such and left out of the mean. Lines ``CALL`` give each
call's mean per variant and its ratio to the first variant, ``STEP`` the
sums a step; the records go to
``chiprun_out/time_variants/<VARIANTS>.json``. A design's variants are
edits of its own sources, so a spec applies to the tree it was written
for; ``tools/variants/`` keeps those that apply to this tree
(``fps_cluster.json``: FPS over 1, 2 and 4 CTAs of a thread block
cluster, which ``tests/test_torch_fps.py`` checks still applies).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import chip_smoke  # noqa: E402
import time_backward  # noqa: E402

# kernel (time_backward.TIMED's names) -> its source under csrc/
SOURCES = {"pseudo_grid": "pseudo_grid", "pospool_sincos": "pospool_sincos",
           "pospool_xyz": "pospool_xyz", "moments": "moments",
           "pwmlp_stats_bwd": "gather_reduce",
           "pseudo_grid_bwd": "pseudo_grid",
           "pospool_sincos_bwd": "pospool_sincos", "moments_bwd": "moments",
           "pwmlp_stats": "gather_reduce", "pospool_xyz_bwd": "pospool_xyz",
           "fps": "fps", "neighborhood_max_bwd": "neighborhood_max",
           "neighborhood_max": "neighborhood_max",
           "gather_sub_minmax": "gather_reduce",
           "gather_sub_minmax_bwd": "gather_reduce", "knn": "knn",
           "ball_query": "ball_query"}
# parts of the device functions' names whose registers are printed
KERNEL_NAMES = ("pseudo_grid_kernel", "pseudo_grid_sums", "pospool_sincos",
                "pospool_xyz_kernel", "moments_kernel", "sincos_gather",
                "moments_gather", "index_scale", "pwstats_terms",
                "csr_gather", "pwstats_fwd", "xyz_gather", "fps_kernel",
                "nmax_index_ties", "nmax_gather", "nmax_fwd", "mm_fwd",
                "mm_index_shares", "mm_gather", "knn1", "prep_",
                "ball_query_kernel")


def build(name: str, spec: dict, src: str):
    """Compile ``csrc/<src>.cu`` of variant ``name``; the .so path, or
    None (and nvcc's error printed) if it does not build."""
    from closerlook3d_tpu_torch.ops import kernels

    spec = dict(spec)
    origin = spec.pop("__dir__", None)
    d = os.path.join(kernels.BUILD_DIR, "variants", f"{name}_{src}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, origin) if origin else kernels.CSRC,
                    d, ignore=shutil.ignore_patterns("_build"))
    for fn, edits in spec.items():
        path = os.path.join(d, fn)
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: {fn} has no {old[:60]!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    lib = os.path.join(d, f"{src}.so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
                           os.path.join(d, f"{src}.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        print(f"BUILD FAIL {name} {src}\n{proc.stderr[-3000:]}", flush=True)
        return None
    entry = None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and any(n in entry for n in KERNEL_NAMES) and (
                "registers" in line
                or ("spill" in line and " 0 bytes spill stores" not in line)):
            print(f"PTXAS {name} {entry[-60:]}: {line.strip()}", flush=True)
    return lib


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.cl3d_error_string.argtypes = [ctypes.c_int]
    lib.cl3d_error_string.restype = ctypes.c_char_p
    return lib


def digest(out) -> str:
    """SHA-256 of the bytes of a kernel's output (every tensor of a
    tuple in turn)."""
    import torch

    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def device_ms(fn, ins, per_op):
    """``chip_smoke._device_time`` of one reading (each op's ms into
    ``per_op``), or None (printed) where its profile windows recorded no
    device events."""
    try:
        return chip_smoke._device_time(fn, ins, 20, per_op)[0]
    except AssertionError as e:
        print(f"NO DEVICE EVENTS {str(e)[:200]}", flush=True)
        return None


def timed(choice: str):
    """(step, kernel) pairs of a --kernels choice
    (``time_backward.timed``) whose sources this tool edits."""
    pairs = time_backward.timed(choice)
    unknown = {k for _, k in pairs} - set(SOURCES)
    if unknown:
        raise SystemExit(f"--kernels: no source for {sorted(unknown)}")
    return pairs


def main() -> int:
    import argparse

    import torch

    from closerlook3d_tpu_torch.ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("spec")
    ap.add_argument("--kernels", default="forward",
                    help="forward, backward, all, or kernel names joined "
                         "by commas (pospool_sincos_bwd,moments_bwd)")
    args = ap.parse_args()
    with open(args.spec) as f:
        variants = json.load(f)
    pairs = timed(args.kernels)
    print(chip_smoke.gpu_line(), flush=True)
    sources = sorted({SOURCES[k] for _, k in pairs})
    with ThreadPoolExecutor(max_workers=8) as pool:
        jobs = {(n, src): pool.submit(build, n, spec, src)
                for n, spec in variants.items() for src in sources}
    libs = {k: load(job.result()) for k, job in jobs.items() if job.result()}
    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(
        chip_smoke.SEED + 4)
    record = {}
    for step, kernel in pairs:
        src = SOURCES[kernel]
        names = [n for n in variants if (n, src) in libs]
        per_step = dict.fromkeys(names, 0.0)
        for call, count, fn, _, ins, (nbytes, flops) in time_backward._cases(
                step, kernel, gen):
            ms = {n: [] for n in names}
            ops = {n: {} for n in names}  # op -> ms a call, last reading
            bits = {}
            for order in (names, names[::-1]):
                for n in order:
                    kernels._LIBS[src] = libs[(n, src)]
                    if n not in bits:
                        bits[n] = digest(fn(*ins[0]))
                    ms[n].append(device_ms(fn, ins, ops[n]))
            mean = {}
            for n, v in ms.items():
                read = [x for x in v if x is not None]
                mean[n] = sum(read) / len(read) if read else float("nan")
            first = mean[names[0]]
            print(f"CALL {step}:{kernel} {call} x{count} bound "
                  f"{chip_smoke._bound(nbytes, flops)[0]:.5f}: " + " ".join(
                      f"{n}={m:.5f}({m / first:.2f})"
                      + ("" if bits[n] == bits[names[0]] else "!BITS")
                      for n, m in mean.items()), flush=True)
            print(f"OPS {kernel} {call}: " + "; ".join(
                f"{n} " + ", ".join(f"{chip_smoke._op_name(o)[:40]} {v:.5f}"
                                    for o, v in ops[n].items())
                for n in names), flush=True)
            for n in names:
                per_step[n] += count * mean[n]
            record[f"{step}:{kernel}:{call}"] = {"ms": ms, "sha256": bits,
                                                 "ms_by_op": ops}
            torch.cuda.empty_cache()
        first = per_step[names[0]]
        print(f"STEP {step}:{kernel}: " + " ".join(
            f"{n}={v:.5f}({v / first:.3f})" for n, v in per_step.items()),
            flush=True)
    out = os.path.join(REPO, "chiprun_out", "time_variants")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, os.path.basename(args.spec)), "w") as f:
        json.dump(record, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
