"""The redesigned kernels, backward (K6b,
``pwmlp_minmax_stats_bwd_cuda``; K10b, ``pseudo_grid_bwd_cuda``; K5b,
``pospool_sincos_bwd_cuda``; K9b, ``neighborhood_moments_bwd_cuda``; K1b,
``pospool_xyz_bwd_cuda``; K8b, ``neighborhood_max_bwd_cuda``; K7b,
``gather_sub_minmax_bwd_cuda``) and forward (K10f, ``pseudo_grid_cuda``;
K5f, ``pospool_sincos_cuda``; K1f, ``pospool_xyz_cuda``; K9f,
``neighborhood_moments_cuda``; K6f, ``pwmlp_minmax_stats_cuda``; K4,
``furthest_point_sample_cuda``; K8f, ``neighborhood_max_cuda``; K7f,
``gather_sub_minmax_cuda``; the k-NN, ``knn``; the ball query,
``ball_query_cuda``): device time
per call and per train step or request, the bits of every call's
output, and each train config's device busy time a step and each
serving config's a request, on the card; optionally against the same
readings of another checkout, taken in turns.

    python3 tools/time_backward.py [--parent DIR] [--reps 20]
                                   [--kernels backward|forward|all|NAMES]

Needs a CUDA card and ``nvcc``. Each reading runs in a process of its
own that imports ``closerlook3d_tpu_torch`` from one checkout (this one,
or ``DIR``) and builds that checkout's kernels from its own sources, so
every C entry is called by its own wrapper; the helpers come from this
checkout's ``chip_smoke.py`` and ``tools/time_ball_query.py``. A reading
holds:

* with ``--kernels backward`` or ``all`` (the default): K6b at every
  call of the ModelNet40 point-wise MLP train step and at the K6 calls
  of ``seg-train:shapenetpart_pwmlp`` (8 clouds; its last stage takes
  the K13 + K7 route), K10b at every call of the ModelNet40 pseudo-grid
  train step, K5b and K9b at every call of the sin/cos and the
  adaptive-weight steps, K1b and K8b (``neighborhood_max_bwd_cuda``, at
  the strided calls) at every call of the xyz step and of
  ``seg-train:s3dis`` (8 x 15000 points), K7b at the 14 calls of the
  point-wise MLP's eval-mode backward and at the 3 K13-route calls of
  ``seg-train:shapenetpart_pwmlp`` (B·Nq <= 64); with ``forward`` or
  ``all``: the k-NN (``knn``, both routes) at the 4 upsample calls of an
  S3DIS and of a ShapeNetPart request and the ball query at the 9 calls
  of the xyz step, of ``seg-train:s3dis`` and of a flagship request,
  both held equal to their plain versions (run in query chunks),
  K10f at every call of the pseudo-grid step, K5f at every call of the
  sin/cos step, K1f at every call of the xyz step and of a flagship
  request (16 x 1024 points, ``chip_smoke.flagship_config()``: the
  serving path), K9f at every call of the adaptive-weight step and K6f
  at every call of the point-wise MLP step and at the K6 calls of
  ``seg-train:shapenetpart_pwmlp``, and FPS (K4,
  ``furthest_point_sample_cuda``, f32 points) at the 4 calls of the xyz
  step and of a flagship request, held equal to its plain version, K8f
  (``neighborhood_max_cuda``) at the strided calls of the xyz step, of
  ``seg-train:s3dis`` and of a flagship request, and K7f
  (``gather_sub_minmax_cuda``) at the 14 calls of the point-wise MLP's
  eval-mode forward, both held equal to their plain versions. bf16,
  inputs from three seeded batches as ``chip_smoke.py`` makes them; each
  call first held to its plain version or twin run on the card, the
  SHA-256 of its output bytes taken on the first set in bf16 and again
  with every bf16 input cast to f32, then timed by
  ``chip_smoke._device_time`` (the profiler's mean per device op, summed
  over the call's ops: the reverse index, fills, casts and kernels) and
  by CUDA events over eager launches, beside its bound; K5b, K9b, K1b and
  K8b also hashed on a second launch (the same bits run to run) and held to
  their twins run on CPU copies (whether the bits are equal, and the
  largest difference);
* each train config of ``chip_smoke.py`` (the five ModelNet40 configs
  and the two segmentation ones): 4 bf16 steps on one batch, then 3
  under torch.profiler; device busy ms a step (union of device op
  intervals, user annotations out) and each device op's ms a step;
* each serving config (the flagship, ShapeNetPart and S3DIS, seeded
  weights): 2 requests through ``Predictor``, then 5 under
  torch.profiler; device busy ms and each device op's ms a request.

Without ``--parent`` one reading of this checkout is taken. With it the
readings go parent, this, this, parent, and the summary gives each
checkout's mean of two: per call (device ms and ops, events ms, bound,
the parent's device ms, and whether the output bits equal the parent's
in bf16 and f32, as for every forward, whose sums run in slot order;
for K5b, K9b, K1b, K8b and K7b, whose parents add with atomics, the bits
run to run and against the CPU twin instead), per step or request, and
per config
the busy time beside the timed kernels' saving (per-call device times
times calls a step or request). The card's name and power limit are
printed first; everything goes to
``chiprun_out/time_backward.json``.
"""

from __future__ import annotations

import hashlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import chip_smoke  # noqa: E402  (imports no part of the port at load)
import time_ball_query  # noqa: E402

# the flagship's request: its K1f calls are timed, its busy read a request
FLAGSHIP = "flagship request"
# serving configs profiled a request: the flagship, and chip_smoke.py's
# segmentation configs
REQUESTS = {FLAGSHIP: "flagship", "shapenetpart request": "shapenetpart",
            "s3dis request": "s3dis"}
# (step, kernel) pairs timed call by call, by --kernels choice; the step
# names a config of chip_smoke.py (or the flagship's request) and the
# kernel its kernels line's name
TIMED = {"backward": (("pwmlp", "pwmlp_stats_bwd"),
                      ("pgrid", "pseudo_grid_bwd"),
                      ("shapenetpart_pwmlp", "pwmlp_stats_bwd"),
                      ("sincos", "pospool_sincos_bwd"),
                      ("adaptive", "moments_bwd"),
                      ("xyz", "pospool_xyz_bwd"),
                      ("s3dis", "pospool_xyz_bwd"),
                      ("xyz", "neighborhood_max_bwd"),
                      ("s3dis", "neighborhood_max_bwd"),
                      ("pwmlp", "gather_sub_minmax_bwd"),
                      ("shapenetpart_pwmlp", "gather_sub_minmax_bwd")),
         "forward": (("pgrid", "pseudo_grid"),
                     ("sincos", "pospool_sincos"),
                     ("xyz", "pospool_xyz"),
                     (FLAGSHIP, "pospool_xyz"),
                     ("adaptive", "moments"),
                     ("pwmlp", "pwmlp_stats"),
                     ("shapenetpart_pwmlp", "pwmlp_stats"),
                     ("xyz", "fps"),
                     (FLAGSHIP, "fps"),
                     ("xyz", "neighborhood_max"),
                     ("s3dis", "neighborhood_max"),
                     (FLAGSHIP, "neighborhood_max"),
                     ("pwmlp", "gather_sub_minmax"),
                     ("s3dis request", "knn"),
                     ("shapenetpart request", "knn"),
                     ("xyz", "ball_query"),
                     ("s3dis", "ball_query"),
                     (FLAGSHIP, "ball_query"))}
TIMED["all"] = TIMED["backward"] + TIMED["forward"]
# backward kernels whose parents scattered with f32 atomics, so that their
# bits varied run to run: held to themselves and to their CPU twins
# instead of the parent's bits; the config kind whose tolerance holds each
RECOMPUTED = {"pospool_sincos_bwd": "sincos", "moments_bwd": "adaptive",
              "pospool_xyz_bwd": "xyz", "neighborhood_max_bwd": "xyz",
              "gather_sub_minmax_bwd": "pwmlp"}
# kernels whose outputs must equal their plain versions' (indices, picks,
# extrema)
EXACT = ("fps", "neighborhood_max", "gather_sub_minmax", "knn", "ball_query")


def _geometry_cases(step: str, kernel: str) -> list:
    """``_cases`` of the ball query (the 9 calls of a ``chip_smoke.BQ_STEPS``
    forward) and of the k-NN (the 4 upsample calls of a segmentation
    request, ``chip_smoke._knn_calls``), on three seeded input sets, each
    call once a step or request; the plain versions run in query chunks
    (``query_chunk``), as the port's CPU path does."""
    from closerlook3d_tpu_torch.ops import neighbors as nbr

    def chunked(plain):
        return lambda *a: plain(*a, chunk_size=nbr.query_chunk(
            a[0].shape[1]))

    if kernel == "ball_query":
        name = "flagship" if step == FLAGSHIP else step
        sets = [chip_smoke.bq_step_calls(name, chip_smoke.SEED + 600 + r)
                for r in range(3)]
        fn, plain = nbr.ball_query_cuda, chunked(nbr.ball_query_plain)
        bound = chip_smoke.bq_bound
    else:
        sets = chip_smoke._knn_calls(chip_smoke.seg_config(REQUESTS[step]))
        fn, plain = nbr.knn, chunked(nbr.knn_plain)
        bound = lambda a: chip_smoke.knn_bound(*a)  # noqa: E731
    rows = []
    for i, (call, a) in enumerate(sets[0]):
        b = bound(a)
        rows.append((call, 1, fn, plain, [cs[i][1] for cs in sets],
                     (b["bytes"], b.get("flops", 0.0))))
    return rows


def _cases(step: str, kernel: str, gen) -> list:
    """``chip_smoke._kernel_cases`` rows of ``kernel`` at the calls of
    ``step``: (call, per step, kernel fn, plain fn, inputs per set,
    (bytes, flops))."""
    import torch

    from closerlook3d_tpu_torch.models.backbone import compute_geometry

    if kernel in ("ball_query", "knn"):
        return _geometry_cases(step, kernel)
    dev = torch.device(chip_smoke.DEVICE)
    calls = []
    if step in chip_smoke.TRAIN_KINDS or step == FLAGSHIP:
        tcfg = (chip_smoke.flagship_config() if step == FLAGSHIP
                else chip_smoke.train_config(step))
        for r in range(3):
            b = chip_smoke.make_batch(chip_smoke.SEED + 600 + r,
                                      batch=tcfg.batch_size,
                                      points=tcfg.num_points)
            calls.append(chip_smoke.path_calls(
                tcfg, torch.from_numpy(b["xyz"]).to(dev),
                torch.from_numpy(b["mask"]).to(dev)))
        kind = "xyz" if step == FLAGSHIP else step
    else:  # the aggregation calls of a segmentation step (the point-wise
        # MLP's K6 calls: those not on the K13 route)
        tcfg = chip_smoke.seg_train_config(step)
        kind = chip_smoke.config_kind(tcfg)
        for r in range(3):
            b = chip_smoke.seg_batch(tcfg, chip_smoke.SEED + 1400 + r)
            with torch.no_grad():
                g = compute_geometry(tcfg, torch.from_numpy(b["xyz"]).to(dev),
                                     torch.from_numpy(b["mask"]).to(dev))
            pp = chip_smoke.seg_calls(tcfg, g)[1]
            if kernel.startswith("neighborhood_max"):
                calls.append(pp)
                continue
            if kind == "pwmlp":  # K7 on the K13 route, K6 elsewhere
                k13 = {c[0] for c in chip_smoke._k13_calls(pp)}
                on_k13 = kernel.startswith("gather_sub_minmax")
                pp = [c for c in pp if (c[0] in k13) == on_k13]
            calls.append((None, None, pp))
    if kernel.startswith("neighborhood_max") and step not in (
            chip_smoke.TRAIN_KINDS + (FLAGSHIP,)):  # a seg step's strided
        return chip_smoke._max_cases(tcfg, calls, gen)[kernel]
    return chip_smoke._kernel_cases(tcfg, calls, gen, kind)[kernel]


def _tol(kernel: str, dtype):
    """The tolerance ``chip_smoke.py`` holds the kernel to (the timing
    inputs reduce by avg)."""
    if kernel in EXACT:
        return dict(rtol=0, atol=0)
    if kernel == "gather_sub_minmax_bwd":
        return chip_smoke._pwmlp_bwd_tol(dtype)
    if kernel.startswith("pseudo_grid"):
        return chip_smoke._pgrid_tol(dtype)
    if kernel in ("pospool_sincos", "pospool_xyz", "moments"):
        return chip_smoke._pospool_fwd_tol(dtype, "avg")
    if kernel in RECOMPUTED:
        return chip_smoke._bwd_tol(dtype, "avg", RECOMPUTED[kernel])
    return chip_smoke._pwmlp_bwd_tol(dtype)


def _bits(t):
    import torch

    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def twin_check(fn, twin, inputs) -> dict:
    """A second launch's bits against the first's, and the output against
    the twin run on CPU copies of ``inputs``: bits equal, largest
    difference."""
    import torch

    def outs(x):
        return [t.cpu() for t in (x if isinstance(x, tuple) else (x,))]

    got = outs(fn(*inputs))
    ref = outs(twin(*(a.cpu() if isinstance(a, torch.Tensor) else a
                      for a in inputs)))
    again = outs(fn(*inputs))
    torch.cuda.synchronize()
    return {"same_bits_run_to_run": all(
                torch.equal(_bits(a), _bits(b)) for a, b in zip(got, again)),
            "equal_to_cpu_twin": all(
                torch.equal(_bits(a), _bits(b)) for a, b in zip(got, ref)),
            "cpu_twin_max_abs_err": max(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(got, ref))}


def output_sha256(fn, inputs) -> dict:
    """SHA-256 of the bytes of ``fn(*inputs)`` (every output in turn), and
    again with every bf16 tensor of ``inputs`` cast to f32 (None where the
    kernel refuses that mix)."""
    import torch

    def digest(ins):
        got = fn(*ins)
        h = hashlib.sha256()
        for t in got if isinstance(got, tuple) else (got,):
            h.update(str(t.dtype).encode())
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        return h.hexdigest()

    f32 = [a.float() if isinstance(a, torch.Tensor)
           and a.dtype == torch.bfloat16 else a for a in inputs]
    try:
        wide = digest(f32)
    except ValueError:
        wide = None
    return {"bf16": digest(inputs), "f32": wide}


def time_calls(step: str, kernel: str, reps: int) -> dict:
    """Each call of ``kernel`` in ``step``: held to its twin on the card,
    then its device time (and ops) and events time; per-step sums."""
    import torch

    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(
        chip_smoke.SEED + 4)
    rows = []
    for name, count, fn, plain, ins, (nbytes, flops) in _cases(step, kernel,
                                                               gen):
        got, ref = fn(*ins[0]), plain(*ins[0])
        torch.cuda.synchronize()
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            torch.testing.assert_close(a.float(), b.float(),
                                       **_tol(kernel, a.dtype))
        per_op = {}
        sha = output_sha256(fn, ins[0])
        ms, ops = chip_smoke._device_time(fn, ins, reps, per_op)
        bound_ms, bound_by = chip_smoke._bound(nbytes, flops)
        rows.append({"call": name, "per_step": count, "device_ms": ms,
                     "device_ops_per_call": ops, "device_ms_by_op": per_op,
                     "stream_ms": chip_smoke._time(fn, ins, reps),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "flops": flops, "sha256": sha})
        if kernel in RECOMPUTED:
            rows[-1].update(twin_check(fn, plain, ins[0]))
        chip_smoke.log("backward-timing", f"{step} {kernel} {name} x{count}: "
                       f"device {ms:.5f} ms in {ops} ops ("
                       + ", ".join(f"{chip_smoke._op_name(n)} {v:.5f}"
                                   for n, v in per_op.items())
                       + f"); events {rows[-1]['stream_ms']:.4f} ms; bound "
                       f"{bound_ms:.5f} ms ({bound_by})")
    tot = {k: sum(r[k] * r["per_step"] for r in rows)
           for k in ("device_ms", "stream_ms", "bound_ms")}
    chip_smoke.log("backward-timing", f"{step} {kernel} per step: " + ", ".join(
        f"{k} {v:.5f}" for k, v in tot.items()))
    return {"calls": rows, **tot}


def request_profile(name: str, warm: int = 2, n: int = 5) -> dict:
    """Device busy ms a request of serving config ``REQUESTS[name]``
    through ``Predictor`` (seeded weights, one seeded batch) and each
    device op's ms a request, over ``n`` profiled requests after
    ``warm``."""
    import torch

    from closerlook3d_tpu_torch.serving import Predictor

    config = REQUESTS[name]
    if config == "flagship":
        cfg = chip_smoke.flagship_config()
        bt = chip_smoke.make_batch(chip_smoke.SEED + 1)
    else:
        cfg = chip_smoke.seg_config(config)
        bt = chip_smoke.seg_batch(cfg, chip_smoke.SEED + 900)
    weights = chip_smoke.seeded_weights(
        cfg, torch.Generator().manual_seed(chip_smoke.SEED + 20))
    predictor = Predictor(cfg, weights, device=chip_smoke.DEVICE)
    def run():
        predictor(bt["xyz"], bt["mask"], bt["features"])

    for _ in range(warm):
        run()
    torch.cuda.synchronize()
    out = time_ball_query.profiled_ops(run, n)
    chip_smoke.log("request-profile", f"{name}: device busy "
                   f"{out['busy_ms']:.3f} ms a request")
    return out


def reading(tree: str, reps: int, kernels: str = "all") -> dict:
    """One reading of checkout ``tree`` (see the module's docstring)."""
    sys.path.insert(0, tree)
    import torch

    import closerlook3d_tpu_torch
    from closerlook3d_tpu_torch.ops import kernels as build

    pkg = os.path.dirname(os.path.abspath(closerlook3d_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(tree):
        raise AssertionError(f"imported the port from {pkg}, not {tree}")
    build.build_all(n[:-3] for n in os.listdir(build.CSRC)
                      if n.endswith(".cu"))
    out = {"tree": tree, "calls": {}, "steps": {}}
    for step, kernel in timed(kernels):
        out["calls"][f"{step}:{kernel}"] = time_calls(step, kernel, reps)
        torch.cuda.empty_cache()
    for name in chip_smoke.TRAIN_KINDS + chip_smoke.SEG_TRAIN_NAMES:
        out["steps"][name] = time_ball_query.step_profile(name, set())
        torch.cuda.empty_cache()
    for name in REQUESTS:
        out["steps"][name] = request_profile(name)
        torch.cuda.empty_cache()
    return out


def _mean(xs):
    return sum(xs) / len(xs)


def compare(parent: list, this: list) -> dict:
    """Each checkout's mean of its readings, and what changed."""
    out = {"calls": {}, "steps": {}}
    saving = {}  # config -> device ms a step the timed kernels saved
    for key, t in this[0]["calls"].items():
        rows = []
        for i, row in enumerate(t["calls"]):
            r = {"call": row["call"], "per_step": row["per_step"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]}
            shas = [p["calls"][key]["calls"][i]["sha256"]
                    for p in parent + this]
            r["same_bits_as_parent"] = {
                dt: len({h[dt] for h in shas}) == 1 for dt in shas[0]}
            for k in ("same_bits_run_to_run", "equal_to_cpu_twin",
                      "cpu_twin_max_abs_err"):
                if k in row:
                    r[k] = [p["calls"][key]["calls"][i][k] for p in this]
                    r["parent_" + k] = [p["calls"][key]["calls"][i][k]
                                        for p in parent]
            for k in ("device_ms", "stream_ms", "device_ops_per_call"):
                r["parent_" + k] = _mean([p["calls"][key]["calls"][i][k]
                                          for p in parent])
                r[k] = _mean([p["calls"][key]["calls"][i][k] for p in this])
            rows.append(r)
            if "equal_to_cpu_twin" in r:
                bits = (f"same bits run to run {r['same_bits_run_to_run']} "
                        f"(parent {r['parent_same_bits_run_to_run']}), "
                        f"equal to the CPU twin {r['equal_to_cpu_twin']} "
                        f"(parent {r['parent_equal_to_cpu_twin']}), max abs "
                        f"err {max(r['cpu_twin_max_abs_err']):.3g}")
            else:
                bits = ("bits equal to the parent's: "
                        f"{r['same_bits_as_parent']}")
            chip_smoke.log("compare", f"{key} {r['call']}: device "
                           f"{r['device_ms']:.5f} ms in "
                           f"{r['device_ops_per_call']:g} ops, parent "
                           f"{r['parent_device_ms']:.5f} ms in "
                           f"{r['parent_device_ops_per_call']:g}; events "
                           f"{r['stream_ms']:.5f} ms; bound "
                           f"{r['bound_ms']:.5f}; {bits}")
        tot = {k: sum(r[k] * r["per_step"] for r in rows)
               for k in ("device_ms", "parent_device_ms", "stream_ms",
                         "parent_stream_ms", "bound_ms")}
        out["calls"][key] = {"calls": rows, **tot}
        step = key.split(":")[0]
        saving[step] = (saving.get(step, 0.0) + tot["parent_device_ms"]
                        - tot["device_ms"])
        chip_smoke.log("compare", f"{key} per step: device "
                       f"{tot['device_ms']:.5f} ms, parent "
                       f"{tot['parent_device_ms']:.5f} ms, bound "
                       f"{tot['bound_ms']:.5f} ms")
    for name in this[0]["steps"]:
        row = {"parent_busy_ms": _mean([r["steps"][name]["busy_ms"]
                                        for r in parent]),
               "busy_ms": _mean([r["steps"][name]["busy_ms"] for r in this]),
               "saving_ms": saving.get(name, 0.0)}
        row["fall_ms"] = row["parent_busy_ms"] - row["busy_ms"]
        row["fall_less_saving_ms"] = row["fall_ms"] - row["saving_ms"]
        names = set()
        for r in parent + this:
            names |= set(r["steps"][name]["ops_ms"])
        delta = {op: _mean([r["steps"][name]["ops_ms"].get(op, 0.0)
                            for r in this])
                 - _mean([r["steps"][name]["ops_ms"].get(op, 0.0)
                          for r in parent]) for op in names}
        order = sorted(delta, key=delta.get)
        row["fell_most"] = [(op[:90], delta[op]) for op in order[:4]]
        row["rose_most"] = [(op[:90], delta[op]) for op in order[::-1][:4]]
        out["steps"][name] = row
        chip_smoke.log(
            "compare", f"{name}: busy {row['busy_ms']:.3f} ms a "
            f"{'request' if name in REQUESTS else 'step'}, parent "
            f"{row['parent_busy_ms']:.3f}, fall {row['fall_ms']:+.4f}, "
            f"timed kernels' saving {row['saving_ms']:.4f}; rose most "
            + "; ".join(f"{op} {d:+.4f}" for op, d in row["rose_most"]))
    return out


def timed(choice: str):
    """(step, kernel) pairs of a --kernels choice: a set of ``TIMED``, or
    kernel names joined by commas (every step that times them)."""
    if choice in TIMED:
        return TIMED[choice]
    names = choice.split(",")
    unknown = set(names) - {k for _, k in TIMED["all"]}
    if unknown:
        raise SystemExit(f"--kernels: unknown {sorted(unknown)}")
    return tuple(p for p in TIMED["all"] if p[1] in names)


def main() -> int:
    return time_ball_query.tool_main(
        __file__, __doc__, reading, compare, "time_backward",
        [("--kernels", dict(default="all",
                            help="backward, forward, all, or kernel names "
                                 "joined by commas (knn,ball_query)"))])


if __name__ == "__main__":
    sys.exit(main())
