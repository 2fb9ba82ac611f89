"""GPU smoke run of the PyTorch/CUDA port: serving and training.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME/bin/nvcc``, default
``/usr/local/cuda``). It builds the port's hand-written CUDA kernels from
``closerlook3d_tpu_torch/csrc/`` (one nvcc per source, all at once) and,
with every check raising on failure and no CPU fallback:

* serving: checks ball query, FPS, PosPool and the neighborhood max
  against their plain PyTorch versions at every shape of the flagship
  forward (1024 points, width 144, depth 2, bf16), serves requests
  through ``Predictor``, checks the launch counters and the f32 forward
  against the CPU;
* training, on three ModelNet40 configs at full width and depth (5000
  points, batch 32; set here in code, so PyYAML is not needed):
  ``pospool_xyz_avg.yaml``, ``pospool_sincos_avg.yaml`` and
  ``adaptive_weight_dp_fc1_avg.yaml``. For each: checks its aggregation
  kernels (PosPool xyz, PosPool sin/cos, or the neighborhood moments)
  forward and backward against their plain versions at every call shape
  of the train step, in f32 and bf16 (for the xyz config also the ball
  query, FPS and the neighborhood max); holds an f32 train step through
  the kernels to one through the plain versions (same weights, batch and
  geometry) and checks that every parameter gets a gradient; trains bf16
  steps on one batch (the loss must fall) with exact per-step launch
  counts; ends with an eval step and timed ``Predictor`` requests at
  that config;
* times kernels, requests and train steps with CUDA events, and splits
  a request and a train step into device busy and idle time with
  torch.profiler.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it lists the kernels with their measured numbers, and
the one before that the card's name and power limit. Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

BATCH = 16
REQUESTS = 3
SEED = 0
DEVICE = "cuda"
TRAIN_STEPS = 15
# ModelNet40's training split has 9843 clouds: 307 steps of 32 per epoch
STEPS_PER_EPOCH = 9843 // 32

# H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM3 bytes/s, and
# float32 FLOP/s outside the tensor cores (none of these kernels uses
# them)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def flagship_config():
    """The flagship model of the JAX package's driver hooks, in code."""
    from closerlook3d_tpu_torch.utils.config import load_config

    cfg = load_config()
    cfg.local_aggregation_type = "pospool"
    cfg.task = "classification"
    cfg.num_points = 1024
    cfg.num_classes = 40
    cfg.width = 144
    cfg.depth = 2
    cfg.nsamples = [26, 31, 38, 41, 39]
    cfg.radius = 0.1
    cfg.batch_size = BATCH
    cfg.npoints = []
    cfg.precision = "bf16"
    return cfg


def slice_config():
    """``configs/modelnet40/pospool_xyz_avg.yaml``, set in code (a CPU
    test holds it equal to ``load_config`` of that file)."""
    from closerlook3d_tpu_torch.utils.config import load_config

    cfg = load_config()
    for key, value in dict(
            datasets="modelnet40", task="classification", num_points=5000,
            num_classes=40, batch_size=32, input_features="xyz", epochs=600,
            optimizer="sgd", base_learning_rate=0.002, lr_scheduler="cosine",
            warmup_epoch=5, weight_decay=0.001, momentum=0.9,
            label_smoothing=0.2, augment_rotation="z", augment_scale_min=0.8,
            augment_scale_max=1.2, augment_noise=0.001, width=144, depth=2,
            bottleneck_ratio=2, radius=0.05, sampling="fps",
            nsamples=[26, 31, 38, 41, 39],
            npoints=[5000, 1250, 312, 78, 19], dropout_rate=0.5,
            local_aggregation_type="pospool").items():
        cfg[key] = value
    cfg.pospool.position_embedding = "xyz"
    cfg.pospool.reduction = "avg"
    return cfg


def operator_config(kind: str):
    """``configs/modelnet40/pospool_sincos_avg.yaml`` (kind "sincos") or
    ``configs/modelnet40/adaptive_weight_dp_fc1_avg.yaml`` ("adaptive"),
    set in code; CPU tests hold each equal to its file."""
    cfg = slice_config()
    if kind == "sincos":
        cfg.pospool.position_embedding = "sin_cos"
    elif kind == "adaptive":
        cfg.local_aggregation_type = "adaptive_weight"
        cfg.adaptive_weight.local_input_feature = "dp"
        cfg.adaptive_weight.fc_num = 1
        cfg.adaptive_weight.reduction = "avg"
    else:
        raise ValueError(kind)
    return cfg


def make_batch(seed: int, padded=(), all_masked=(), duplicated=(),
               batch: int = BATCH, points: int = 1024):
    """Morton-sorted synthetic shape clouds, as the data loader feeds them.

    Clouds listed in ``padded`` keep their first 70% of points, those in
    ``all_masked`` none, and those in ``duplicated`` repeat their first
    10% of points right after them (exact distance ties).
    """
    from closerlook3d_tpu_torch.data.spatial_host import morton_sort_batch
    from closerlook3d_tpu_torch.data.synthetic import SyntheticClassification

    ds = SyntheticClassification(batch, points, num_classes=8, seed=seed)
    xyz = np.stack([ds[i]["xyz"] for i in range(batch)])
    mask = np.ones((batch, points), bool)
    keep, span = points * 7 // 10, points // 10
    for i in padded:
        mask[i, keep:] = False
    for i in all_masked:
        mask[i] = False
    for i in duplicated:
        xyz[i, span:2 * span] = xyz[i, :span]
    return morton_sort_batch({"xyz": xyz, "mask": mask,
                              "features": xyz.copy()})


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_wrappers():
    """{kernel name: its launching wrapper}, in the kernels line's order."""
    from closerlook3d_tpu_torch.ops import aggregation as agg
    from closerlook3d_tpu_torch.ops import moments as mom
    from closerlook3d_tpu_torch.ops.grouping import (
        neighborhood_max_bwd_cuda, neighborhood_max_cuda)
    from closerlook3d_tpu_torch.ops.neighbors import ball_query_cuda
    from closerlook3d_tpu_torch.ops.sampling import furthest_point_sample_cuda

    return {"ball_query": ball_query_cuda,
            "fps": furthest_point_sample_cuda,
            "pospool_xyz": agg.pospool_xyz_cuda,
            "pospool_xyz_bwd": agg.pospool_xyz_bwd_cuda,
            "neighborhood_max": neighborhood_max_cuda,
            "neighborhood_max_bwd": neighborhood_max_bwd_cuda,
            "pospool_sincos": agg.pospool_sincos_cuda,
            "pospool_sincos_bwd": agg.pospool_sincos_bwd_cuda,
            "moments": mom.neighborhood_moments_cuda,
            "moments_bwd": mom.neighborhood_moments_bwd_cuda}


# The training configs, by kind, and the aggregation kernel pair each one's
# LocalAggregation runs (14 calls per forward at depth 2).
TRAIN_KINDS = ("xyz", "sincos", "adaptive")
AGG_KERNELS = {"xyz": ("pospool_xyz", "pospool_xyz_bwd"),
               "sincos": ("pospool_sincos", "pospool_sincos_bwd"),
               "adaptive": ("moments", "moments_bwd")}


def train_config(kind: str):
    return slice_config() if kind == "xyz" else operator_config(kind)


def agg_ops(kind: str):
    """(forward kernel, its plain version, backward kernel, its plain twin,
    output channels per input channel) of a config's aggregation."""
    from closerlook3d_tpu_torch.ops import aggregation as agg
    from closerlook3d_tpu_torch.ops import moments as mom

    return {"xyz": (agg.pospool_xyz_cuda, agg.pospool_xyz_plain,
                    agg.pospool_xyz_bwd_cuda, agg.pospool_xyz_bwd_plain, 1),
            "sincos": (agg.pospool_sincos_cuda, agg.pospool_sincos_plain,
                       agg.pospool_sincos_bwd_cuda,
                       agg.pospool_sincos_bwd_plain, 1),
            "adaptive": (mom.neighborhood_moments_cuda,
                         mom.neighborhood_moments_plain,
                         mom.neighborhood_moments_bwd_cuda,
                         mom.neighborhood_moments_bwd_plain, 4)}[kind]


def launches_per(kind: str, train: bool) -> dict:
    """Exact launches of every kernel in one forward (``train`` False) or
    one train step of the ``kind`` config at depth 2."""
    counts = dict.fromkeys(kernel_wrappers(), 0)
    fwd, bwd = AGG_KERNELS[kind]
    counts.update({"ball_query": 9, "fps": 4, "neighborhood_max": 4,
                   fwd: 14})
    if train:
        counts.update({bwd: 14, "neighborhood_max_bwd": 4})
    return counts


def reset_counts(wrappers):
    for fn in wrappers.values():
        fn.launches = 0


def read_counts(wrappers) -> dict:
    return {k: fn.launches for k, fn in wrappers.items()}


def check_counts(what: str, counts: dict, expected: dict) -> None:
    """Raise unless every kernel launched exactly as expected."""
    bad = {k: (counts[k], n) for k, n in expected.items() if counts[k] != n}
    if bad:
        raise AssertionError(f"{what}: launches (got, expected) {bad}")


@contextlib.contextmanager
def plain_route():
    """CUDA tensors take the plain PyTorch versions: only for the runs
    that the kernels are compared with."""
    from closerlook3d_tpu_torch.ops import (
        aggregation, grouping, moments, neighbors, sampling)

    mods = (aggregation, grouping, moments, neighbors, sampling)
    saved = [m.use_kernel for m in mods]
    for m in mods:
        m.use_kernel = lambda t: False
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.use_kernel = fn


# ---- device and build ----------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke run needs the "
                           "GPU and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = gpu_line()
    log("device", f"{line} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    return {"nvidia_smi": line, "torch": torch.__version__,
            "cuda": torch.version.cuda}


SOURCES = ("ball_query", "fps", "pospool_xyz", "neighborhood_max",
           "pospool_sincos", "moments")


def phase_build() -> dict:
    from closerlook3d_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    libs = kernels.build_all(SOURCES)
    out = {"seconds_all": time.perf_counter() - t0}
    for name, lib in libs.items():
        kernels.load(name)
        with open(lib + ".ptxas.txt") as f:
            usage = [ln.split("ptxas info    :")[-1].strip()
                     for ln in f if "Used" in ln]
        log("build", f"{name}: " + " | ".join(usage))
        out[name] = {"ptxas": usage}
    log("build", f"{len(libs)} sources built in parallel in "
        f"{out['seconds_all']:.2f} s")
    return out


# ---- the forward's calls --------------------------------------------------

def path_calls(cfg, xyz, mask):
    """The geometry calls of one forward, driven through the kernels.

    Returns (ball-query calls, FPS calls, PosPool calls): the inputs each
    kernel gets on the main path, with the number of times per forward.
    """
    from closerlook3d_tpu_torch.ops.neighbors import ball_query_cuda
    from closerlook3d_tpu_torch.ops.sampling import furthest_point_sample_cuda
    from closerlook3d_tpu_torch.utils.config import stage_plan

    plan = stage_plan(cfg)
    npoints, radii, ks, widths = (plan["npoints"], plan["radii"],
                                  plan["nsamples"], plan["widths"])
    bq, fps, pp = [], [], []
    args = (xyz, xyz, radii[0], ks[0], mask, mask)
    idx, nmask = ball_query_cuda(*args)
    bq.append(("s0", args))
    pp.append(("s0", (xyz, xyz, idx, nmask, radii[0]), widths[0] // 2, 2))
    prev, pmask = xyz, mask
    for s in range(1, len(ks)):
        fps.append((f"s{s}", (prev, npoints[s], pmask)))
        fidx, new_mask = furthest_point_sample_cuda(prev, npoints[s], pmask)
        new = torch.gather(prev, 1, fidx.long()[..., None].expand(-1, -1, 3))
        sargs = (new, prev, radii[s - 1] * 2.0, ks[s - 1], new_mask, pmask)
        rargs = (new, new, radii[s], ks[s], new_mask, new_mask)
        sidx, smask = ball_query_cuda(*sargs)
        ridx, rmask = ball_query_cuda(*rargs)
        bq += [(f"s{s}-strided", sargs), (f"s{s}", rargs)]
        pp.append((f"s{s}-strided", (new, prev, sidx, smask,
                                     radii[s - 1] * 2.0), widths[s] // 2, 1))
        pp.append((f"s{s}", (new, new, ridx, rmask, radii[s]),
                   widths[s] // 2, cfg.depth))
        prev, pmask = new, new_mask
    return bq, fps, pp


def max_calls(cfg, pp):
    """The strided shortcuts' neighborhood-max calls of one forward, from
    ``path_calls``' PosPool calls: (name, (support xyz, idx, mask), C)."""
    from closerlook3d_tpu_torch.utils.config import stage_plan

    widths = stage_plan(cfg)["widths"]
    return [(name, (s, idx, nmask), widths[int(name[1]) - 1])
            for name, (_, s, idx, nmask, _), _, _ in pp
            if name.endswith("-strided")]


def _features(gen, s, c, dtype):
    return torch.randn((s.shape[0], s.shape[1], c), generator=gen,
                       device=s.device).to(dtype)


def _tie_features(gen, s, c, dtype):
    """Post-ReLU features on a 0.25 grid, a function of the point's
    position: exact ties, and duplicated points carry equal rows."""
    w = torch.randn((3, c), generator=gen, device=s.device)
    return torch.relu(torch.round(4 * (s @ w)) / 4).to(dtype)


# ---- serving parity (flagship) --------------------------------------------

def _idx_err(what, got, ref) -> float:
    """Max abs difference of the (idx, mask) pairs; raise unless 0."""
    (ki, km), (pi, pm) = got, ref
    torch.cuda.synchronize()
    err = float(max((ki.long() - pi.long()).abs().max(),
                    (km.long() - pm.long()).abs().max()))
    if err or not (torch.equal(ki, pi) and torch.equal(km, pm)):
        bad = (ki != pi) | (km != pm)
        raise AssertionError(
            f"{what}: kernel and plain disagree at {int(bad.sum())} slots, "
            f"first {bad.nonzero()[:4].tolist()}")
    return err


def _max_err(what, got, ref) -> float:
    """Max abs difference of two neighborhood maxima; raise unless equal
    (max is exact in any dtype)."""
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    if err or not torch.equal(got, ref):
        raise AssertionError(f"{what}: kernel and plain differ (max abs err "
                             f"{err:.3g})")
    return err


def _geometry_parity(bq, fps) -> dict:
    """Ball query and FPS vs their plain versions; {kernel: max abs err}."""
    from closerlook3d_tpu_torch.ops.neighbors import (
        ball_query_cuda, ball_query_plain)
    from closerlook3d_tpu_torch.ops.sampling import (
        furthest_point_sample_cuda, furthest_point_sample_plain)

    errs = {"ball_query": 0.0, "fps": 0.0}
    for name, a in bq:
        got = ball_query_cuda(*a)
        errs["ball_query"] = max(errs["ball_query"], _idx_err(
            f"ball_query {name}", got, ball_query_plain(*a)))
        log("parity", f"ball_query {name} q{tuple(a[0].shape)} "
            f"s{tuple(a[1].shape)} r={a[2]:g} K={a[3]}: idx and mask equal "
            f"({int(got[1].sum())} valid slots)")
    for name, a in fps:
        errs["fps"] = max(errs["fps"], _idx_err(
            f"fps {name}", furthest_point_sample_cuda(*a),
            furthest_point_sample_plain(*a)))
        log("parity", f"fps {name} {tuple(a[0].shape)} -> {a[1]}: "
            f"idx and mask equal")
    return errs


def _pospool_fwd_tol(dtype, red, kind="xyz"):
    if dtype == torch.float32:
        # same f32 products; only the order of the neighbor sum differs.
        # A sum of up to 41 terms carries more absolute rounding than an
        # average of them.
        return (dict(rtol=1e-5, atol=1e-6) if red == "avg"
                else dict(rtol=1e-5, atol=1e-5))
    # the plain path rounds every product and the sum to bf16 (8 mantissa
    # bits); the kernel keeps f32 and rounds once: a few bf16 ulps. The
    # sin/cos factors are O(1) where dp mostly is not, so a sum of up to
    # 41 of its rounded products drifts further (as
    # tests/test_torch_cuda.py allows)
    if kind == "sincos" and red == "sum":
        return dict(rtol=2e-2, atol=6e-2)
    return dict(rtol=2e-2, atol=2e-2)


def phase_kernel_parity(cfg) -> dict:
    """Kernel vs plain version at every shape of the flagship forward;
    {kernel: max abs err}."""
    from closerlook3d_tpu_torch.ops.aggregation import (
        pospool_xyz_cuda, pospool_xyz_plain)
    from closerlook3d_tpu_torch.ops.grouping import (
        neighborhood_max_cuda, neighborhood_max_plain)

    dev = torch.device(DEVICE)
    b = make_batch(SEED + 100, padded=(BATCH - 4,), all_masked=(BATCH - 3,),
                   duplicated=(BATCH - 2, BATCH - 1))
    xyz = torch.from_numpy(b["xyz"]).to(dev)
    mask = torch.from_numpy(b["mask"]).to(dev)
    bq, fps, pp = path_calls(cfg, xyz, mask)
    errs = dict(_geometry_parity(bq, fps), pospool_xyz=0.0,
                neighborhood_max=0.0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for name, (q, s, idx, nmask, r), c, _ in pp:
        for dtype in (torch.float32, torch.bfloat16):
            f = _features(gen, s, c, dtype)
            for red in ("avg", "sum"):
                got = pospool_xyz_cuda(q, s, f, idx, nmask, r, red).float()
                ref = pospool_xyz_plain(q, s, f, idx, nmask, r, red).float()
                torch.cuda.synchronize()
                tol = _pospool_fwd_tol(dtype, red)
                torch.testing.assert_close(got, ref, **tol)
                err = float((got - ref).abs().max())
                errs["pospool_xyz"] = max(errs["pospool_xyz"], err)
                log("parity", f"pospool_xyz {name} C={c} K={idx.shape[2]} "
                    f"{str(dtype)[6:]} {red}: max abs err {err:.3g} "
                    f"(tol {tol})")
    for name, (s, idx, nmask), c in max_calls(cfg, pp):
        for dtype in (torch.float32, torch.bfloat16):
            for kind, make in (("ties", _tie_features),
                               ("distinct", _features)):
                f = make(gen, s, c, dtype)
                what = (f"neighborhood_max {name} s{tuple(s.shape)} C={c} "
                        f"K={idx.shape[2]} {str(dtype)[6:]} {kind}")
                err = _max_err(what, neighborhood_max_cuda(f, idx, nmask),
                               neighborhood_max_plain(f, idx, nmask))
                errs["neighborhood_max"] = max(errs["neighborhood_max"], err)
                log("parity", f"{what}: equal ({int(nmask.sum())} valid "
                    f"slots)")
    return errs


# ---- serving ----------------------------------------------------------------

def seeded_weights(cfg, gen: torch.Generator) -> dict:
    """Random weights from a seed, with non-trivial BatchNorm state."""
    from closerlook3d_tpu_torch.models import build_model
    from closerlook3d_tpu_torch.models.nn_utils import BatchNorm

    model = build_model(cfg, generator=gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.weight.shape
                mod.weight.copy_(torch.rand(n, generator=gen) * 0.5 + 0.75)
                mod.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                mod.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model.state_dict()


def phase_serving(cfg, weights, wrappers) -> dict:
    from closerlook3d_tpu_torch.serving import Predictor

    predictor = Predictor(cfg, weights, device=DEVICE)
    # the second request holds padded clouds
    batches = [make_batch(SEED + 1 + r,
                          padded=(1, BATCH - 1) if r == 1 else ())
               for r in range(REQUESTS)]
    reset_counts(wrappers)
    outs = [predictor(bt["xyz"], bt["mask"], bt["features"])
            for bt in batches]
    torch.cuda.synchronize()
    counts = read_counts(wrappers)
    for out in outs:
        if tuple(out.shape) != (BATCH, cfg.num_classes):
            raise AssertionError(f"logits shape {tuple(out.shape)}")
        if out.dtype != torch.float32 or not torch.isfinite(out).all():
            raise AssertionError("logits not finite f32")
    check_counts(f"serving, {REQUESTS} requests", counts,
                 {k: n * REQUESTS
                  for k, n in launches_per("xyz", False).items()})
    log("serving", f"{REQUESTS} requests of {BATCH} clouds answered; logits "
        f"{tuple(outs[0].shape)} finite; launches {counts}")
    return {"predictor": predictor, "batches": batches, "launches": counts}


def phase_forward_parity(cfg, weights, batch) -> dict:
    """f32 forward on the card (kernels) vs on the CPU (plain versions)."""
    from closerlook3d_tpu_torch.models.backbone import compute_geometry
    from closerlook3d_tpu_torch.serving import Predictor

    cfg32 = copy.deepcopy(cfg)
    cfg32.precision = "f32"
    gpu = Predictor(cfg32, weights, device=DEVICE)
    cpu = Predictor(cfg32, weights, device="cpu")
    with torch.inference_mode():
        gg = compute_geometry(cfg32, torch.from_numpy(batch["xyz"]).to(DEVICE),
                              torch.from_numpy(batch["mask"]).to(DEVICE))
        cg = compute_geometry(cfg32, torch.from_numpy(batch["xyz"]),
                              torch.from_numpy(batch["mask"]))
    for k in cg:
        if not torch.equal(gg[k].cpu(), cg[k]):
            raise AssertionError(f"geometry {k}: card and CPU differ")
    lg = gpu(batch["xyz"], batch["mask"], batch["features"]).cpu()
    lc = cpu(batch["xyz"], batch["mask"], batch["features"])
    # f32 throughout (TF32 off); cuBLAS/ATen-CUDA and the CPU sum matmuls,
    # BN and PosPool neighborhoods in different orders through 15 blocks
    torch.testing.assert_close(lg, lc, rtol=1e-3, atol=1e-4)
    err = float((lg - lc).abs().max())
    log("forward", f"f32 logits card vs CPU plain: max abs err {err:.3g} "
        f"(|logits| max {float(lc.abs().max()):.3g}); geometry "
        f"({len(cg)} tensors) equal")
    return {"max_abs_err": err, "geometry_tensors": len(cg)}


# ---- training: kernels forward and backward at the slice's shapes ----------

def _vjp(fn, x, dy):
    """(fn(x), d<fn(x), dy>/dx) under autograd."""
    x = x.detach().requires_grad_(True)
    out = fn(x)
    (grad,) = torch.autograd.grad(out, x, dy)
    return out.detach(), grad


def _bwd_tol(dtype, red, kind="xyz"):
    """Backward kernel vs its plain twin, elementwise."""
    if dtype == torch.float32:
        # the same f32 terms summed in another order (atomics); sums of
        # up to ~40 terms carry more rounding than averages, and a moments
        # slot's term (g0 + sum_d g_d dp_d) is up to 4x a PosPool one
        if red == "avg":
            return dict(rtol=1e-5, atol=1e-6)
        return dict(rtol=1e-5, atol=4e-5 if kind == "adaptive" else 1e-5)
    # both sum in f32 and round once: one bf16 ulp where the two orders
    # straddle a rounding boundary
    return dict(rtol=8e-3, atol=1e-5)


def _vs_autograd(what, got, ref, dtype, red, kind="xyz"):
    """Backward kernel vs autograd of the plain forward; (max abs err,
    relative L2 gap). f32: elementwise, as against the twin. bf16: CUDA's
    autograd rounds every product and every atomic partial sum of its
    scatter to bf16, up to half an ulp of partials of ~8 (0.03) each, so
    its elementwise gap grows with the shares a row collects; the L2 gap
    stays within a few bf16 epsilons (2^-8 = 0.0039)."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    rel = float((got - ref).norm() / ref.norm().clamp(min=1e-30))
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, **_bwd_tol(dtype, red, kind),
                                   msg=lambda m: f"{what}: {m}")
    elif rel > 2e-2:
        raise AssertionError(f"{what}: relative L2 gap {rel:.3g} to the "
                             f"autograd of the plain version")
    return err, rel


def _max_dp(q, s, idx, nmask, r) -> float:
    """Largest |dp| component over the valid slots of one call."""
    from closerlook3d_tpu_torch.ops.grouping import neighbor_offsets

    dp = neighbor_offsets(q, s, idx, r, torch.float32).abs().amax(-1)
    return float((dp * nmask).max())


def phase_train_kernel_parity(tcfg, kind: str) -> dict:
    """The train step's kernels vs their plain versions, forward and
    backward, f32 and bf16, at every call shape of the config: its
    aggregation pair, and for the xyz config also the geometry kernels
    and the neighborhood max (whose calls the three configs share)."""
    from closerlook3d_tpu_torch.ops.grouping import (
        neighborhood_max_bwd_cuda, neighborhood_max_bwd_plain,
        neighborhood_max_cuda, neighborhood_max_plain)

    dev = torch.device(DEVICE)
    nb = tcfg.batch_size
    b = make_batch(SEED + 300, padded=(nb - 4,), all_masked=(nb - 3,),
                   duplicated=(nb - 2, nb - 1), batch=nb,
                   points=tcfg.num_points)
    xyz = torch.from_numpy(b["xyz"]).to(dev)
    mask = torch.from_numpy(b["mask"]).to(dev)
    bq, fps, pp = path_calls(tcfg, xyz, mask)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    fwd_name, bwd_name = AGG_KERNELS[kind]
    fwd, plain, bwd, twin, widen = agg_ops(kind)
    errs = {fwd_name: 0.0, bwd_name: 0.0}
    if kind == "xyz":
        errs.update(_geometry_parity(bq, fps), neighborhood_max=0.0,
                    neighborhood_max_bwd=0.0)
    phase = f"train-parity:{kind}"

    def note(key, what, got, ref, tol):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), **tol,
                                   msg=lambda m: f"{what}: {m}")
        err = float((got.float() - ref.float()).abs().max())
        errs[key] = max(errs[key], err)
        return err

    max_dp = 0.0
    for name, (q, s, idx, nmask, r), c, _ in pp:
        dpm = _max_dp(q, s, idx, nmask, r)
        max_dp = max(max_dp, dpm)
        for dtype in (torch.float32, torch.bfloat16):
            f = _features(gen, s, c, dtype)
            dy = _features(gen, q, c * widen, dtype)
            for red in ("avg", "sum"):
                what = (f"{fwd_name} {name} C={c} K={idx.shape[2]} "
                        f"{str(dtype)[6:]} {red}")
                tol_f = _pospool_fwd_tol(dtype, red, kind)
                tol_b = _bwd_tol(dtype, red, kind)
                e_f = note(fwd_name, what,
                           fwd(q, s, f, idx, nmask, r, red),
                           plain(q, s, f, idx, nmask, r, red), tol_f)
                got = bwd(q, s, idx, nmask, dy, r, red)
                e_t = note(bwd_name, what + " bwd vs twin", got,
                           twin(q, s, idx, nmask, dy, r, red), tol_b)
                _, ref = _vjp(lambda x: plain(q, s, x, idx, nmask, r, red),
                              f, dy)
                e_a, rel = _vs_autograd(what, got, ref, dtype, red, kind)
                log(phase, f"{what}: max |dp| {dpm:.3f}; max abs err fwd "
                    f"{e_f:.3g} (tol {tol_f}), bwd vs twin {e_t:.3g} (tol "
                    f"{tol_b}), vs autograd {e_a:.3g} (L2 {rel:.2g}; "
                    + ("tol as vs twin" if dtype == torch.float32
                       else "L2 bound 0.02") + ")")
    # the sin/cos embedding's top frequency turns |dp| ~ 1 into ~100 rad
    if not max_dp > 0.9:
        raise AssertionError(f"neighborhoods reach only |dp| {max_dp:.3f}")
    errs["max_dp"] = max_dp
    if kind != "xyz":
        return errs
    for name, (s, idx, nmask), c in max_calls(tcfg, pp):
        for dtype in (torch.float32, torch.bfloat16):
            for values, make in (("ties", _tie_features),
                                 ("distinct", _features)):
                f = make(gen, s, c, dtype)
                out = neighborhood_max_cuda(f, idx, nmask)
                dy = _features(gen, out, c, dtype)
                ref, ref_grad = _vjp(lambda x: neighborhood_max_plain(
                    x, idx, nmask), f, dy)
                what = (f"neighborhood_max {name} C={c} K={idx.shape[2]} "
                        f"{str(dtype)[6:]} {values}")
                errs["neighborhood_max"] = max(errs["neighborhood_max"],
                                               _max_err(what, out, ref))
                got = neighborhood_max_bwd_cuda(f, idx, nmask, out, dy)
                e_t = note("neighborhood_max_bwd", what + " bwd vs twin",
                           got, neighborhood_max_bwd_plain(f, idx, nmask, out,
                                                           dy),
                           _bwd_tol(dtype, "sum"))
                # dy / n is rounded alike; only the sums over the queries
                # that share a winning row differ
                e_a, rel = _vs_autograd(what, got, ref_grad, dtype, "sum")
                log(phase, f"{what}: fwd equal; max abs err bwd vs twin "
                    f"{e_t:.3g}, vs autograd {e_a:.3g} (L2 {rel:.2g})")
    return errs


# ---- training: one step, kernels vs plain; then training -------------------

def train_batch(tcfg, seed: int) -> dict:
    """One batch of the slice, as the data loader yields it."""
    from closerlook3d_tpu_torch.data.loader import BatchIterator
    from closerlook3d_tpu_torch.data.synthetic import SyntheticClassification

    ds = SyntheticClassification(tcfg.batch_size, tcfg.num_points,
                                 num_classes=8, seed=seed)
    return next(iter(BatchIterator(
        ds, tcfg.batch_size, shuffle=True, feature_spec=tcfg.input_features,
        seed=seed, spatial_sort=tcfg.spatial_sort == "host")))


def phase_train_step_parity(tcfg, wrappers, kind: str) -> dict:
    """One f32 train step through the kernels vs one through the plain
    versions on the card: same weights, batch and geometry."""
    from closerlook3d_tpu_torch.models import build_classification
    from closerlook3d_tpu_torch.models.backbone import compute_geometry
    from closerlook3d_tpu_torch.train import (
        create_train_state, make_optimizer, make_train_step)

    cfg = copy.deepcopy(tcfg)
    cfg.precision = "f32"
    cfg.dropout_rate = 0.0
    batch = train_batch(cfg, SEED + 400)
    batch["mask"][1, cfg.num_points * 7 // 10:] = False  # a padded cloud
    dev = torch.device(DEVICE)
    with torch.no_grad():  # once, through the kernels, for both steps
        geometry = compute_geometry(cfg,
                                    torch.from_numpy(batch["xyz"]).to(dev),
                                    torch.from_numpy(batch["mask"]).to(dev))
    batch.update({f"geom_{k}": v for k, v in geometry.items()})
    model, loss_fn = build_classification(cfg)
    step = make_train_step(loss_fn, cfg.task)
    runs = {}
    for route in ("kernel", "plain"):
        tx, _ = make_optimizer(cfg, STEPS_PER_EPOCH)
        state = create_train_state(copy.deepcopy(model), tx, device=DEVICE)
        reset_counts(wrappers)
        with (plain_route() if route == "plain"
              else contextlib.nullcontext()):
            state, metrics = step(state, batch, SEED)
        torch.cuda.synchronize()
        runs[route] = (state.model, float(metrics["loss"]),
                       read_counts(wrappers))
    (km, kloss, kcounts), (pm, ploss, pcounts) = runs["kernel"], runs["plain"]
    check_counts("kernel train step (geometry given)", kcounts,
                 dict(launches_per(kind, True), ball_query=0, fps=0))
    check_counts("plain train step", pcounts, dict.fromkeys(wrappers, 0))
    # f32 throughout (TF32 off); the kernels sum neighborhoods in slot
    # order and scatter with atomics where the plain path sums by ATen's
    # reductions and index scatter
    if abs(kloss - ploss) > 1e-5 * abs(ploss):
        raise AssertionError(f"train-step loss: kernel {kloss}, plain {ploss}")
    pgrads = dict(pm.named_parameters())
    gaps = {}
    for name, p in km.named_parameters():
        if not float(p.grad.abs().sum()) > 0:
            raise AssertionError(f"{name}: no gradient through the kernels")
        ref = pgrads[name].grad
        gaps[name] = float((p.grad - ref).norm() / ref.norm())
    # Forward rounding differences (~1e-6 relative by the last block) flip
    # the odd ReLU whose input is within an ulp of 0; with the global
    # average pool over 19 points per cloud each flipped element carries
    # a large gradient, and the flip moves every gradient before it by
    # tenths of a percent (relative L2). A wrong rule or scale gives gaps
    # of order 1.
    bad = {k: v for k, v in gaps.items() if v > 2e-2}
    if bad:
        raise AssertionError(f"gradients differ (relative L2, kernel vs "
                             f"plain): {bad}")
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    pstate = pm.state_dict()
    for name, t in km.state_dict().items():
        # params moved by lr * grad (lr 2e-5 at step 0 of the warmup);
        # running stats are f32 moments of activations that differ by
        # reordering
        torch.testing.assert_close(t, pstate[name], rtol=1e-4, atol=1e-5,
                                   msg=lambda m, n=name: f"{n}: {m}")
    n = len(gaps)
    median = sorted(gaps.values())[n // 2]
    log(f"train-parity:{kind}", f"f32 step kernels vs plain: loss "
        f"{kloss:.6f} vs "
        f"{ploss:.6f}; all {n} parameters have a nonzero gradient; "
        f"relative L2 gradient gap median {median:.3g}, worst "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst)
        + f"; updated params and running stats agree; launches {kcounts}")
    return {"loss_kernel": kloss, "loss_plain": ploss,
            "grad_rel_l2": gaps, "grad_rel_l2_median": median,
            "params": n, "launches": kcounts}


def phase_training(tcfg, wrappers, kind: str) -> dict:
    """TRAIN_STEPS bf16 steps of the config on one batch, warmup off at
    the config's base LR; then an eval step and Predictor requests, the
    first checked against the eval step, the next timed."""
    from closerlook3d_tpu_torch.models import build_classification
    from closerlook3d_tpu_torch.serving import Predictor
    from closerlook3d_tpu_torch.train import (
        create_train_state, make_eval_step, make_optimizer, make_train_step)

    cfg = copy.deepcopy(tcfg)
    cfg.warmup_epoch = 0
    model, loss_fn = build_classification(cfg)
    tx, lr = make_optimizer(cfg, STEPS_PER_EPOCH)
    state = create_train_state(model, tx, device=DEVICE)
    step = make_train_step(loss_fn, cfg.task)
    batch = train_batch(cfg, SEED + 500)
    per_step = launches_per(kind, True)
    totals = dict.fromkeys(wrappers, 0)
    losses, accs, step_ms, host_ms = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_counts(wrappers)
        t0 = time.perf_counter()
        start.record()
        state, metrics = step(state, batch, SEED)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(wrappers)
        check_counts(f"train step {i}", counts, per_step)
        for k in totals:
            totals[k] += counts[k]
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["acc"]))
        gnorm = torch.stack([p.grad.float().norm()
                             for p in state.model.parameters()])
        if not (np.isfinite(losses[-1]) and torch.isfinite(gnorm).all()):
            raise AssertionError(f"step {i}: loss {losses[-1]} or a "
                                 f"gradient is not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f"the loss did not fall over {TRAIN_STEPS} "
                             f"steps: {losses}")
    phase = f"training:{kind}"
    log(phase, f"{TRAIN_STEPS} bf16 steps, batch {cfg.batch_size} x "
        f"{cfg.num_points} points, lr {lr(0):g}: loss "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; acc {accs[-1]:.3f}; launches per step "
        + str({k: n for k, n in per_step.items() if n})
        + f"; peak memory {peak:.2f} GiB")

    per_forward = launches_per(kind, False)
    reset_counts(wrappers)
    logits, emetrics = make_eval_step(loss_fn, cfg.task)(state, batch)
    torch.cuda.synchronize()
    check_counts("eval step", read_counts(wrappers), per_forward)
    if (tuple(logits.shape) != (cfg.batch_size, cfg.num_classes)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"eval logits {tuple(logits.shape)} not finite")
    predictor = Predictor(cfg, state.model.state_dict(), device=DEVICE)
    reset_counts(wrappers)
    served = predictor(batch["xyz"], batch["mask"], batch["features"])
    torch.cuda.synchronize()
    check_counts("Predictor at the config", read_counts(wrappers),
                 per_forward)
    # the same eval-mode bf16 forward through the same kernels
    torch.testing.assert_close(served, logits, rtol=1e-2, atol=1e-2)
    lat = _request_latencies(predictor, [batch], 10)
    med = lat[len(lat) // 2]
    log(phase, f"eval step: loss {float(emetrics['loss']):.4f} acc "
        f"{float(emetrics['acc']):.3f}; Predictor served the "
        f"{cfg.num_points}-point config, logits {tuple(served.shape)} "
        f"equal to the eval step's; request (batch {cfg.batch_size} x "
        f"{cfg.num_points} points, bf16, host clock incl. input copy) "
        f"median {med:.3f} ms over 10, min {lat[0]:.3f}, max {lat[-1]:.3f}")
    return {"state": state, "step": step, "batch": batch, "losses": losses,
            "accs": accs, "step_ms": step_ms, "host_ms": host_ms,
            "launches": totals, "peak_gib": peak,
            "request_ms_median": med, "request_ms_all": lat,
            "eval": {"loss": float(emetrics["loss"]),
                     "acc": float(emetrics["acc"])}}


# ---- timing -----------------------------------------------------------------

def _time(fn, inputs, reps: int) -> float:
    """Mean ms per call over ``reps`` calls cycling through ``inputs``."""
    for a in inputs:  # warm-up
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _request_latencies(predictor, batches, n: int) -> list:
    """Sorted host-clock ms of ``n`` requests cycling over ``batches``
    (numpy, as a caller sends them), each ending in a synchronize, after
    one warm-up request per batch."""
    for bt in batches:
        predictor(bt["xyz"], bt["mask"], bt["features"])
    torch.cuda.synchronize()
    lat = []
    for i in range(n):
        bt = batches[i % len(batches)]
        t0 = time.perf_counter()
        predictor(bt["xyz"], bt["mask"], bt["features"])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return sorted(lat)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _busy_us(prof) -> float:
    """Union of device kernel intervals (us) in the trace."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _profiled(fn, n: int, unprofiled_ms: float):
    """Run ``fn`` ``n`` times under torch.profiler: (the profiler, split).

    ``device_idle_share`` is 1 - busy / wall of the profiled run, whose
    wall the profiler stretches; ``device_idle_share_est`` reads the same
    busy time against the unprofiled median ``unprofiled_ms``, an
    estimate.
    """
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    busy_ms = _busy_us(prof) / n / 1e3
    return prof, {"wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
                  "device_idle_share": 1 - busy_ms / wall_ms,
                  "device_idle_share_est": 1 - busy_ms / unprofiled_ms}


def phase_timing(cfg, serving) -> dict:
    """Serving: the forward's geometry and PosPool kernels per flagship
    forward against their plain versions, and request latency."""
    from closerlook3d_tpu_torch.ops.aggregation import (
        pospool_xyz_cuda, pospool_xyz_plain)
    from closerlook3d_tpu_torch.ops.neighbors import (
        ball_query_cuda, ball_query_plain)
    from closerlook3d_tpu_torch.ops.sampling import (
        furthest_point_sample_cuda, furthest_point_sample_plain)

    dev = torch.device(DEVICE)
    sets = []
    for r in range(3):  # distinct inputs per launch
        b = make_batch(SEED + 200 + r)
        sets.append(path_calls(cfg, torch.from_numpy(b["xyz"]).to(dev),
                               torch.from_numpy(b["mask"]).to(dev)))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = {}

    def add(kernel, name, count, ms, plain_ms):
        rows.setdefault(kernel, []).append(
            {"call": name, "per_forward": count, "ms": ms,
             "plain_ms": plain_ms})
        log("timing", f"{kernel} {name} x{count}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")

    for i, (name, _) in enumerate(sets[0][0]):
        ins = [s[0][i][1] for s in sets]
        add("ball_query", name, 1, _time(ball_query_cuda, ins, 30),
            _time(ball_query_plain, ins, 6))
    for i, (name, _) in enumerate(sets[0][1]):
        ins = [s[1][i][1] for s in sets]
        add("fps", name, 1, _time(furthest_point_sample_cuda, ins, 30),
            _time(furthest_point_sample_plain, ins, 3))
    for i, (name, _, c, count) in enumerate(sets[0][2]):
        ins = []
        for s in sets:
            q, sx, idx, nmask, r = s[2][i][1]
            f = _features(gen, sx, c, torch.bfloat16)
            ins.append((q, sx, f, idx, nmask, r, "avg"))
        add("pospool_xyz", name, count, _time(pospool_xyz_cuda, ins, 30),
            _time(pospool_xyz_plain, ins, 6))

    totals = {k: {"ms": sum(r["ms"] * r["per_forward"] for r in v),
                  "plain_ms": sum(r["plain_ms"] * r["per_forward"]
                                  for r in v)}
              for k, v in rows.items()}

    predictor, batches = serving["predictor"], serving["batches"]
    lat = _request_latencies(predictor, batches, 10)
    med = lat[len(lat) // 2]
    bt = batches[0]
    _, split = _profiled(
        lambda: predictor(bt["xyz"], bt["mask"], bt["features"]), 5, med)
    request = {"latency_ms_median": med, "latency_ms_all": lat,
               "points_per_s": BATCH * cfg.num_points / (med / 1e3),
               "split": split}
    log("timing", f"request (batch {BATCH} x {cfg.num_points} points, bf16, "
        f"host clock incl. input copy): median {med:.3f} ms over 10, "
        f"min {lat[0]:.3f}, max {lat[-1]:.3f}; "
        f"{request['points_per_s']:.0f} points/s")
    log("timing", f"profiled 5 requests: wall {split['wall_ms_profiled']:.3f}"
        f" ms/request, device busy {split['device_busy_ms']:.3f} ms/request "
        f"(idle {100 * split['device_idle_share']:.1f}% of the profiled "
        f"wall; {100 * split['device_idle_share_est']:.1f}% of the "
        f"unprofiled median, an estimate)")
    for k, t in totals.items():
        log("timing", f"{k} per forward: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms")
    return {"per_call": rows, "per_forward": totals, "request": request}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, flops: float):
    """(least ms on the H100, what bounds it): bytes moved once over the
    HBM rate vs f32 operations over the non-tensor-core f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _agg_flops_per_slot(kind: str, c: int) -> int:
    """f32 operations per valid slot of one aggregation call (forward or
    backward alike) with C input channels: D (3 subtractions and 3
    divisions), then per channel a multiply-add (xyz, sin/cos), or one
    add and three multiply-adds (moments; the backward's three
    multiply-adds and its atomic add). Sin/cos adds per (coordinate,
    frequency) pair the angle's multiply and divide and one operation
    each for sin and cos."""
    return {"xyz": 6 + 2 * c, "sincos": 6 + 2 * c + 4 * (c // 2),
            "adaptive": 6 + 7 * c}[kind]


def _kernel_cases(tcfg, calls, gen, kind: str):
    """{kernel: [(call name, per step, kernel fn, plain fn, inputs per
    input set, (bytes, flops) of the first set)]} for one train step of
    the ``kind`` config: its aggregation pair, and for the xyz config the
    geometry kernels and the neighborhood max too."""
    from closerlook3d_tpu_torch.ops import grouping as grp
    from closerlook3d_tpu_torch.ops import neighbors as nbr
    from closerlook3d_tpu_torch.ops import sampling as smp
    from closerlook3d_tpu_torch.ops.aggregation import sincos_freq

    bf = torch.bfloat16
    fwd_name, bwd_name = AGG_KERNELS[kind]
    fwd_fn, plain_fn, bwd_fn, twin_fn, widen = agg_ops(kind)
    cases = {fwd_name: [], bwd_name: []}
    for i, (name, _, c, count) in enumerate(calls[0][2]):
        fwd, bwd = [], []
        for cs in calls:
            q, s, idx, nmask, r = cs[2][i][1]
            f = _features(gen, s, c, bf)
            dy = _features(gen, q, c * widen, bf)
            fwd.append((q, s, f, idx, nmask, r, "avg"))
            bwd.append((q, s, idx, nmask, dy, r, "avg"))
        q, s, f, idx, nmask = fwd[0][:5]
        dy = bwd[0][4]
        # bytes: inputs read once, the output written once (dy has the
        # forward output's size, f the backward's; sin/cos also reads its
        # frequency table); flops: _agg_flops_per_slot per valid slot
        flops = float(nmask.sum()) * _agg_flops_per_slot(kind, c)
        table = (_nbytes(sincos_freq(c, q.device)) if kind == "sincos"
                 else 0)
        cases[fwd_name].append((
            name, count, fwd_fn, plain_fn, fwd,
            (_nbytes(q, s, f, idx, nmask, dy) + table, flops)))
        cases[bwd_name].append((
            name, count, bwd_fn, twin_fn, bwd,
            (_nbytes(q, s, idx, nmask, dy, f) + table, flops)))
    if kind != "xyz":
        return cases
    cases.update({k: [] for k in ("ball_query", "fps", "neighborhood_max",
                                  "neighborhood_max_bwd")})
    for i, (name, a) in enumerate(calls[0][0]):
        q, s, _, k, qm, sm = a
        b, nq = q.shape[:2]
        valid_pairs = float((qm.sum(1) * sm.sum(1)).sum())
        cases["ball_query"].append((
            name, 1, nbr.ball_query_cuda, nbr.ball_query_plain,
            [c[0][i][1] for c in calls],
            (_nbytes(q, s, qm, sm) + b * nq * k * 5, 8 * valid_pairs)))
    for i, (name, a) in enumerate(calls[0][1]):
        xyz, npoint, m = a
        cases["fps"].append((
            name, 1, smp.furthest_point_sample_cuda,
            smp.furthest_point_sample_plain, [c[1][i][1] for c in calls],
            (_nbytes(xyz, m) + xyz.shape[0] * npoint * 5,
             9.0 * npoint * float(m.sum()))))
    per_set = [max_calls(tcfg, cs[2]) for cs in calls]
    for j, (name, _, c) in enumerate(per_set[0]):
        fwd, bwd = [], []
        for mc in per_set:
            s, idx, nmask = mc[j][1]
            f = _tie_features(gen, s, c, bf)
            out = grp.neighborhood_max_cuda(f, idx, nmask)
            fwd.append((f, idx, nmask))
            bwd.append((f, idx, nmask, out, _features(gen, out, c, bf)))
        f, idx, nmask, out, dy = bwd[0]
        valid = float(nmask.sum())
        cases["neighborhood_max"].append((
            name, 1, grp.neighborhood_max_cuda, grp.neighborhood_max_plain,
            fwd, (_nbytes(f, idx, nmask, out), valid * c)))
        cases["neighborhood_max_bwd"].append((
            name, 1, grp.neighborhood_max_bwd_cuda,
            grp.neighborhood_max_bwd_plain, bwd,
            (_nbytes(f, idx, nmask, out, dy, f), 2 * valid * c)))
    return cases


def phase_train_timing(tcfg, training, kind: str) -> dict:
    """Each kernel per train step of the config (bf16) against its plain
    version and its bound; the step's median time and device split."""
    dev = torch.device(DEVICE)
    calls = []
    for r in range(3):  # distinct inputs per launch
        b = make_batch(SEED + 600 + r, batch=tcfg.batch_size,
                       points=tcfg.num_points)
        calls.append(path_calls(tcfg, torch.from_numpy(b["xyz"]).to(dev),
                                torch.from_numpy(b["mask"]).to(dev)))
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    per_kernel = {}
    phase = f"train-timing:{kind}"
    for kernel, rows in _kernel_cases(tcfg, calls, gen, kind).items():
        out = []
        for name, count, fn, plain, ins, (nbytes, flops) in rows:
            ms, plain_ms = _time(fn, ins, 20), _time(plain, ins, 3)
            bound_ms, bound_by = _bound(nbytes, flops)
            out.append({"call": name, "per_step": count, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bytes": nbytes,
                        "flops": flops})
            log(phase, f"{kernel} {name} x{count}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.3f} GFLOP)")
        bound_time = {}
        for r in out:
            bound_time[r["bound_by"]] = (bound_time.get(r["bound_by"], 0.0)
                                         + r["bound_ms"] * r["per_step"])
        per_kernel[kernel] = {
            "calls": out,
            "ms": sum(r["ms"] * r["per_step"] for r in out),
            "plain_ms": sum(r["plain_ms"] * r["per_step"] for r in out),
            "bound_ms": sum(bound_time.values()),
            "bound_by": max(bound_time, key=bound_time.get)}
        t = per_kernel[kernel]
        log(phase, f"{kernel} per step: kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']})")

    step_ms = sorted(training["step_ms"][3:])  # after warm-up
    host_ms = sorted(training["host_ms"][3:])
    med, hmed = step_ms[len(step_ms) // 2], host_ms[len(host_ms) // 2]
    state, step, batch = training["state"], training["step"], \
        training["batch"]
    nsteps = 3
    prof, split = _profiled(lambda: step(state, batch, SEED), nsteps, med)
    # device kernels only (an ATen op's entry repeats its kernels' time)
    avgs = sorted((e for e in prof.key_averages() if _device_us(e) > 0
                   and e.device_type == torch.autograd.DeviceType.CUDA),
                  key=_device_us, reverse=True)
    top = [{"name": e.key[:90], "ms_per_step": _device_us(e) / nsteps / 1e3,
            "calls_per_step": e.count / nsteps} for e in avgs[:15]]
    split["top"] = top
    pts = tcfg.batch_size * tcfg.num_points
    log(phase, f"train step (batch {tcfg.batch_size} x "
        f"{tcfg.num_points} points, bf16, batch copy included): median "
        f"{med:.3f} ms by CUDA events over {len(step_ms)} steps (host clock "
        f"{hmed:.3f} ms); {pts / (med / 1e3):.0f} points/s; peak memory "
        f"{training['peak_gib']:.2f} GiB")
    log(phase, f"profiled {nsteps} steps: wall "
        f"{split['wall_ms_profiled']:.3f} ms/step, device busy "
        f"{split['device_busy_ms']:.3f} ms/step (idle "
        f"{100 * split['device_idle_share']:.1f}% of the profiled wall; "
        f"{100 * split['device_idle_share_est']:.1f}% of the unprofiled "
        f"median, an estimate)")
    for row in top:
        log(phase, f"  {row['ms_per_step']:9.4f} ms "
            f"{row['calls_per_step']:6.1f} calls/step  {row['name']}")
    return {"per_kernel": per_kernel, "step_ms_median": med,
            "step_ms_all": training["step_ms"], "host_ms_median": hmed,
            "points_per_s": pts / (med / 1e3), "split": split,
            "request_ms_median": training["request_ms_median"]}


# ---- main -------------------------------------------------------------------

REPLACES = {
    "ball_query": ("closerlook3d_tpu_torch/csrc/ball_query.cu",
                   "closerlook3d_tpu/ops/pallas/neighbors.py:36",
                   "closerlook3d_tpu/ops/pallas/neighbors.py:266"),
    "fps": ("closerlook3d_tpu_torch/csrc/fps.cu",
            "closerlook3d_tpu/ops/pallas/sampling.py:29", None),
    "pospool_xyz": ("closerlook3d_tpu_torch/csrc/pospool_xyz.cu",
                    "closerlook3d_tpu/ops/pallas/aggregation.py:290", None),
    "pospool_xyz_bwd": ("closerlook3d_tpu_torch/csrc/pospool_xyz.cu",
                        "closerlook3d_tpu/ops/pallas/aggregation.py:337",
                        None),
    "neighborhood_max": ("closerlook3d_tpu_torch/csrc/neighborhood_max.cu",
                         "closerlook3d_tpu/ops/pallas/gather_reduce.py:568",
                         None),
    "neighborhood_max_bwd": (
        "closerlook3d_tpu_torch/csrc/neighborhood_max.cu",
        "closerlook3d_tpu/ops/pallas/gather_reduce.py:674",
        "closerlook3d_tpu/ops/pallas/gather_reduce.py:616"),
    "pospool_sincos": ("closerlook3d_tpu_torch/csrc/pospool_sincos.cu",
                       "closerlook3d_tpu/ops/pallas/aggregation.py:458",
                       None),
    "pospool_sincos_bwd": ("closerlook3d_tpu_torch/csrc/pospool_sincos.cu",
                           "closerlook3d_tpu/ops/pallas/aggregation.py:507",
                           None),
    "moments": ("closerlook3d_tpu_torch/csrc/moments.cu",
                "closerlook3d_tpu/ops/pallas/moments.py:48", None),
    "moments_bwd": ("closerlook3d_tpu_torch/csrc/moments.cu",
                    "closerlook3d_tpu/ops/pallas/moments.py:96", None),
}


def home_kind(kernel: str) -> str:
    """The training config whose run gives a kernel's launches and times:
    the one whose aggregation it is, else the xyz config."""
    return next((k for k, pair in AGG_KERNELS.items() if kernel in pair),
                "xyz")


def main() -> int:
    t_start = time.perf_counter()
    record = {"device": phase_device()}
    record["build"] = phase_build()
    wrappers = kernel_wrappers()

    cfg = flagship_config()
    record["parity"] = phase_kernel_parity(cfg)
    weights = seeded_weights(cfg, torch.Generator().manual_seed(SEED))
    serving = phase_serving(cfg, weights, wrappers)
    record["serving_launches"] = serving["launches"]
    record["forward_parity"] = phase_forward_parity(
        cfg, weights, serving["batches"][1])
    record["timing"] = phase_timing(cfg, serving)

    record["train"] = {}
    for kind in TRAIN_KINDS:
        tcfg = train_config(kind)
        run = {"parity": phase_train_kernel_parity(tcfg, kind),
               "step_parity": phase_train_step_parity(tcfg, wrappers, kind)}
        training = phase_training(tcfg, wrappers, kind)
        run["training"] = {k: v for k, v in training.items()
                           if k not in ("state", "step", "batch")}
        run["timing"] = phase_train_timing(tcfg, training, kind)
        record["train"][kind] = run
        del training
    record["seconds"] = time.perf_counter() - t_start

    kernels_line = {"kernels": []}
    for name, (src, rep, also) in REPLACES.items():
        kind = home_kind(name)
        run = record["train"][kind]
        t = run["timing"]["per_kernel"][name]
        # measured against the plain versions at every shape the kernel
        # was checked at (the flagship's and the training config's)
        err = max(e for e in (record["parity"].get(name),
                              run["parity"][name]) if e is not None)
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               # the config's bf16 training run, counted from 0 before
               # each step
               "launches": run["training"]["launches"][name],
               "max_abs_err": err,
               "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               # no single PyTorch call computes these masked, padded
               # neighborhood functions
               "library_ms": None,
               "config": kind,
               "launches_per_step": launches_per(kind, True)[name],
               "serving_launches": serving["launches"][name]}
        if also:
            row["also_replaces"] = also
        kernels_line["kernels"].append(row)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    log("done", f"all phases passed in {record['seconds']:.1f} s")
    print(gpu_line(), flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
