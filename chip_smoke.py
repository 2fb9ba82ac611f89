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
* training, on five ModelNet40 configs at full width and depth (5000
  points, batch 32; set here in code, so PyYAML is not needed):
  ``pospool_xyz_avg.yaml``, ``pospool_sincos_avg.yaml``,
  ``adaptive_weight_dp_fc1_avg.yaml``,
  ``pointwisemlp_dp_fi_df_fc1_max.yaml`` and ``pseudo_grid.yaml``. For
  each: checks its aggregation kernels (PosPool xyz, PosPool sin/cos, the
  neighborhood moments, the point-wise MLP's min/max + statistics and
  gather-subtract min/max, or the pseudo-grid correlation at all three
  influence modes) forward and backward against their plain versions at
  every call shape of the train step, in f32 and bf16 (for the xyz config
  also the ball query, FPS and the neighborhood max); holds an f32 train step
  through the kernels to one through the plain versions (same weights,
  batch and geometry) and checks that every parameter gets a gradient
  (for the point-wise MLP also the gradient of an eval-mode forward, the
  path of its gather-subtract backward); trains bf16 steps on one batch
  (the loss must fall) with exact per-step launch counts; ends with an
  eval step and timed ``Predictor`` requests at that config;
* segmentation serving, at the full size of
  ``configs/shapenetpart/pospool_xyz_avg.yaml`` (32 x 2048 points, 50
  part logits per point) and ``configs/s3dis/pospool_xyz_avg.yaml`` (8 x
  15000 points, grid subsampling, 13 class logits per point): checks the
  k-NN kernel (the decoder's upsample indices) against its plain version
  at every call shape and at k = 3 and k > Ns, and the ball query, PosPool
  and the neighborhood max at these shapes; serves requests through
  ``Predictor`` with exact launch counts, holds f32 per-point logits of
  the card to the CPU's, and times requests;
* segmentation training, on ``configs/shapenetpart/
  pointwisemlp_dp_fi_df_fc1_max.yaml`` with 8 clouds a step (its last
  stage takes the point-wise MLP's K13 + K7 route, the other stages K6)
  and on ``configs/s3dis/pospool_xyz_avg.yaml`` as the file stands (8 x
  15000 points, grid subsampling, labels at ``ignore_label``): checks
  every kernel of the train step against its plain version at every call
  shape, f32 and bf16, on a padded, an all-masked and a duplicated cloud
  (K13, the masked neighborhood sum, equal to the bit forward, also with
  repeated support rows, and backward to its twin on CPU copies); holds an f32 train step through the kernels,
  geometry computed in the step, to one through the plain versions (each
  gradient within 2% relative L2); trains 15 bf16 steps on one batch
  (the loss must fall) with exact per-step launch counts, then an eval
  step; times the step;
* every other config under ``configs/``, each read from its file by the
  port's ``load_config``: PartNet's five (its xyz config at the file's 32
  x 10000 points, depth 3, with ``Predictor`` requests and f32 logits
  against the CPU on two clouds; the other four at 8 clouds; a stand-in
  part table of 17 categories, since PartNet's own counts come from its
  h5 files), S3DIS's sin/cos, adaptive-weight, point-wise MLP and
  pseudo-grid configs (8 x 15000 points) and ShapeNetPart's xyz, sin/cos,
  adaptive-weight and pseudo-grid configs (8 clouds of 2048): f32
  per-point logits and geometry through the kernels against the plain
  versions on the card, one f32 train step within 2% per gradient of the
  plain one, 6 bf16 steps (finite losses, every parameter moved) and an
  eval step, each with exact launches of every kernel; the step's median,
  device busy and peak memory;
* the ball query by device time at the 9 calls of the ModelNet40 xyz
  train step, of the S3DIS train step and of a flagship request (right
  after the build), beside its bound (bytes, or 8 operations per
  in-radius pair) and the bound of a scan of all pairs;
* K13 per step of that ShapeNetPart run (timed first, right after the
  build) against its plain version, its bound and one ``torch.bmm`` of
  the multi-hot count matrix, by device time (torch.profiler, kernel and
  library in turns, beside an empty kernel's launch) and by CUDA events
  over eager launches, each K13 call one device kernel;
* the device sort: ``morton_sort`` of an 8 x 15000 batch on the card
  equal to the CPU's, and an S3DIS request with ``spatial_sort: auto`` on
  an unsorted batch equal, in caller order, to the request on the
  host-sorted batch;
* the native host ops of the S3DIS data path (built beside the kernels
  with the host's C++ compiler), on two generated rooms of a million
  points: grid subsampling equal to its numpy twin to the bit, the
  kd-tree's k-NN (k = 1 and 16) and radius queries against scipy's, equal
  but at ties at f32 precision, each timed against numpy or scipy on the
  host's clock;
* S3DIS voting evaluation at that config's full width: two test-area
  rooms of a million points prepared by the native grid subsampling and
  written into the processed cache, sphere queries on the native kd-tree,
  ``evaluate_s3dis_voting`` through ``Predictor`` with 6 votes (the
  config's 20 take 84 s), each sphere batch's launches counted, the
  projection to the
  full clouds one pruned 1-NN launch a room, held to ``knn_plain`` at
  16384 queries a room and timed with the sub-cloud as stored and
  Morton-sorted;
* the training engine, as a user runs it: the train CLI on
  ``configs/modelnet40/pospool_xyz_avg.yaml`` (read by the port's YAML
  reader) at full width on synthetic clouds, 2 epochs with validation,
  checkpoints and exact launch counts; a resumed ``Trainer`` whose
  restored state equals the saved one bit for bit; the evaluate CLI on
  the last checkpoint, equal to ``evaluate_classification``;
* serving export: for the flagship, the four other ModelNet40 operator
  configs (depth 1, 8 clouds, the pseudo-grid at half width), ShapeNetPart
  and S3DIS, exports the eval forward with ``serving/export.py`` (no
  kernel launches), saves and loads the artifact, serves 3 requests with
  exactly the launches and the logits (to the bit) of ``Predictor``'s
  eager requests, checks that a request of the wrong shape raises, and
  times the artifact against ``Predictor`` in turns; and the ``cl3d``
  op's dispatch cost a call;
* data parallelism, 2 ranks sharing the card over gloo: the flagship
  ModelNet40 config and the point-wise MLP one at full width, 1024
  points, 16 clouds a rank, against one process stepping the 32-cloud
  batch (an f32 step, 3 bf16 steps: losses, gradients, parameters,
  running statistics; exact launches a rank and step; parameters
  bit-equal across the ranks; step medians and collectives a step), and
  two broken syncs as controls that the limits must fail; then the train
  CLI under torchrun for an epoch, and one more torchrun launch that
  resumes it and runs the evaluate CLI's main;
* the entry hooks of ``__graft_entry_torch__.py``: ``entry()``'s forward
  (weights as an argument) equal to ``Predictor``'s to the bit with the
  flagship request's launches, and ``dryrun_multichip(2)``;
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
import re
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
    """The flagship model of the entry hooks (``__graft_entry_torch__``),
    bf16, ``BATCH`` clouds a request."""
    from __graft_entry_torch__ import _flagship_cfg

    cfg = _flagship_cfg()
    cfg.batch_size = BATCH
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
    """``configs/modelnet40/pospool_sincos_avg.yaml`` (kind "sincos"),
    ``configs/modelnet40/adaptive_weight_dp_fc1_avg.yaml`` ("adaptive"),
    ``configs/modelnet40/pointwisemlp_dp_fi_df_fc1_max.yaml`` ("pwmlp") or
    ``configs/modelnet40/pseudo_grid.yaml`` ("pgrid"), set in code; CPU
    tests hold each equal to its file."""
    cfg = slice_config()
    if kind == "sincos":
        cfg.pospool.position_embedding = "sin_cos"
    elif kind == "adaptive":
        cfg.local_aggregation_type = "adaptive_weight"
        cfg.adaptive_weight.local_input_feature = "dp"
        cfg.adaptive_weight.fc_num = 1
        cfg.adaptive_weight.reduction = "avg"
    elif kind == "pwmlp":
        cfg.local_aggregation_type = "pointwisemlp"
        cfg.pointwisemlp.feature_type = "dp_fi_df"
        cfg.pointwisemlp.num_mlps = 1
        cfg.pointwisemlp.reduction = "max"
    elif kind == "pgrid":
        cfg.local_aggregation_type = "pseudo_grid"
        cfg.pseudo_grid.num_kernel_points = 15
        cfg.pseudo_grid.KP_influence = "linear"
        cfg.pseudo_grid.KP_extent = 1.0
        cfg.pseudo_grid.convolution_mode = "sum"
    else:
        raise ValueError(kind)
    return cfg


def seg_config(name: str):
    """``configs/shapenetpart/pospool_xyz_avg.yaml`` (name "shapenetpart")
    or ``configs/s3dis/pospool_xyz_avg.yaml`` ("s3dis"), set in code; a
    CPU test holds each equal to its file."""
    from closerlook3d_tpu_torch.utils.config import load_config

    cfg = load_config()
    common = dict(
        input_features="xyz", optimizer="sgd", lr_scheduler="cosine",
        warmup_epoch=5, weight_decay=0.001, momentum=0.9,
        label_smoothing=0.2, augment_rotation="z", augment_scale_min=0.8,
        augment_scale_max=1.2, augment_noise=0.001, width=144, depth=2,
        bottleneck_ratio=2, radius=0.1, nsamples=[26, 31, 38, 41, 39],
        dropout_rate=0.5, local_aggregation_type="pospool")
    if name == "shapenetpart":
        common.update(
            datasets="shapenetpart", task="part_segmentation",
            num_points=2048, num_classes=16, batch_size=32, epochs=400,
            base_learning_rate=0.002, sampling="fps",
            npoints=[2048, 512, 128, 32, 8])
    elif name == "s3dis":
        common.update(
            datasets="s3dis", task="scene_segmentation", num_points=15000,
            num_classes=13, batch_size=8, input_features="ones,rgb,height",
            epochs=600, base_learning_rate=0.01, sampling="grid",
            npoints=[15000, 4096, 1152, 304, 88], sampleDl=0.08,
            first_subsampling_dl=0.04, in_radius=2.0, num_steps=2000,
            num_votes=20, color_drop=0.2)
    else:
        raise ValueError(name)
    for key, value in common.items():
        cfg[key] = value
    cfg.pospool.position_embedding = "xyz"
    cfg.pospool.reduction = "avg"
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
    from closerlook3d_tpu_torch.ops import gather_reduce as gr
    from closerlook3d_tpu_torch.ops import moments as mom
    from closerlook3d_tpu_torch.ops import neighbors as nbr
    from closerlook3d_tpu_torch.ops import pseudo_grid as pg
    from closerlook3d_tpu_torch.ops.grouping import (
        neighborhood_max_bwd_cuda, neighborhood_max_cuda)
    from closerlook3d_tpu_torch.ops.sampling import furthest_point_sample_cuda

    return {"ball_query": nbr.ball_query_cuda,
            "fps": furthest_point_sample_cuda,
            "pospool_xyz": agg.pospool_xyz_cuda,
            "pospool_xyz_bwd": agg.pospool_xyz_bwd_cuda,
            "neighborhood_max": neighborhood_max_cuda,
            "neighborhood_max_bwd": neighborhood_max_bwd_cuda,
            "pospool_sincos": agg.pospool_sincos_cuda,
            "pospool_sincos_bwd": agg.pospool_sincos_bwd_cuda,
            "moments": mom.neighborhood_moments_cuda,
            "moments_bwd": mom.neighborhood_moments_bwd_cuda,
            "pwmlp_stats": gr.pwmlp_minmax_stats_cuda,
            "pwmlp_stats_bwd": gr.pwmlp_minmax_stats_bwd_cuda,
            "gather_sub_minmax": gr.gather_sub_minmax_cuda,
            "gather_sub_minmax_bwd": gr.gather_sub_minmax_bwd_cuda,
            "neighborhood_sum": gr.neighborhood_sum_cuda,
            "neighborhood_sum_bwd": gr.neighborhood_sum_bwd_cuda,
            "pseudo_grid": pg.pseudo_grid_cuda,
            "pseudo_grid_bwd": pg.pseudo_grid_bwd_cuda,
            # one kernel (csrc/knn.cu), counted by route: the JAX
            # package's chunked 1-NN (K11) and its k-NN (K12)
            "knn1": nbr.knn1_cuda,
            "knn": nbr.knn_cuda}


# The training configs, by kind, and the aggregation kernels each one's
# LocalAggregation launches (14 calls per forward at depth 2): those of a
# train step, and those of an eval-mode forward. The backward of an
# eval-mode forward runs each of the latter's backward ("<name>_bwd").
TRAIN_KINDS = ("xyz", "sincos", "adaptive", "pwmlp", "pgrid")
AGG_KERNELS = {"xyz": (("pospool_xyz", "pospool_xyz_bwd"), ("pospool_xyz",)),
               "sincos": (("pospool_sincos", "pospool_sincos_bwd"),
                          ("pospool_sincos",)),
               "adaptive": (("moments", "moments_bwd"), ("moments",)),
               "pwmlp": (("pwmlp_stats", "pwmlp_stats_bwd"),
                         ("gather_sub_minmax",)),
               "pgrid": (("pseudo_grid", "pseudo_grid_bwd"),
                         ("pseudo_grid",))}


def agg_kernels(kind: str, mode: str) -> tuple:
    """The aggregation kernels of the ``kind`` config in one ``mode``
    run: "train" (a train step), "forward" (an eval-mode forward) or
    "eval_grad" (an eval-mode forward and its backward)."""
    train, forward = AGG_KERNELS[kind]
    if mode == "train":
        return train
    if mode == "forward":
        return forward
    return forward + tuple(f"{k}_bwd" for k in forward)


def train_config(kind: str):
    return slice_config() if kind == "xyz" else operator_config(kind)


def agg_ops(kind: str):
    """(forward kernel, its plain version, backward kernel, its plain twin,
    output channels per input channel) of a PosPool or adaptive-weight
    config's aggregation (the point-wise MLP's kernels take other
    arguments: ``_pwmlp_parity``, ``_pwmlp_cases``)."""
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


def launches_per(kind: str, mode: str) -> dict:
    """Exact launches of every kernel in one ``mode`` run of the ``kind``
    config at depth 2 (modes as ``agg_kernels``')."""
    counts = dict.fromkeys(kernel_wrappers(), 0)
    counts.update({"ball_query": 9, "fps": 4, "neighborhood_max": 4})
    if mode != "forward":
        counts["neighborhood_max_bwd"] = 4
    counts.update(dict.fromkeys(agg_kernels(kind, mode), 14))
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
        aggregation, gather_reduce, grouping, moments, neighbors,
        pseudo_grid, sampling)

    mods = (aggregation, gather_reduce, grouping, moments, neighbors,
            pseudo_grid, sampling)
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
           "pospool_sincos", "moments", "gather_reduce", "pseudo_grid",
           "knn", "reverse_index")


def _build_native():
    from closerlook3d_tpu_torch import native

    t0 = time.perf_counter()
    path = native.build_library()
    native.load()
    return path, time.perf_counter() - t0


def phase_build() -> dict:
    """The CUDA kernels (one nvcc a source) and, beside them, the native
    host ops of the S3DIS data path (one host C++ compiler)."""
    from concurrent.futures import ThreadPoolExecutor

    from closerlook3d_tpu_torch import native
    from closerlook3d_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(_build_native)
        libs = kernels.build_all(SOURCES)
        native_lib, native_s = host.result()
    out = {"seconds_all": time.perf_counter() - t0,
           "native": {"library": native_lib, "seconds": native_s}}
    log("build", f"native host ops: {native.compiler()} "
        f"{' '.join(native.CXX_FLAGS)} in {native_s:.2f} s")
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
                  for k, n in launches_per("xyz", "forward").items()})
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
        # the same f32 terms summed in other orders: the twin's index_add_
        # on the card adds with atomics in an order that varies, while
        # K1b, K5b, K9b and K8b add each support row's terms in (q, t)
        # order (and sin/cos: CUDA's sinf against
        # sincosf); sums of up to ~40 terms carry more rounding than
        # averages, and a moments slot's term (g0 + sum_d g_d dp_d) is up
        # to 4x a PosPool one
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
    dev = torch.device(DEVICE)
    nb = tcfg.batch_size
    b = make_batch(SEED + 300, padded=(nb - 4,), all_masked=(nb - 3,),
                   duplicated=(nb - 2, nb - 1), batch=nb,
                   points=tcfg.num_points)
    xyz = torch.from_numpy(b["xyz"]).to(dev)
    mask = torch.from_numpy(b["mask"]).to(dev)
    bq, fps, pp = path_calls(tcfg, xyz, mask)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    phase = f"train-parity:{kind}"
    if kind == "pwmlp":
        return _pwmlp_parity(pp, gen, phase)
    if kind == "pgrid":
        errs = _pgrid_parity(tcfg, pp, gen, phase)
        return _query_group_edges(kind, gen, phase, errs)
    errs = _agg_parity(kind, pp, gen, phase)
    if kind == "sincos":
        _query_group_edges(kind, gen, phase, errs)
    if kind == "xyz":
        errs.update(_geometry_parity(bq, fps))
        errs.update(_max_parity(tcfg, pp, gen, phase))
    return errs


def _note_close(errs, key, what, got, ref, tol):
    """Raise unless ``got`` and ``ref`` agree within ``tol``; keep the
    max abs error under ``errs[key]`` and return it."""
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), **tol,
                               msg=lambda m: f"{what}: {m}")
    err = float((got.float() - ref.float()).abs().max())
    errs[key] = max(errs.get(key, 0.0), err)
    return err


def agg_exact(kind, q, s, f, idx, nmask, r, red):
    """A PosPool or adaptive-weight forward as its kernel computes it, in
    f64: the weights (dp, or the sin/cos embedding of f32 dp) rounded to
    the features' dtype, the products and sums exact. The kernel's f32
    sums, rounded once, approximate it; in bf16 the plain version's
    rounding of every product and sum drifts further from it."""
    from closerlook3d_tpu_torch.ops.aggregation import _sincos_emb
    from closerlook3d_tpu_torch.ops.grouping import (
        REDUCTIONS, group_features, neighbor_offsets)

    g = group_features(f.double(), idx)
    c = f.shape[-1]
    if kind == "sincos":
        terms = [g * _sincos_emb(q, s, idx, r, c, f.dtype).double()]
    else:
        dp = neighbor_offsets(q, s, idx, r, f.dtype).double()
        terms = ([g * dp.repeat_interleave(c // 3, dim=-1)] if kind == "xyz"
                 else [g] + [g * dp[..., d:d + 1] for d in range(3)])
    return torch.cat([REDUCTIONS[red](t, nmask) for t in terms], dim=-1)


def _agg_fwd_close(errs, key, what, got, ref, tol, exact):
    """``_note_close`` for a bf16 aggregation forward, where the plain
    version's rounding of every product can stray beyond ``tol``: an
    element outside it passes only where the kernel lies no farther than
    the plain version from ``exact()`` (``agg_exact``; both are as near
    where it falls on the midpoint of two bf16 values). Returns (max abs
    err against the plain version, a note on the elements so judged)."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{ref.dtype} {tuple(ref.shape)}")
    g, p = got.float(), ref.float()
    gap = (g - p).abs()
    out = ~(gap <= tol["atol"] + tol["rtol"] * p.abs())
    n = int(out.sum())
    note = ""
    if n:
        e = exact()
        kerr = (got.double() - e).abs()[out]
        perr = (ref.double() - e).abs()[out]
        if not bool((kerr <= perr).all()):
            raise AssertionError(
                f"{what}: {n} elements beyond {tol} of the plain version, "
                f"the kernel farther from the exact value at some "
                f"(kernel's errors {kerr.tolist()[:8]}, plain's "
                f"{perr.tolist()[:8]})")
        note = (f"; {n} of {got.numel()} elements beyond tol, the kernel "
                f"no farther from the exact value at each (kernel max "
                f"{float(kerr.max()):.3g}, plain max {float(perr.max()):.3g})")
    err = float(gap.max())
    errs[key] = max(errs.get(key, 0.0), err)
    return err, note


def _agg_parity(kind, pp, gen, phase) -> dict:
    """A PosPool or adaptive-weight config's aggregation kernels forward
    and backward vs their plain versions and twins (and vs autograd of
    the plain forward) at the calls ``pp``, f32 and bf16, avg and sum
    (the bf16 forward as ``_agg_fwd_close`` judges it); {kernel: max abs
    err, "max_dp": largest |dp|}."""
    (fwd_name, bwd_name), _ = AGG_KERNELS[kind]
    fwd, plain, bwd, twin, widen = agg_ops(kind)
    errs = {fwd_name: 0.0, bwd_name: 0.0}
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
                got = fwd(q, s, f, idx, nmask, r, red)
                ref = plain(q, s, f, idx, nmask, r, red)
                if dtype == torch.float32:
                    e_f = _note_close(errs, fwd_name, what, got, ref, tol_f)
                    judged = ""
                else:
                    e_f, judged = _agg_fwd_close(
                        errs, fwd_name, what, got, ref, tol_f,
                        lambda: agg_exact(kind, q, s, f, idx, nmask, r, red))
                got = bwd(q, s, idx, nmask, dy, r, red)
                e_t = _note_close(errs, bwd_name, what + " bwd vs twin", got,
                                  twin(q, s, idx, nmask, dy, r, red), tol_b)
                _, ref = _vjp(lambda x: plain(q, s, x, idx, nmask, r, red),
                              f, dy)
                e_a, rel = _vs_autograd(what, got, ref, dtype, red, kind)
                log(phase, f"{what}: max |dp| {dpm:.3f}; max abs err fwd "
                    f"{e_f:.3g} (tol {tol_f}{judged}), bwd vs twin "
                    f"{e_t:.3g} (tol {tol_b}), vs autograd {e_a:.3g} (L2 "
                    f"{rel:.2g}; "
                    + ("tol as vs twin" if dtype == torch.float32
                       else "L2 bound 0.02") + ")")
    # the sin/cos embedding's top frequency turns |dp| ~ 1 into ~100 rad
    if not max_dp > 0.9:
        raise AssertionError(f"neighborhoods reach only |dp| {max_dp:.3f}")
    errs["max_dp"] = max_dp
    return errs


def _max_parity(cfg, pp, gen, phase) -> dict:
    """The strided shortcuts' neighborhood max forward and backward vs
    the plain version and twin (and vs autograd of the plain forward) at
    the calls of ``pp``, f32 and bf16, on values with ties and distinct
    ones; {kernel: max abs err}."""
    from closerlook3d_tpu_torch.ops.grouping import (
        neighborhood_max_bwd_cuda, neighborhood_max_bwd_plain,
        neighborhood_max_cuda, neighborhood_max_plain)

    errs = {"neighborhood_max": 0.0, "neighborhood_max_bwd": 0.0}
    for name, (s, idx, nmask), c in max_calls(cfg, pp):
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
                e_t = _note_close(
                    errs, "neighborhood_max_bwd", what + " bwd vs twin",
                    got, neighborhood_max_bwd_plain(f, idx, nmask, out, dy),
                    _bwd_tol(dtype, "sum"))
                # dy / n is rounded alike; only the sums over the queries
                # that share a winning row differ
                e_a, rel = _vs_autograd(what, got, ref_grad, dtype, "sum")
                log(phase, f"{what}: fwd equal; max abs err bwd vs twin "
                    f"{e_t:.3g}, vs autograd {e_a:.3g} (L2 {rel:.2g})")
    return errs


def _grid_features(gen, s, c, dtype):
    """Signed values on a 0.25 grid, a function of the point's position:
    exact ties within neighborhoods, and duplicated points carry equal
    rows, as the point-wise MLP's projections of equal points are equal."""
    w = torch.randn((3, c), generator=gen, device=s.device)
    return (torch.round(4 * (s @ w)) / 4).to(dtype)


def _grads(fn, inputs, cots):
    """(fn(*inputs), d<fn(*inputs), cots>/d inputs) under autograd; fn
    returns a tuple."""
    xs = [x.detach().requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    return [o.detach() for o in outs], torch.autograd.grad(outs, xs, cots)


# both sum in f64 and round once to f32, so they agree but where an f64
# sum lies within its rounding error of an f32 rounding boundary
PWMLP_SUM_TOL = dict(rtol=1e-6, atol=1e-6)


def _same_bits(what, got, ref) -> None:
    """Raise unless each pair of tensors holds the same bits (zero signs
    included)."""
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref)):
        view = torch.int16 if a.element_size() == 2 else torch.int32
        bad = int((a.view(view) != b.to(a.device).view(view)).sum())
        if a.shape != b.shape or a.dtype != b.dtype or bad:
            raise AssertionError(f"{what} [{i}]: {bad} elements differ in "
                                 f"their bits")


def _reverse_index_parity(what, idx, nmask, ns) -> None:
    """The reverse index kernel (``csrc/reverse_index.cu``) equal to its
    plain version: offsets, and each cloud's valid entries."""
    from closerlook3d_tpu_torch.ops.reverse_index import (
        reverse_index_cuda, reverse_index_plain)

    off, slots = reverse_index_cuda(idx, nmask, ns)
    poff, pslots = reverse_index_plain(idx, nmask, ns)
    torch.cuda.synchronize()
    n = off[:, -1:]
    used = torch.arange(slots.shape[1], device=slots.device)[None] < n
    if not (torch.equal(off, poff)
            and torch.equal(torch.where(used, slots, -1), pslots)):
        raise AssertionError(f"reverse index {what}: differs from its plain "
                             f"version")


def _pwmlp_bwd_tol(dtype):
    """Backward kernel vs its twin and vs autograd of the plain forward:
    the same f32 terms (equal shares of each cotangent) scattered in
    another order; in bf16 all three sum in f32 and round once, so one
    bf16 ulp where the orders straddle a rounding boundary."""
    return (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
            else dict(rtol=8e-3, atol=1e-5))


def _pwmlp_parity(pp, gen, phase) -> dict:
    """The point-wise MLP's kernels (K6, K7) forward and backward vs their
    plain versions at every aggregation call shape of the train step, f32
    and bf16, on grid values with ties and on distinct values; {kernel:
    max abs err}. Max and min must be equal; K6's backward must give the
    same bits on a second run and, with ties, equal its twin run on CPU
    copies to the bit, and K7's backward, on both, to the bit (against
    its twin run on the card, whose index_add_ adds with atomics, within
    the backward tolerance); the reverse index (its first launch's,
    launched alone) must equal its plain version at each call."""
    from concurrent.futures import ThreadPoolExecutor

    from closerlook3d_tpu_torch.ops import gather_reduce as gr

    errs = dict.fromkeys(("pwmlp_stats", "pwmlp_stats_bwd",
                          "gather_sub_minmax", "gather_sub_minmax_bwd"), 0.0)

    def note(key, what, pairs, tol):
        """Max abs err over (got, ref) pairs; tol None: must be equal."""
        torch.cuda.synchronize()
        worst = 0.0
        for i, (got, ref) in enumerate(pairs):
            if tol is None:
                err = _max_err(f"{what} [{i}]", got, ref)
            else:
                torch.testing.assert_close(
                    got.float(), ref.float(), **tol,
                    msg=lambda m, i=i: f"{what} [{i}]: {m}")
                err = float((got.float() - ref.float()).abs().max())
            worst = max(worst, err)
        errs[key] = max(errs[key], worst)
        return worst

    f32 = torch.float32
    # the twins on CPU copies run in host threads beside the checks on the
    # card, four at a time (one alone leaves the host's cores partly
    # idle); each is held to its kernel's bits once the loop is done
    pool = ThreadPoolExecutor(max_workers=4)
    twins = []

    def twin(what, got, fn, args):
        twins.append((what, [t.cpu() for t in got],
                      pool.submit(fn, *(a.cpu() for a in args))))

    try:
        for name, (q, s, idx, nmask, _), c, _ in pp:
            _reverse_index_parity(name, idx, nmask, s.shape[1])
            for dtype in (f32, torch.bfloat16):
                tol = _pwmlp_bwd_tol(dtype)
                for values, make in (("ties", _grid_features),
                                     ("distinct", _features)):
                    g32 = make(gen, s, c, f32)
                    g, gsq = g32.to(dtype), (g32 * g32).to(dtype)
                    d = _features(gen, q, c, dtype)
                    cot = [_features(gen, q, c, f32) for _ in range(4)]
                    what = (f"{name} C={c} K={idx.shape[2]} {str(dtype)[6:]} "
                            f"{values}")
                    outs = gr.pwmlp_minmax_stats_cuda(g, gsq, idx, nmask)
                    ref, ref_grads = _grads(
                        lambda a, b: gr.pwmlp_minmax_stats_plain(a, b, idx,
                                                                 nmask),
                        (g, gsq), cot)
                    k = f"pwmlp_stats {what}"
                    note("pwmlp_stats", k + " max/min",
                         list(zip(outs[:2], ref[:2])), None)
                    e_s = note("pwmlp_stats", k + " sums",
                               list(zip(outs[2:], ref[2:])), PWMLP_SUM_TOL)
                    args = (g, idx, nmask, outs[0], outs[1], *cot)
                    got = gr.pwmlp_minmax_stats_bwd_cuda(*args)
                    # the same bits on a second run, and (grid values: ties)
                    # those of its twin on CPU copies, which adds in the
                    # kernel's (q, t) order
                    _same_bits(k + " bwd, two runs", got,
                               gr.pwmlp_minmax_stats_bwd_cuda(*args))
                    if values == "ties":
                        twin(k + " bwd vs twin on the CPU", got,
                             gr.pwmlp_minmax_stats_bwd_plain, args)
                    e_t = note("pwmlp_stats_bwd", k + " bwd vs twin", zip(
                        got, gr.pwmlp_minmax_stats_bwd_plain(
                            g, idx, nmask, outs[0], outs[1], *cot)), tol)
                    e_a = note("pwmlp_stats_bwd", k + " bwd vs autograd",
                               zip(got, ref_grads), tol)
                    hm = gr.gather_sub_minmax_cuda(g, d, idx, nmask)
                    ref, ref_grads = _grads(
                        lambda a, b: gr.gather_sub_minmax_plain(a, b, idx,
                                                                nmask),
                        (g, d), cot[:2])
                    k = f"gather_sub_minmax {what}"
                    note("gather_sub_minmax", k, list(zip(hm, ref)), None)
                    args = (g, d, idx, nmask, *hm, *cot[:2])
                    got = gr.gather_sub_minmax_bwd_cuda(*args)
                    # the same bits on a second run and those of its twin on
                    # CPU copies, which adds in the kernel's (q, t) order
                    _same_bits(k + " bwd, two runs", got,
                               gr.gather_sub_minmax_bwd_cuda(*args))
                    twin(k + " bwd vs twin on the CPU", got,
                         gr.gather_sub_minmax_bwd_plain, args)
                    e_t7 = note("gather_sub_minmax_bwd", k + " bwd vs twin",
                                zip(got, gr.gather_sub_minmax_bwd_plain(
                                    *args)), tol)
                    e_a7 = note("gather_sub_minmax_bwd",
                                k + " bwd vs autograd", zip(got, ref_grads),
                                tol)
                    log(phase, f"{what}: pwmlp_stats max/min equal, sums max "
                        f"abs err {e_s:.3g} (tol {PWMLP_SUM_TOL}), bwd vs "
                        f"twin {e_t:.3g}, vs autograd {e_a:.3g}; "
                        f"gather_sub_minmax "
                        f"max/min equal, bwd vs twin {e_t7:.3g}, vs autograd "
                        f"{e_a7:.3g} (bwd tol {tol}); "
                        f"{int(nmask.sum())} valid slots")
        for what, got, ref in twins:
            _same_bits(what, got, ref.result())
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    return errs


def pgrid_geometry(tcfg, device):
    """(kernel points [Kp, 3] f32 on ``device``, influence extent) of the
    config's pseudo-grid, as its LocalAggregation builds them."""
    from closerlook3d_tpu_torch.models.aggregation import (
        _typical_spacing, kernel_point_layout)

    p = tcfg.pseudo_grid
    kp = kernel_point_layout(p.num_kernel_points, p.fixed_kernel_points)
    return (torch.from_numpy(kp).to(device),
            float(p.KP_extent * _typical_spacing(kp)))


def _pgrid_tol(dtype):
    """Pseudo-grid kernels vs their plain versions and twins, and vs
    autograd of the plain forward (which gathers and sums in f32 too):
    the same f32 terms summed in another order (slots in order, or f32
    atomics, against a matmul and index_add_), rounded once; in bf16 one
    ulp where the orders straddle a rounding boundary."""
    return (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
            else dict(rtol=8e-3, atol=1e-5))


def _pgrid_parity(tcfg, pp, gen, phase) -> dict:
    """The pseudo-grid kernels (K10) forward and backward vs their plain
    versions, the backward also vs autograd of the plain forward, at every
    aggregation call shape of the train step, f32 and bf16, for all three
    influence modes (the config trains with the linear one); the backward
    must give the same bits on a second run."""
    from closerlook3d_tpu_torch.ops import pseudo_grid as pg

    kp, extent = pgrid_geometry(tcfg, DEVICE)
    kpn = kp.shape[0]
    errs = {"pseudo_grid": 0.0, "pseudo_grid_bwd": 0.0}

    def note(key, what, got, ref, tol):
        return _note_close(errs, key, what, got, ref, tol)

    for name, (q, s, idx, nmask, r), c, _ in pp:
        for dtype in (torch.float32, torch.bfloat16):
            f = _features(gen, s, c, dtype)
            dy = _features(gen, q, kpn * c, dtype)
            tol = _pgrid_tol(dtype)
            for mode in ("linear", "constant", "gaussian"):
                args = (kp, r, extent, mode)
                what = (f"pseudo_grid {name} C={c} K={idx.shape[2]} "
                        f"Kp={kpn} {str(dtype)[6:]} {mode}")
                e_f = note("pseudo_grid", what,
                           pg.pseudo_grid_cuda(q, s, f, idx, nmask, *args),
                           pg.pseudo_grid_plain(q, s, f, idx, nmask, *args),
                           tol)
                bargs = (q, s, idx, nmask, kp, dy, r, extent, mode)
                got = pg.pseudo_grid_bwd_cuda(*bargs)
                _same_bits(what + " bwd, two runs", [got],
                           [pg.pseudo_grid_bwd_cuda(*bargs)])
                e_t = note("pseudo_grid_bwd", what + " bwd vs twin", got,
                           pg.pseudo_grid_bwd_plain(*bargs), tol)
                _, ref = _vjp(lambda x: pg.pseudo_grid_plain(
                    q, s, x, idx, nmask, *args), f, dy)
                e_a = note("pseudo_grid_bwd", what + " bwd vs autograd",
                           got, ref, tol)
                log(phase, f"{what}: max abs err fwd {e_f:.3g}, bwd vs twin "
                    f"{e_t:.3g}, vs autograd {e_a:.3g} (tol {tol}); "
                    f"{int(nmask.sum())} valid slots")
    return errs


def _query_group_edges(kind, gen, phase, errs) -> dict:
    """The edges of the forward kernels' query-group layout (K10f for
    "pgrid", K5f for "sincos") beyond the train step's calls, whose stage
    4 already splits its channels across groups: C off the 16-byte vector
    (78, or 30), K = 64 (and Kp = 64 for K10f), Nq = 37 (off the groups a
    block), an all-masked cloud, and the features as a view at an odd
    element offset (the scalar path), which must give the bits of its
    aligned copy. Each held to its plain version at the config's
    tolerance, f32 and bf16; the max abs errors join ``errs``."""
    from closerlook3d_tpu_torch.models.aggregation import (
        _typical_spacing, kernel_point_layout)
    from closerlook3d_tpu_torch.ops import aggregation as ag
    from closerlook3d_tpu_torch.ops import pseudo_grid as pg
    from closerlook3d_tpu_torch.ops.neighbors import ball_query_cuda

    dev = torch.device(DEVICE)
    s = torch.rand((3, 400, 3), generator=gen, device=dev) * 2 - 1
    q = s[:, :37].contiguous()
    smask = torch.ones((3, 400), dtype=torch.bool, device=dev)
    qmask = torch.ones((3, 37), dtype=torch.bool, device=dev)
    qmask[-1] = False
    for k, c, kpn in ((26, 78, 15), (64, 30, 64)):
        idx, nmask = ball_query_cuda(q, s, 0.5, k, qmask, smask)
        kp = kernel_point_layout(kpn, "center")
        kp_t = torch.from_numpy(kp).to(dev)
        extent = 1.2 * _typical_spacing(kp)
        for dtype in (torch.float32, torch.bfloat16):
            flat = torch.randn(3 * 400 * c + 1, generator=gen,
                               device=dev).to(dtype)
            view = flat[1:].view(3, 400, c)  # 2 or 4 bytes off 16
            f = view.clone()
            if kind == "pgrid":
                name, tol = "pseudo_grid", _pgrid_tol(dtype)
                args = (kp_t, 0.5, extent, "linear")
                fwd, plain = pg.pseudo_grid_cuda, pg.pseudo_grid_plain
            else:
                name, tol = "pospool_sincos", _pospool_fwd_tol(
                    dtype, "sum", "sincos")
                args = (0.5, "sum")
                fwd, plain = ag.pospool_sincos_cuda, ag.pospool_sincos_plain
            what = (f"{name} edge K={k} C={c}"
                    + (f" Kp={kpn}" if kind == "pgrid" else "")
                    + f" {str(dtype)[6:]}")
            got = fwd(q, s, f, idx, nmask, *args)
            _same_bits(what + " unaligned view", [fwd(q, s, view, idx, nmask,
                                                      *args)], [got])
            err = _note_close(errs, name, what, got,
                              plain(q, s, f, idx, nmask, *args), tol)
            if not (got[-1] == 0).all():
                raise AssertionError(f"{what}: all-masked cloud not zero")
            log(phase, f"{what}: max abs err {err:.3g} (tol {tol}); the "
                f"unaligned view gives the same bits")
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


def _grad_gaps(what, km, pm) -> dict:
    """Relative L2 gap of each parameter's gradient, kernel model ``km``
    against plain model ``pm``; raise on a zero gradient or a gap over 2%.

    Forward rounding differences (~1e-6 relative by the last block) flip
    the odd ReLU whose input is within an ulp of 0; with a global average
    pool over 19 points per cloud each flipped element carries a large
    gradient, and the flip moves every gradient before it by tenths of a
    percent (relative L2). A wrong rule or scale gives gaps of order 1.
    """
    pgrads = dict(pm.named_parameters())
    gaps = {}
    for name, p in km.named_parameters():
        if not float(p.grad.abs().sum()) > 0:
            raise AssertionError(f"{what} {name}: no gradient through the "
                                 f"kernels")
        ref = pgrads[name].grad
        gaps[name] = float((p.grad - ref).norm() / ref.norm())
    bad = {k: v for k, v in gaps.items() if v > 2e-2}
    if bad:
        raise AssertionError(f"{what}: gradients differ (relative L2, "
                             f"kernel vs plain): {bad}")
    return gaps


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
                 dict(launches_per(kind, "train"), ball_query=0, fps=0))
    check_counts("plain train step", pcounts, dict.fromkeys(wrappers, 0))
    # f32 throughout (TF32 off); the kernels sum neighborhoods in slot
    # order and scatter with atomics where the plain path sums by ATen's
    # reductions and index scatter
    if abs(kloss - ploss) > 1e-5 * abs(ploss):
        raise AssertionError(f"train-step loss: kernel {kloss}, plain {ploss}")
    gaps = _grad_gaps(f"train-parity:{kind}", km, pm)
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


def phase_eval_grad_parity(tcfg, wrappers, kind: str) -> dict:
    """The gradient of an eval-mode f32 forward (frozen BatchNorm
    statistics, as in fine-tuning a served model) through the kernels vs
    through the plain versions: the path on which the eval-mode forward's
    backward kernels run. Seeded weights with non-trivial BatchNorm state;
    a third of each point-wise MLP BN scale is negative, so both the max
    and the min branch carry gradient."""
    from closerlook3d_tpu_torch.models import build_classification
    from closerlook3d_tpu_torch.models.backbone import compute_geometry

    cfg = copy.deepcopy(tcfg)
    cfg.precision = "f32"
    cfg.dropout_rate = 0.0
    batch = train_batch(cfg, SEED + 450)
    batch["mask"][1, cfg.num_points * 7 // 10:] = False  # a padded cloud
    dev = torch.device(DEVICE)
    t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    with torch.no_grad():
        geometry = compute_geometry(cfg, t["xyz"], t["mask"])
    weights = seeded_weights(cfg, torch.Generator().manual_seed(SEED + 7))
    for name, w in weights.items():
        if ".pw_bns." in name and name.endswith(".weight"):
            w[1::3] = -w[1::3]
    runs = {}
    for route in ("kernel", "plain"):
        model, loss_fn = build_classification(cfg)
        model.load_state_dict(weights)
        model = model.to(dev).eval()
        reset_counts(wrappers)
        with (plain_route() if route == "plain"
              else contextlib.nullcontext()):
            logits = model(t["xyz"], t["mask"], t["features"],
                           geometry=geometry)
            loss = loss_fn(logits, t["label"])
            loss.backward()
        torch.cuda.synchronize()
        runs[route] = (model, loss.item(), read_counts(wrappers))
    (km, kloss, kcounts), (pm, ploss, pcounts) = runs["kernel"], runs["plain"]
    check_counts("eval-mode gradient (geometry given)", kcounts,
                 dict(launches_per(kind, "eval_grad"), ball_query=0, fps=0))
    check_counts("plain eval-mode gradient", pcounts,
                 dict.fromkeys(wrappers, 0))
    if abs(kloss - ploss) > 1e-5 * abs(ploss):
        raise AssertionError(f"eval-mode loss: kernel {kloss}, plain "
                             f"{ploss}")
    gaps = _grad_gaps(f"eval-grad:{kind}", km, pm)
    n = len(gaps)
    median = sorted(gaps.values())[n // 2]
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    log(f"eval-grad:{kind}", f"f32 eval-mode forward + backward, kernels vs "
        f"plain: loss {kloss:.6f} vs {ploss:.6f}; all {n} parameters have a "
        f"nonzero gradient; relative L2 gradient gap median {median:.3g}, "
        f"worst " + ", ".join(f"{k} {v:.3g}" for k, v in worst)
        + f"; launches {kcounts}")
    return {"loss_kernel": kloss, "loss_plain": ploss, "grad_rel_l2": gaps,
            "grad_rel_l2_median": median, "launches": kcounts}


def _train_steps(step, state, batch, per_step, wrappers, what,
                 steps: int = TRAIN_STEPS) -> dict:
    """``steps`` steps on one batch, each with exactly the launches of
    ``per_step``, timed by CUDA events and the host clock; the loss and
    every gradient must stay finite, and over TRAIN_STEPS steps the loss
    must fall (the mean of the last three steps under that of the first
    three; six steps at a file's learning rate need not lower it over
    hundreds of part logits). {"losses", "accs", "step_ms", "host_ms",
    "launches" (summed), "peak_gib"}."""
    totals = dict.fromkeys(wrappers, 0)
    losses, accs, step_ms, host_ms = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
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
        check_counts(f"{what} train step {i}", counts, per_step)
        for k in totals:
            totals[k] += counts[k]
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["acc"]))
        gnorm = torch.stack([p.grad.float().norm()
                             for p in state.model.parameters()])
        if not (np.isfinite(losses[-1]) and torch.isfinite(gnorm).all()):
            raise AssertionError(f"{what} step {i}: loss {losses[-1]} or a "
                                 f"gradient is not finite")
    if (steps >= TRAIN_STEPS
            and not np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"{what}: the loss did not fall over "
                             f"{steps} steps: {losses}")
    return {"losses": losses, "accs": accs, "step_ms": step_ms,
            "host_ms": host_ms, "launches": totals,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


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
    per_step = launches_per(kind, "train")
    run = _train_steps(step, state, batch, per_step, wrappers, kind)
    losses, accs, peak = run["losses"], run["accs"], run["peak_gib"]
    phase = f"training:{kind}"
    log(phase, f"{TRAIN_STEPS} bf16 steps, batch {cfg.batch_size} x "
        f"{cfg.num_points} points, lr {lr(0):g}: loss "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; acc {accs[-1]:.3f}; launches per step "
        + str({k: n for k, n in per_step.items() if n})
        + f"; peak memory {peak:.2f} GiB")

    per_forward = launches_per(kind, "forward")
    reset_counts(wrappers)
    logits, emetrics = make_eval_step(loss_fn, cfg.task)(state, batch)
    torch.cuda.synchronize()
    eval_counts = read_counts(wrappers)
    check_counts("eval step", eval_counts, per_forward)
    if (tuple(logits.shape) != (cfg.batch_size, cfg.num_classes)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"eval logits {tuple(logits.shape)} not finite")
    predictor = Predictor(cfg, state.model.state_dict(), device=DEVICE)
    reset_counts(wrappers)
    served = predictor(batch["xyz"], batch["mask"], batch["features"])
    torch.cuda.synchronize()
    request_counts = read_counts(wrappers)
    check_counts("Predictor at the config", request_counts, per_forward)
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
    return {"state": state, "step": step, "batch": batch,
            "predictor": predictor, **run, "eval_launches": eval_counts,
            "request_launches": request_counts,
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


def _is_device_op(e) -> bool:
    """A profiled event that is work on the device (a kernel, memset or
    copy): not a host event, and not a user annotation such as
    ``Optimizer.step#SGD.step``, whose device-side span runs from its
    first kernel to its last, host launch gaps included."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _device_time(fn, inputs, reps: int, per_op=None):
    """(ms, device ops) per call on the device, from torch.profiler over
    ``reps`` calls cycling through ``inputs``: the mean duration of each
    distinct device kernel, memset or copy, times the number of times a
    call runs it (its events over ``reps``, rounded, at least 1), summed
    over them, and the number of ops a call. The mean, not the sum over
    ``reps``, because a profile can miss some of a window's events; raises
    if an op ran more often than that. Each window opens with a warm-up
    step, one call traced and discarded: the first device events after
    tracing starts can go missing (a whole call's leading ops, on the
    H100). Unlike ``_time`` it leaves out the host's launch path and the
    gaps between launches. A dict given as ``per_op`` receives each op's
    ms a call by name."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for a in inputs:  # warm-up
        fn(*a)
    torch.cuda.synchronize()
    spans = {}
    for _ in range(3):  # a window whose device events all went missing
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn(*inputs[0])
            torch.cuda.synchronize()
            prof.step()
            for i in range(reps):
                fn(*inputs[i % len(inputs)])
            torch.cuda.synchronize()
            prof.step()
        for e in prof.events():
            if _is_device_op(e):
                spans.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        if spans:
            break
    times = {n: max(1, round(len(d) / reps)) for n, d in spans.items()}
    if not spans or any(len(d) > times[n] * reps for n, d in spans.items()):
        raise AssertionError(
            f"{getattr(fn, '__name__', fn)}: device ops recorded over {reps} "
            f"calls: { {n: len(d) for n, d in spans.items()} }")
    ms = {n: times[n] * sum(d) / len(d) / 1e3 for n, d in spans.items()}
    if per_op is not None:
        per_op.update(ms)
    return sum(ms.values()), sum(times.values())


def _device_pair(fn_a, ins_a, fn_b, ins_b, reps: int):
    """``_device_time`` of two functions read in turns (a, b, b, a):
    ((ms, ops) of a, (ms, ops) of b), each the mean of its two
    readings."""
    a1, b1, b2, a2 = (_device_time(fn, ins, reps) for fn, ins in (
        (fn_a, ins_a), (fn_b, ins_b), (fn_b, ins_b), (fn_a, ins_a)))
    return (((a1[0] + a2[0]) / 2, a1[1]), ((b1[0] + b2[0]) / 2, b1[1]))


def empty_launch():
    """One launch of an empty kernel (``cl3d_empty`` of
    ``csrc/gather_reduce.cu``) on the current stream: the floor under any
    kernel's device time."""
    from closerlook3d_tpu_torch.ops import kernels

    lib, fn = kernels.entry("gather_reduce", "cl3d_empty", [kernels.P])
    kernels.check(lib, fn(torch.cuda.current_stream().cuda_stream),
                  "cl3d_empty")


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
    """Union of the intervals of device ops (us) in the trace."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if _is_device_op(e))
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


def _top_kernels(prof, n: int, rows: int = 15) -> list:
    """The ``rows`` device kernels with the most time in a profile of ``n``
    runs, per run (device kernels only: an ATen op's entry repeats its
    kernels' time)."""
    avgs = sorted((e for e in prof.key_averages() if _device_us(e) > 0
                   and _is_device_op(e)),
                  key=_device_us, reverse=True)
    return [{"name": e.key[:90], "ms_per_run": _device_us(e) / n / 1e3,
             "calls_per_run": e.count / n} for e in avgs[:rows]]


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
    multiply-adds and its add). Sin/cos adds per (coordinate,
    frequency) pair the angle's multiply and divide and one operation
    each for sin and cos."""
    return {"xyz": 6 + 2 * c, "sincos": 6 + 2 * c + 4 * (c // 2),
            "adaptive": 6 + 7 * c}[kind]


# f32 operations per valid slot and channel of the point-wise MLP's
# kernels: K6 forward a max and a min compare and two adds; its backward
# two compares to count the ties, two to route, two adds and two atomic
# adds; K7 forward a subtraction and two compares; its backward that
# twice (count, then route; the adds and atomics of the few extremal
# slots are not counted)
PWMLP_FLOPS_PER_SLOT = {"pwmlp_stats": 4, "pwmlp_stats_bwd": 8,
                        "gather_sub_minmax": 3, "gather_sub_minmax_bwd": 6}


def _pwmlp_cases(calls, gen):
    """``_kernel_cases`` for the point-wise MLP config: K6 forward and
    backward per train step, K7 forward and backward per eval-mode forward
    (and its backward), on bf16 projections and f32 cotangents."""
    from closerlook3d_tpu_torch.ops import gather_reduce as gr

    bf, f32 = torch.bfloat16, torch.float32
    cases = {k: [] for k in PWMLP_FLOPS_PER_SLOT}
    for i, (name, _, c, count) in enumerate(calls[0][2]):
        ins = {k: [] for k in cases}
        for cs in calls:
            q, s, idx, nmask, _ = cs[2][i][1]
            g32 = _features(gen, s, c, f32)
            g, gsq = g32.to(bf), (g32 * g32).to(bf)
            d = _features(gen, q, c, bf)
            cot = [_features(gen, q, c, f32) for _ in range(4)]
            gmax, gmin, _, _ = gr.pwmlp_minmax_stats_cuda(g, gsq, idx, nmask)
            hmax, hmin = gr.gather_sub_minmax_cuda(g, d, idx, nmask)
            ins["pwmlp_stats"].append((g, gsq, idx, nmask))
            ins["pwmlp_stats_bwd"].append((g, idx, nmask, gmax, gmin, *cot))
            ins["gather_sub_minmax"].append((g, d, idx, nmask))
            ins["gather_sub_minmax_bwd"].append(
                (g, d, idx, nmask, hmax, hmin, *cot[:2]))
        g, gsq, idx, nmask = ins["pwmlp_stats"][0]
        d = ins["gather_sub_minmax"][0][1]
        out = _nbytes(d) * 2  # one f32 [B, Nq, C] output
        # bytes: inputs read once, outputs written once (forward outputs
        # f32; gradients in the projections' dtype)
        nbytes = {"pwmlp_stats": _nbytes(g, gsq, idx, nmask) + 4 * out,
                  "pwmlp_stats_bwd": _nbytes(*ins["pwmlp_stats_bwd"][0])
                  + 2 * _nbytes(g),
                  "gather_sub_minmax": _nbytes(g, d, idx, nmask) + 2 * out,
                  "gather_sub_minmax_bwd": _nbytes(
                      *ins["gather_sub_minmax_bwd"][0]) + _nbytes(g, d)}
        valid = float(nmask.sum()) * c
        for k, rows in cases.items():
            op = k.replace("pwmlp_stats", "pwmlp_minmax_stats")
            rows.append((name, count, getattr(gr, f"{op}_cuda"),
                         getattr(gr, f"{op}_plain"), ins[k],
                         (nbytes[k], valid * PWMLP_FLOPS_PER_SLOT[k])))
    return cases


def pgrid_flops_per_slot(kpn: int, c: int, backward: bool) -> int:
    """f32 operations per valid slot of a pseudo-grid call with C input
    channels and Kp kernel points: u (3 subtractions, 3 multiplies); per
    kernel point d2 (3 subtractions, 3 multiplies, 2 adds) and the
    influence (about 4: sqrt, multiply, subtract, max); per kernel point
    and channel one multiply-add (2); the backward adds one atomic add per
    channel."""
    return 6 + 12 * kpn + 2 * kpn * c + (c if backward else 0)


def _pgrid_cases(tcfg, calls, gen):
    """``_kernel_cases`` for the pseudo-grid config: K10 forward and
    backward per train step, bf16, the config's linear influence."""
    from closerlook3d_tpu_torch.ops import pseudo_grid as pg

    bf = torch.bfloat16
    kp, extent = pgrid_geometry(tcfg, DEVICE)
    kpn = kp.shape[0]
    mode = tcfg.pseudo_grid.KP_influence
    cases = {"pseudo_grid": [], "pseudo_grid_bwd": []}
    for i, (name, _, c, count) in enumerate(calls[0][2]):
        fwd, bwd = [], []
        for cs in calls:
            q, s, idx, nmask, r = cs[2][i][1]
            f = _features(gen, s, c, bf)
            dy = _features(gen, q, kpn * c, bf)
            fwd.append((q, s, f, idx, nmask, kp, r, extent, mode))
            bwd.append((q, s, idx, nmask, kp, dy, r, extent, mode))
        q, s, f, idx, nmask = fwd[0][:5]
        dy = bwd[0][5]
        valid = float(nmask.sum())
        # bytes: inputs read once, the output written once (dy has the
        # forward output's size, f the backward's)
        cases["pseudo_grid"].append((
            name, count, pg.pseudo_grid_cuda, pg.pseudo_grid_plain, fwd,
            (_nbytes(q, s, f, idx, nmask, kp, dy),
             valid * pgrid_flops_per_slot(kpn, c, False))))
        cases["pseudo_grid_bwd"].append((
            name, count, pg.pseudo_grid_bwd_cuda, pg.pseudo_grid_bwd_plain,
            bwd, (_nbytes(q, s, idx, nmask, kp, dy, f),
                  valid * pgrid_flops_per_slot(kpn, c, True))))
    return cases


def _kernel_cases(tcfg, calls, gen, kind: str):
    """{kernel: [(call name, per step, kernel fn, plain fn, inputs per
    input set, (bytes, flops) of the first set)]} for one train step of
    the ``kind`` config: its aggregation kernels (the point-wise MLP's K7
    per eval-mode forward instead), and for the xyz config the geometry
    kernels and the neighborhood max too, where ``calls`` hold the
    geometry's calls (not None)."""
    from closerlook3d_tpu_torch.ops import grouping as grp
    from closerlook3d_tpu_torch.ops import neighbors as nbr
    from closerlook3d_tpu_torch.ops import sampling as smp
    from closerlook3d_tpu_torch.ops.aggregation import sincos_freq

    if kind == "pwmlp":
        return _pwmlp_cases(calls, gen)
    if kind == "pgrid":
        return _pgrid_cases(tcfg, calls, gen)
    bf = torch.bfloat16
    (fwd_name, bwd_name), _ = AGG_KERNELS[kind]
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
    if kind != "xyz" or calls[0][0] is None:
        return cases
    cases.update({k: [] for k in ("ball_query", "fps", "neighborhood_max",
                                  "neighborhood_max_bwd")})
    for i, (name, a) in enumerate(calls[0][0]):
        bound = bq_bound(a)
        cases["ball_query"].append((
            name, 1, nbr.ball_query_cuda, nbr.ball_query_plain,
            [c[0][i][1] for c in calls], (bound["bytes"], bound["flops"])))
    for i, (name, a) in enumerate(calls[0][1]):
        xyz, npoint, m = a
        cases["fps"].append((
            name, 1, smp.furthest_point_sample_cuda,
            smp.furthest_point_sample_plain, [c[1][i][1] for c in calls],
            (_nbytes(xyz, m) + xyz.shape[0] * npoint * 5,
             9.0 * npoint * float(m.sum()))))
    cases.update(_max_cases(tcfg, [cs[2] for cs in calls], gen))
    return cases


def _max_cases(tcfg, pps, gen):
    """{"neighborhood_max": rows, "neighborhood_max_bwd": rows} as
    ``_kernel_cases`` gives them, at the strided calls of ``pps`` (the
    PosPool calls of each input set, ``path_calls`` or ``seg_calls``), on
    ``_tie_features``."""
    from closerlook3d_tpu_torch.ops import grouping as grp

    bf = torch.bfloat16
    cases = {"neighborhood_max": [], "neighborhood_max_bwd": []}
    per_set = [max_calls(tcfg, pp) for pp in pps]
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


def _step_timing(cfg, training, phase) -> dict:
    """A training run's bf16 step: the median by CUDA events over its
    steps after the first three (warm-up), the host clock's, and a
    torch.profiler split of 3 more steps (device busy, idle share, top
    kernels)."""
    step_ms = sorted(training["step_ms"][3:])
    host_ms = sorted(training["host_ms"][3:])
    med, hmed = step_ms[len(step_ms) // 2], host_ms[len(host_ms) // 2]
    state, step, batch = (training["state"], training["step"],
                          training["batch"])
    nsteps = 3
    prof, split = _profiled(lambda: step(state, batch, SEED), nsteps, med)
    split["top"] = _top_kernels(prof, nsteps)
    pts = cfg.batch_size * cfg.num_points
    log(phase, f"train step (batch {cfg.batch_size} x {cfg.num_points} "
        f"points, bf16, batch copy included): median {med:.3f} ms by CUDA "
        f"events over {len(step_ms)} steps (host clock {hmed:.3f} ms); "
        f"{pts / (med / 1e3):.0f} points/s; peak memory "
        f"{training['peak_gib']:.2f} GiB")
    log(phase, f"profiled {nsteps} steps: wall "
        f"{split['wall_ms_profiled']:.3f} ms/step, device busy "
        f"{split['device_busy_ms']:.3f} ms/step (idle "
        f"{100 * split['device_idle_share']:.1f}% of the profiled wall; "
        f"{100 * split['device_idle_share_est']:.1f}% of the unprofiled "
        f"median, an estimate)")
    for row in split["top"]:
        log(phase, f"  {row['ms_per_run']:9.4f} ms "
            f"{row['calls_per_run']:6.1f} calls/step  {row['name']}")
    return {"step_ms_median": med, "step_ms_all": training["step_ms"],
            "host_ms_median": hmed, "points_per_s": pts / (med / 1e3),
            "split": split}


def _timing_calls(tcfg) -> list:
    """``path_calls`` of three seeded batches (distinct inputs per
    launch), the kernel inputs the timing phases take."""
    dev = torch.device(DEVICE)
    calls = []
    for r in range(3):
        b = make_batch(SEED + 600 + r, batch=tcfg.batch_size,
                       points=tcfg.num_points)
        calls.append(path_calls(tcfg, torch.from_numpy(b["xyz"]).to(dev),
                                torch.from_numpy(b["mask"]).to(dev)))
    return calls


# device ops a call of the redesigned kernels: the forwards and FPS one
# kernel, the backward gathers two (the reverse index, then the gather)
DEVICE_OPS = {"pospool_xyz": 1, "pospool_sincos": 1, "moments": 1,
              "pwmlp_stats": 1, "pseudo_grid": 1, "neighborhood_max": 1,
              "gather_sub_minmax": 1, "pospool_xyz_bwd": 2,
              "pospool_sincos_bwd": 2, "moments_bwd": 2,
              "pwmlp_stats_bwd": 2, "pseudo_grid_bwd": 2, "fps": 1,
              "neighborhood_max_bwd": 2, "gather_sub_minmax_bwd": 2}


def phase_device_timing() -> dict:
    """Every kernel row of every train config (``_kernel_cases``, the
    inputs of ``phase_train_timing``) by device time (``_device_time``),
    per call and per step, and the device ops a call, and the k-NN per
    upsample call of each segmentation request (the inputs of
    ``phase_seg_timing``); run right after the build, as
    ``phase_k13_timing``. Fails where a kernel of ``DEVICE_OPS`` runs
    another number of device ops a call."""
    out = {}
    for kind in TRAIN_KINDS:
        tcfg = train_config(kind)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
        out[kind] = {}
        for kernel, rows in _kernel_cases(tcfg, _timing_calls(tcfg), gen,
                                          kind).items():
            calls = []
            for name, count, fn, _, ins, _ in rows:
                ms, ops = _device_time(fn, ins, 20)
                calls.append({"call": name, "per_step": count,
                              "device_ms": ms, "device_ops_per_call": ops})
            t = out[kind][kernel] = {
                "calls": calls,
                "device_ms": sum(r["device_ms"] * r["per_step"]
                                 for r in calls),
                "device_ops_per_call": max(r["device_ops_per_call"]
                                           for r in calls)}
            log("device-timing", f"{kind} {kernel}: {t['device_ms']:.5f} ms "
                f"a step, {t['device_ops_per_call']} device ops a call ("
                + ", ".join(f"{r['call']} {r['device_ms']:.5f}"
                            for r in calls) + ")")
            want = DEVICE_OPS.get(kernel)
            for r in calls:
                if want and r["device_ops_per_call"] != want:
                    raise AssertionError(
                        f"{kind} {kernel}: {r['device_ops_per_call']:g} "
                        f"device ops a call at {r['call']}, expected {want}")
        torch.cuda.empty_cache()
    from closerlook3d_tpu_torch.ops.neighbors import knn_device_ops

    for name in SEG_NAMES:  # the k-NN, per upsample call of a request
        ups = _knn_calls(seg_config(name))
        out[f"knn:{name}"] = []
        for i, (call, a) in enumerate(ups[0]):
            ms, ops = _device_time(_knn_route(*a), [u[i][1] for u in ups], 20)
            want = knn_device_ops(a[1].shape[1], a[2])
            if ops != want:
                raise AssertionError(
                    f"knn {name} {call}: {ops:g} device ops a call, its "
                    f"route launches {want}")
            out[f"knn:{name}"].append(ms)
        log("device-timing", f"knn {name}: "
            + ", ".join(f"{ms:.5f}" for ms in out[f"knn:{name}"])
            + " ms a call")
    return out


def phase_train_timing(tcfg, training, kind: str, device: dict) -> dict:
    """Each kernel per train step of the config (bf16) against its plain
    version and its bound, with its device time from ``device`` (the
    config's entry of ``phase_device_timing``); the step's median time and
    device split."""
    dev = torch.device(DEVICE)
    calls = _timing_calls(tcfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    per_kernel = {}
    phase = f"train-timing:{kind}"
    for kernel, rows in _kernel_cases(tcfg, calls, gen, kind).items():
        out = []
        for i, (name, count, fn, plain, ins, (nbytes, flops)) in enumerate(
                rows):
            ms, plain_ms = _time(fn, ins, 20), _time(plain, ins, 3)
            dev = device[kernel]["calls"][i]
            device_ms, ops = dev["device_ms"], dev["device_ops_per_call"]
            bound_ms, bound_by = _bound(nbytes, flops)
            out.append({"call": name, "per_step": count, "ms": ms,
                        "device_ms": device_ms, "device_ops_per_call": ops,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bytes": nbytes,
                        "flops": flops})
            log(phase, f"{kernel} {name} x{count}: kernel "
                f"{ms:.4f} ms (device {device_ms:.5f} ms in {ops} ops), "
                f"plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.3f} GFLOP)")
        bound_time = {}
        for r in out:
            bound_time[r["bound_by"]] = (bound_time.get(r["bound_by"], 0.0)
                                         + r["bound_ms"] * r["per_step"])
        per_kernel[kernel] = {
            "calls": out,
            "ms": sum(r["ms"] * r["per_step"] for r in out),
            "device_ms": sum(r["device_ms"] * r["per_step"] for r in out),
            "device_ops_per_call": max(r["device_ops_per_call"]
                                       for r in out),
            "plain_ms": sum(r["plain_ms"] * r["per_step"] for r in out),
            "bound_ms": sum(bound_time.values()),
            "bound_by": max(bound_time, key=bound_time.get)}
        t = per_kernel[kernel]
        log(phase, f"{kernel} per step: kernel {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.5f} ms), plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")

    out = _step_timing(tcfg, training, phase)
    predictor, rmed = training["predictor"], training["request_ms_median"]
    batch = training["batch"]
    _, rsplit = _profiled(lambda: predictor(batch["xyz"], batch["mask"],
                                            batch["features"]), 5, rmed)
    log(phase, f"profiled 5 requests: wall {rsplit['wall_ms_profiled']:.3f} "
        f"ms/request, device busy {rsplit['device_busy_ms']:.3f} ms/request "
        f"(idle {100 * rsplit['device_idle_share']:.1f}% of the profiled "
        f"wall; {100 * rsplit['device_idle_share_est']:.1f}% of the "
        f"unprofiled median {rmed:.3f} ms, an estimate)")
    return {"per_kernel": per_kernel, **out, "request_ms_median": rmed,
            "request_split": rsplit}


# ---- segmentation serving ---------------------------------------------------

SEG_NAMES = ("shapenetpart", "s3dis")


def seg_batch(cfg, seed: int, padded=(), all_masked=(), duplicated=(),
              batch: int = 0, sort: bool = True) -> dict:
    """Morton-sorted synthetic clouds of the config's task, as the data
    loader feeds them (in the generators' order with ``sort`` false):
    two-category part shapes (part segmentation) or rooms with colors
    (scene segmentation), with the config's input features. Clouds listed
    in ``padded`` keep their first 70% of points, those in ``all_masked``
    none, and those in ``duplicated`` repeat their first 10% of points
    right after them (exact distance ties)."""
    from closerlook3d_tpu_torch.data.loader import build_features
    from closerlook3d_tpu_torch.data.spatial_host import morton_sort_batch
    from closerlook3d_tpu_torch.data.synthetic import (
        SyntheticPartSegmentation, SyntheticSceneSegmentation)

    nb, n = batch or cfg.batch_size, cfg.num_points
    make = (SyntheticPartSegmentation if cfg.task == "part_segmentation"
            else SyntheticSceneSegmentation)
    ds = make(nb, n, seed=seed)
    samples = [ds[i] for i in range(nb)]
    out = {k: np.stack([sm[k] for sm in samples]) for k in samples[0]}
    keep, span = n * 7 // 10, n // 10
    for i in padded:
        out["mask"][i, keep:] = False
    for i in all_masked:
        out["mask"][i] = False
    for i in duplicated:
        for k in ("xyz", "rgb"):
            if k in out:
                out[k][i, span:2 * span] = out[k][i, :span]
    out["features"] = build_features(out, cfg.input_features)
    return morton_sort_batch(out) if sort else out


def config_kind(cfg) -> str:
    """The config's aggregation, as ``AGG_KERNELS`` names it."""
    agg = cfg.local_aggregation_type
    if agg == "pospool":
        return "xyz" if cfg.pospool.position_embedding == "xyz" else "sincos"
    return {"adaptive_weight": "adaptive", "pointwisemlp": "pwmlp",
            "pseudo_grid": "pgrid"}[agg]


def seg_launches(cfg) -> dict:
    """Exact launches of every kernel in one segmentation request: the
    encoder's (a ball query per stage and per stage transition, FPS
    between stages unless the config samples by grid, the eval forward's
    aggregation kernels at every call of ``agg_calls_per_stage``, a
    shortcut maximum per stage transition) and the decoder's 1-NN per
    stage, on the route of the JAX package's chunked 1-NN for supports of
    >= 1024 points, else on that of its k-NN."""
    from closerlook3d_tpu_torch.ops.neighbors import KNN1_CHUNKED_MIN_SUPPORT
    from closerlook3d_tpu_torch.utils.config import stage_plan

    npoints = stage_plan(cfg)["npoints"]
    transitions = len(npoints) - 1
    counts = dict.fromkeys(kernel_wrappers(), 0)
    counts.update(ball_query=1 + 2 * transitions,
                  neighborhood_max=transitions,
                  fps=transitions if cfg.sampling == "fps" else 0)
    for name in agg_kernels(config_kind(cfg), "forward"):
        counts[name] += sum(agg_calls_per_stage(cfg))
    for ns in npoints[1:]:
        counts["knn1" if ns >= KNN1_CHUNKED_MIN_SUPPORT else "knn"] += 1
    return counts


def seg_calls(cfg, g):
    """The kernel calls of one segmentation forward, from its geometry
    ``g`` (``compute_geometry(need_up=True)`` on the card): (ball-query
    calls, PosPool calls as ``path_calls`` gives them, upsample k-NN calls
    (name, (query xyz, support xyz, k, support mask)))."""
    from closerlook3d_tpu_torch.utils.config import stage_plan

    plan = stage_plan(cfg)
    radii, ks, widths = plan["radii"], plan["nsamples"], plan["widths"]
    x0, m0 = g["xyz_0"], g["mask_0"]
    bq = [("s0", (x0, x0, radii[0], ks[0], m0, m0))]
    pp = [("s0", (x0, x0, g["idx_0"], g["nmask_0"], radii[0]),
           widths[0] // 2, 2)]
    for s in range(1, len(ks)):
        xs, ms, xp, mp = g[f"xyz_{s}"], g[f"mask_{s}"], g[f"xyz_{s - 1}"], \
            g[f"mask_{s - 1}"]
        bq += [(f"s{s}-strided", (xs, xp, radii[s - 1] * 2.0, ks[s - 1], ms,
                                  mp)),
               (f"s{s}", (xs, xs, radii[s], ks[s], ms, ms))]
        pp += [(f"s{s}-strided", (xs, xp, g[f"sidx_{s}"], g[f"smask_{s}"],
                                  radii[s - 1] * 2.0), widths[s] // 2, 1),
               (f"s{s}", (xs, xs, g[f"idx_{s}"], g[f"nmask_{s}"], radii[s]),
                widths[s] // 2, cfg.depth)]
    up = [(f"up{s}", (g[f"xyz_{s}"], g[f"xyz_{s + 1}"], 1,
                      g[f"mask_{s + 1}"])) for s in range(len(ks) - 1)]
    return bq, pp, up


def _knn_route(q, s, k, smask):
    """The wrapper ``ops/neighbors.py::knn`` launches for these inputs."""
    from closerlook3d_tpu_torch.ops import neighbors as nbr

    if k == 1 and s.shape[1] >= nbr.KNN1_CHUNKED_MIN_SUPPORT:
        return nbr.knn1_cuda
    return nbr.knn_cuda


def _knn_err(what, got, ref) -> float:
    """Indices equal and d2 equal to the bit, or raise; returns 0."""
    (ki, kd), (pi, pd) = got, ref
    torch.cuda.synchronize()
    if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
        bad = (ki != pi) | (kd != pd)
        raise AssertionError(
            f"{what}: kernel and plain disagree at {int(bad.sum())} slots, "
            f"first {bad.nonzero()[:4].tolist()}")
    return 0.0


def phase_seg_kernel_parity(cfg, name: str) -> dict:
    """The k-NN kernel against its plain version at every upsample call of
    a segmentation forward (k = 1 on the route the forward takes, then k =
    3, and k = 16 > Ns on a 10-point support), and the ball query, PosPool
    xyz and the neighborhood max at this config's shapes; a padded, an
    all-masked (its supports all masked at every stage) and a duplicated
    cloud. {kernel: max abs err}."""
    from closerlook3d_tpu_torch.models.backbone import compute_geometry
    from closerlook3d_tpu_torch.ops.aggregation import (
        pospool_xyz_cuda, pospool_xyz_plain)
    from closerlook3d_tpu_torch.ops.grouping import (
        neighborhood_max_cuda, neighborhood_max_plain)
    from closerlook3d_tpu_torch.ops.neighbors import MAX_KNN, knn_plain

    dev = torch.device(DEVICE)
    nb = cfg.batch_size
    b = seg_batch(cfg, SEED + 800, padded=(nb - 4,), all_masked=(nb - 3,),
                  duplicated=(nb - 2, nb - 1))
    with torch.no_grad():
        g = compute_geometry(cfg, torch.from_numpy(b["xyz"]).to(dev),
                             torch.from_numpy(b["mask"]).to(dev),
                             need_up=True)
    bq, pp, up = seg_calls(cfg, g)
    phase = f"seg-parity:{name}"
    errs = dict(_geometry_parity(bq, []), knn=0.0, pospool_xyz=0.0,
                neighborhood_max=0.0)
    del errs["fps"]
    for call, (q, s, _, sm) in up:
        cases = [(call, q, s, 1, sm), (call + " k=3", q, s, 3, sm),
                 (call + f" k={MAX_KNN} on 10 supports", q,
                  s[:, :10].contiguous(), MAX_KNN, sm[:, :10].contiguous())]
        for what, qq, ss, k, mm in cases:
            fn = _knn_route(qq, ss, k, mm)
            errs["knn"] = max(errs["knn"], _knn_err(
                f"knn {what}", fn(qq, ss, k, mm), knn_plain(qq, ss, k, mm)))
            log(phase, f"knn {what} q{tuple(qq.shape)} s{tuple(ss.shape)} "
                f"({fn.__name__}): idx equal, d2 equal to the bit "
                f"({int(mm.sum())} valid supports)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for call, (q, s, idx, nmask, r), c, _ in pp:
        for dtype in (torch.float32, torch.bfloat16):
            f = _features(gen, s, c, dtype)
            got = pospool_xyz_cuda(q, s, f, idx, nmask, r, "avg").float()
            ref = pospool_xyz_plain(q, s, f, idx, nmask, r, "avg").float()
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref,
                                       **_pospool_fwd_tol(dtype, "avg"))
            err = float((got - ref).abs().max())
            errs["pospool_xyz"] = max(errs["pospool_xyz"], err)
            log(phase, f"pospool_xyz {call} C={c} K={idx.shape[2]} "
                f"{str(dtype)[6:]} avg: max abs err {err:.3g}")
    for call, (s, idx, nmask), c in max_calls(cfg, pp):
        for dtype in (torch.float32, torch.bfloat16):
            f = _tie_features(gen, s, c, dtype)
            errs["neighborhood_max"] = max(
                errs["neighborhood_max"],
                _max_err(f"neighborhood_max {call}",
                         neighborhood_max_cuda(f, idx, nmask),
                         neighborhood_max_plain(f, idx, nmask)))
            log(phase, f"neighborhood_max {call} C={c} {str(dtype)[6:]}: "
                f"equal")
    return errs


def phase_seg_serving(cfg, name: str, weights, wrappers) -> dict:
    """Requests through ``Predictor`` at the config's batch and points:
    per-point logits, exact launches per request, then 10 timed requests
    (host clock, ending in a synchronize), peak memory and a profiled
    device split."""
    from closerlook3d_tpu_torch.serving import Predictor

    predictor = Predictor(cfg, weights, device=DEVICE)
    nb, n = cfg.batch_size, cfg.num_points
    width = predictor.model.head.fc.out_features
    batches = [seg_batch(cfg, SEED + 900 + r, padded=(1,) if r else ())
               for r in range(2)]
    expected = seg_launches(cfg)
    totals = dict.fromkeys(wrappers, 0)
    for i, bt in enumerate(batches):
        reset_counts(wrappers)
        out = predictor(bt["xyz"], bt["mask"], bt["features"])
        torch.cuda.synchronize()
        counts = read_counts(wrappers)
        check_counts(f"{name} request {i}", counts, expected)
        for k in totals:
            totals[k] += counts[k]
        if (tuple(out.shape) != (nb, n, width) or out.dtype != torch.float32
                or not torch.isfinite(out).all()):
            raise AssertionError(f"{name} logits {tuple(out.shape)} "
                                 f"{out.dtype} not finite f32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = _request_latencies(predictor, batches, 10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = lat[len(lat) // 2]
    bt = batches[0]
    prof, split = _profiled(
        lambda: predictor(bt["xyz"], bt["mask"], bt["features"]), 3, med)
    split["top"] = _top_kernels(prof, 3, rows=10)
    phase = f"seg-serving:{name}"
    log(phase, f"{len(batches)} requests of {nb} x {n} points (bf16) "
        f"answered: per-point logits {(nb, n, width)} finite f32; launches "
        f"per request " + str({k: v for k, v in expected.items() if v}))
    log(phase, f"request median {med:.3f} ms over 10 (host clock incl. "
        f"input copy), min {lat[0]:.3f}, max {lat[-1]:.3f}; "
        f"{nb * n / (med / 1e3):.0f} points/s; peak memory {peak:.2f} GiB; "
        f"profiled 3 requests: wall {split['wall_ms_profiled']:.3f} ms, "
        f"device busy {split['device_busy_ms']:.3f} ms/request (idle "
        f"{100 * split['device_idle_share_est']:.1f}% of the unprofiled "
        f"median, an estimate)")
    for row in split["top"]:
        log(phase, f"  {row['ms_per_run']:9.4f} ms "
            f"{row['calls_per_run']:6.1f} calls/request  {row['name']}")
    return {"predictor": predictor, "batches": batches, "launches": totals,
            "launches_per_request": expected, "request_ms_median": med,
            "request_ms_all": lat, "points_per_s": nb * n / (med / 1e3),
            "peak_gib": peak, "split": split}


def phase_seg_forward_parity(cfg, name: str, weights, batch,
                             clouds: int) -> dict:
    """f32 per-point logits on the card (kernels) vs on the CPU (plain
    versions) for the first ``clouds`` clouds of a request (cloud 1
    padded); their geometry (grid barycenters and upsample indices
    included) must be equal."""
    from closerlook3d_tpu_torch.models.backbone import compute_geometry
    from closerlook3d_tpu_torch.serving import Predictor

    cfg32 = copy.deepcopy(cfg)
    cfg32.precision = "f32"
    part = {k: v[:clouds] for k, v in batch.items()}
    with torch.inference_mode():
        gg = compute_geometry(cfg32, torch.from_numpy(part["xyz"]).to(DEVICE),
                              torch.from_numpy(part["mask"]).to(DEVICE),
                              need_up=True)
        cg = compute_geometry(cfg32, torch.from_numpy(part["xyz"]),
                              torch.from_numpy(part["mask"]), need_up=True)
    for k in cg:
        if not torch.equal(gg[k].cpu(), cg[k]):
            raise AssertionError(f"{name} geometry {k}: card and CPU differ")
    lg = Predictor(cfg32, weights, device=DEVICE)(
        part["xyz"], part["mask"], part["features"]).cpu()
    lc = Predictor(cfg32, weights, device="cpu")(
        part["xyz"], part["mask"], part["features"])
    # f32 throughout (TF32 off); cuBLAS/ATen-CUDA and the CPU sum matmuls,
    # BN and PosPool neighborhoods in different orders through 15 blocks
    # and the decoder
    torch.testing.assert_close(lg, lc, rtol=1e-3, atol=1e-4)
    err = float((lg - lc).abs().max())
    log(f"seg-forward:{name}", f"f32 per-point logits {tuple(lc.shape)}, "
        f"card vs CPU plain: max abs err {err:.3g} (|logits| max "
        f"{float(lc.abs().max()):.3g}); geometry ({len(cg)} tensors, grid "
        f"and upsample indices included) equal")
    return {"max_abs_err": err, "clouds": clouds,
            "geometry_tensors": len(cg)}


def knn_library(q, s, k, smask):
    """PyTorch's own calls for the same function, the yardstick of the
    kernels line: ``torch.cdist`` squared plus the masked supports' bias,
    then a sorted ``torch.topk`` (ties in unspecified order)."""
    d2 = torch.cdist(q, s).square() + torch.where(smask, 0.0, 1e10)[:, None]
    return torch.topk(d2, k, dim=-1, largest=False, sorted=True)


def _knn_calls(cfg) -> list:
    """The upsample k-NN calls of three requests' geometry: [[(call,
    (q, s, k, support mask)), ...] per request]."""
    from closerlook3d_tpu_torch.models.backbone import compute_geometry

    dev = torch.device(DEVICE)
    ups = []
    for r in range(3):
        b = seg_batch(cfg, SEED + 1000 + r)
        with torch.no_grad():
            g = compute_geometry(cfg, torch.from_numpy(b["xyz"]).to(dev),
                                 torch.from_numpy(b["mask"]).to(dev),
                                 need_up=True)
        ups.append(seg_calls(cfg, g)[2])
    return ups


def knn_bound(q, s, k, smask) -> dict:
    """The k-NN's bound for one call: its bytes (points and mask read
    once, idx and d2 written once) over the HBM rate. The 1-NN prunes
    (``csrc/knn.cu``), so the all-pairs work is no longer the least the
    card must do; beside the bound, ``all_pairs_ms``: 9 f32 operations (3
    subtractions, 3 multiplies, 2 adds and the compare) per (query, valid
    support) pair over the f32 peak, the work of a scan that prunes
    nothing."""
    nbytes = _nbytes(q, s, smask) + q.shape[0] * q.shape[1] * k * 8
    pairs = float((smask.sum(1) * q.shape[1]).sum())
    bound_ms, bound_by = _bound(nbytes, 0.0)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "all_pairs": pairs, "all_pairs_ms": 9 * pairs / F32_FLOPS * 1e3}


def phase_seg_timing(cfg, name: str, device: list) -> dict:
    """The k-NN kernel per request (its 4 upsample calls) against its
    plain version, PyTorch's cdist + topk and its bound, with its device
    time per call from ``device`` (``phase_device_timing``); inputs from
    three requests' geometry."""
    from closerlook3d_tpu_torch.ops.neighbors import knn_plain

    ups = _knn_calls(cfg)
    rows = []
    for i, (call, (q, s, k, sm)) in enumerate(ups[0]):
        ins = [u[i][1] for u in ups]
        fn = _knn_route(q, s, k, sm)
        ms, plain_ms = _time(fn, ins, 20), _time(knn_plain, ins, 3)
        device_ms = device[i]
        lib_ms = _time(knn_library, ins, 3)
        bound = knn_bound(q, s, k, sm)
        rows.append({"call": call, "route": fn.__name__, "ms": ms,
                     "device_ms": device_ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms, **bound})
        log(f"seg-timing:{name}", f"knn {call} ({fn.__name__}) "
            f"q{tuple(q.shape)} s{tuple(s.shape)}: kernel {ms:.4f} ms "
            f"(device {device_ms:.5f}), plain "
            f"{plain_ms:.4f} ms, cdist+topk {lib_ms:.4f} ms, bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), all pairs "
            f"{bound['all_pairs_ms']:.4f} ms")
    tot = {key: sum(r[key] for r in rows)
           for key in ("ms", "device_ms", "plain_ms", "library_ms",
                       "bound_ms", "all_pairs_ms")}
    by = {}
    for r in rows:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
    tot["bound_by"] = max(by, key=by.get)
    log(f"seg-timing:{name}", f"knn per request: kernel {tot['ms']:.4f} ms "
        f"(device {tot['device_ms']:.5f}), "
        f"plain {tot['plain_ms']:.4f} ms, cdist+topk "
        f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
        f"({tot['bound_by']})")
    return {"calls": rows, **tot}


def run_segmentation(name: str, wrappers, device: list) -> dict:
    """Every segmentation phase of one config (``device``: the k-NN's
    device times from ``phase_device_timing``)."""
    cfg = seg_config(name)
    run = {"parity": phase_seg_kernel_parity(cfg, name)}
    weights = seeded_weights(cfg, torch.Generator().manual_seed(SEED + 20))
    serving = phase_seg_serving(cfg, name, weights, wrappers)
    run["serving"] = {k: v for k, v in serving.items()
                      if k not in ("predictor", "batches")}
    # the CPU's plain forward at 15000 points is slow: two S3DIS clouds
    run["forward_parity"] = phase_seg_forward_parity(
        cfg, name, weights, serving["batches"][1],
        clouds=2 if name == "s3dis" else 4)
    run["timing"] = phase_seg_timing(cfg, name, device)
    return run


# ---- segmentation training --------------------------------------------------

# The segmentation configs of configs/, each read from its file by
# ``file_config``, in the order they run: the two that train for
# TRAIN_STEPS, then PartNet's five (the only depth-3 models and
# 10000-point clouds of configs/), then S3DIS's and ShapeNetPart's others
CONFIG_RUNS = (
    "shapenetpart/pointwisemlp_dp_fi_df_fc1_max", "s3dis/pospool_xyz_avg",
    "partnet/pospool_xyz_avg", "partnet/pospool_sincos_avg",
    "partnet/adaptive_weight_dp_fc1_avg",
    "partnet/pointwisemlp_dp_fi_df_fc1_max", "partnet/pseudo_grid",
    "s3dis/pospool_sincos_avg", "s3dis/adaptive_weight_dp_fc1_avg",
    "s3dis/pointwisemlp_dp_fi_df_fc1_max", "s3dis/pseudo_grid",
    "shapenetpart/pospool_xyz_avg", "shapenetpart/pospool_sincos_avg",
    "shapenetpart/adaptive_weight_dp_fc1_avg", "shapenetpart/pseudo_grid")
# the runs of TRAIN_STEPS steps, whose loss must fall, by the names the
# timing tools give them; the others take CONFIG_STEPS
SEG_TRAIN_FILES = {
    "shapenetpart_pwmlp": "shapenetpart/pointwisemlp_dp_fi_df_fc1_max",
    "s3dis": "s3dis/pospool_xyz_avg"}
SEG_TRAIN_NAMES = tuple(SEG_TRAIN_FILES)
# bf16 steps of the other runs (the step's median over the last three)
CONFIG_STEPS = 6
# ShapeNetPart's and PartNet's configs train 32 clouds a step; split over
# four data-parallel ranks, each rank's step holds 8. Every run but
# ``PARTNET_FULL`` trains 8 clouds a step (S3DIS's files have 8), and every
# run's parity checks take 8: the f32 step through the plain versions,
# whose autograd through the plain gathers holds a [B, N, K, C] tensor a
# term
SEG_TRAIN_BATCH = 8
# the one run at its file's full batch, 32 x 10000 points
PARTNET_FULL = "partnet/pospool_xyz_avg"
# PartNet's per-category part counts come from its h5 files (the largest
# label of each category, plus one: data/partnet.py), which are not in the
# repository. A stand-in, not PartNet's own counts: 17 categories, as many
# as PartNet's fine-grained (level-3) segmentation benchmark has, of 4 to
# 51 parts, 268 part logits a point. No kernel's shape depends on them:
# they size the head's last layer and the loss's category slices
PARTNET_STANDIN_PARTS = (15, 9, 39, 11, 7, 4, 5, 10, 12, 10, 41, 6, 7, 24,
                         51, 11, 6)
# steps per epoch for the LR schedule: any count does, with warmup off
# the cosine moves the LR by < 1e-4 of itself over 15 steps
SEG_STEPS_PER_EPOCH = 2000
NSUM_KERNELS = ("neighborhood_sum", "neighborhood_sum_bwd")


def file_config(name: str):
    """``configs/<name>.yaml`` read by the port's ``load_config``, with
    the cuts of a config run: ``SEG_TRAIN_BATCH`` clouds a step but for
    ``PARTNET_FULL``, and PartNet's stand-in part counts."""
    from closerlook3d_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", name + ".yaml"))
    if name != PARTNET_FULL:
        cfg.batch_size = min(cfg.batch_size, SEG_TRAIN_BATCH)
    if cfg.datasets == "partnet":
        cfg.num_parts = list(PARTNET_STANDIN_PARTS)
    return cfg


def seg_train_config(name: str):
    """The config of a ``SEG_TRAIN_NAMES`` run, read from its file."""
    return file_config(SEG_TRAIN_FILES[name])


def agg_calls_per_stage(cfg) -> list:
    """Aggregation calls per stage of one forward: the stem's two at stage
    0, then per stage a strided block and ``depth`` blocks."""
    from closerlook3d_tpu_torch.utils.config import stage_plan

    return [2] + [1 + cfg.depth] * (len(stage_plan(cfg)["nsamples"]) - 1)


def seg_train_launches(cfg, kind: str, mode: str) -> dict:
    """Exact launches of every kernel in one train step (``mode`` "train")
    or eval step ("forward") of a segmentation config of aggregation
    ``kind``: the geometry of ``seg_launches``, a shortcut maximum per
    stage transition (and its backward), and per aggregation call the
    train step's kernels of ``AGG_KERNELS`` (for the point-wise MLP K6
    where the batch's queries B·Nq exceed 64 and K13 + K7 up to 64, the
    route of ``ops/gather_reduce.py::pwmlp_minmax_stats``), or the eval
    forward's."""
    from closerlook3d_tpu_torch.ops.gather_reduce import (
        K13_ROUTE_MAX_QUERIES)
    from closerlook3d_tpu_torch.utils.config import stage_plan

    counts = seg_launches(cfg)
    if mode == "forward":
        return counts
    for name in agg_kernels(kind, "forward"):
        counts[name] = 0
    counts["neighborhood_max_bwd"] = counts["neighborhood_max"]
    for ncalls, nq in zip(agg_calls_per_stage(cfg),
                          stage_plan(cfg)["npoints"]):
        if (kind == "pwmlp"
                and cfg.batch_size * nq <= K13_ROUTE_MAX_QUERIES):
            names = ["neighborhood_sum", "neighborhood_sum_bwd",
                     "gather_sub_minmax", "gather_sub_minmax_bwd"]
        else:
            names = agg_kernels(kind, "train")
        for n in names:
            counts[n] += ncalls
    return counts


def seg_train_batch(cfg, seed: int, **clouds) -> dict:
    """``seg_batch``'s clouds with training labels. Part segmentation
    draws each cloud's category over all of ShapeNetPart's (its
    ``NUM_PARTS``, 50 parts) and labels its points with global part ids of
    that category's slice by height bands, a function of the point that
    the loss can learn; scene segmentation keeps the room's labels and
    marks every 10th point of the first half of the clouds unannotated
    (``ignore_label`` -1)."""
    from closerlook3d_tpu_torch.models.build import part_counts

    b = seg_batch(cfg, seed, **clouds)
    nb, n = b["xyz"].shape[:2]
    rng = np.random.default_rng(seed)
    if cfg.task == "part_segmentation":
        parts = np.asarray(part_counts(cfg))
        starts = np.concatenate([[0], np.cumsum(parts)[:-1]])
        cats = (rng.permutation(len(parts))[:nb] if nb <= len(parts)
                else rng.integers(0, len(parts), nb))
        rank = b["xyz"][..., 2].argsort(1).argsort(1) / n
        count = parts[cats][:, None]
        band = np.minimum((rank * count).astype(np.int64), count - 1)
        b["category"] = cats.astype(np.int32)
        b["labels"] = (starts[cats][:, None] + band).astype(np.int32)
    else:
        b["labels"][:nb // 2, ::10] = -1
    return b


def fps_calls(cfg, g) -> list:
    """The FPS calls of one forward from its geometry ``g`` (none where
    the config samples by grid): (name, (points, npoint, mask))."""
    from closerlook3d_tpu_torch.utils.config import stage_plan

    if cfg.sampling != "fps":
        return []
    npoints = stage_plan(cfg)["npoints"]
    return [(f"s{s}", (g[f"xyz_{s - 1}"], npoints[s], g[f"mask_{s - 1}"]))
            for s in range(1, len(npoints))]


def _k13_calls(pp) -> list:
    """The aggregation calls of ``pp`` that take the K13 + K7 route."""
    from closerlook3d_tpu_torch.ops.gather_reduce import (
        K13_ROUTE_MAX_QUERIES)

    return [c for c in pp
            if c[1][2].shape[0] * c[1][2].shape[1] <= K13_ROUTE_MAX_QUERIES]


def _repeat_slots(idx, nmask):
    """The neighborhoods with cloud 0's second half of slots repeating its
    first half: support rows that a neighborhood lists twice."""
    idx, nmask = idx.clone(), nmask.clone()
    half = idx.shape[2] // 2
    idx[0, :, half:2 * half] = idx[0, :, :half]
    nmask[0, :, half:2 * half] = nmask[0, :, :half]
    return idx, nmask


def _nsum_parity(pp, gen, phase) -> dict:
    """K13 forward and backward vs the plain version and twin (and vs
    autograd of the plain forward) at every call of ``pp`` on the K13
    route, on f = [g, g²] as ``pwmlp_minmax_stats`` builds it, f32 and
    bf16, with the neighborhoods as the ball query gives them and with
    repeated support rows. The forward must be equal: both add in f32 in
    slot order and round once. The backward must equal the twin run on
    CPU copies (both add in (q, t) order; on the card the twin's
    index_add_ adds in atomic order) and give the same bits on a second
    launch."""
    from closerlook3d_tpu_torch.ops import gather_reduce as gr

    errs = dict.fromkeys(NSUM_KERNELS, 0.0)
    calls = _k13_calls(pp)
    if not calls:
        raise AssertionError("no aggregation call takes the K13 route")
    f32 = torch.float32
    for name, (q, s, idx0, nmask0, _), c, _ in calls:
        ns = s.shape[1]
        for slots in ("as queried", "repeated"):
            idx, nmask = ((idx0, nmask0) if slots == "as queried"
                          else _repeat_slots(idx0, nmask0))
            for dtype in (f32, torch.bfloat16):
                g32 = _features(gen, s, c, f32)
                f = torch.cat([g32, g32 * g32], dim=-1).to(dtype)
                dy = _features(gen, q, 2 * c, dtype)
                what = (f"neighborhood_sum {name} C={2 * c} "
                        f"K={idx.shape[2]} {str(dtype)[6:]} {slots}")
                out = gr.neighborhood_sum_cuda(f, idx, nmask)
                ref, ref_grad = _vjp(
                    lambda x: gr.neighborhood_sum_plain(x, idx, nmask), f, dy)
                errs["neighborhood_sum"] = max(errs["neighborhood_sum"],
                                               _max_err(what, out, ref))
                got = gr.neighborhood_sum_bwd_cuda(idx, nmask, dy, ns)
                twin = gr.neighborhood_sum_bwd_plain(
                    idx.cpu(), nmask.cpu(), dy.cpu(), ns)
                errs["neighborhood_sum_bwd"] = max(
                    errs["neighborhood_sum_bwd"],
                    _max_err(what + " bwd vs twin on the CPU", got.cpu(),
                             twin))
                if not torch.equal(
                        gr.neighborhood_sum_bwd_cuda(idx, nmask, dy, ns),
                        got):
                    raise AssertionError(f"{what} bwd: two launches differ")
                tol = _pwmlp_bwd_tol(dtype)
                e_a = _note_close(errs, "neighborhood_sum_bwd",
                                  what + " bwd vs autograd", got, ref_grad,
                                  tol)
                log(phase, f"{what}: fwd equal to the bit, bwd equal to "
                    f"the twin on the CPU and across launches; max abs err "
                    f"bwd vs autograd {e_a:.3g} (tol {tol}); "
                    f"{int(nmask.sum())} valid slots")
    return errs


def _route_bn_gap(pp, gen, phase) -> dict:
    """How far the masked BN's statistics move between the two routes at
    the first K13-route call, bf16: mean and variance of h = g[idx] - d
    formed as ``models/aggregation.py`` forms them, from K6's sums (f64,
    rounded to f32) and from the K13 route's (rounded to bf16); the
    largest relative gap over the channels."""
    from closerlook3d_tpu_torch.ops import gather_reduce as gr

    name, (q, s, idx, nmask, _), c, _ = _k13_calls(pp)[0]
    g = _features(gen, s, c, torch.bfloat16)
    gsq = (g.float() * g.float()).to(torch.bfloat16)
    d = _features(gen, q, c, torch.float32)
    stats = {}
    for route, fn in (("k6", gr.pwmlp_minmax_stats_cuda),
                      ("k13", gr.pwmlp_minmax_stats)):
        _, _, s1, s2 = fn(g, gsq, idx, nmask)
        cnt = nmask.sum(dim=-1, keepdim=True).float()
        total = torch.clamp(cnt.sum(), min=1.0)
        mean = (s1 - cnt * d).sum(dim=(0, 1)) / total
        ex2 = (s2 - 2.0 * d * s1 + cnt * d * d).sum(dim=(0, 1)) / total
        stats[route] = (mean, torch.clamp(ex2 - mean ** 2, min=0.0))
    (m6, v6), (m13, v13) = stats["k6"], stats["k13"]
    gap = {"call": name, "channels": c,
           "mean_rel_max": float(((m13 - m6).abs()
                                  / m6.abs().clamp(min=1e-12)).max()),
           "mean_abs_max": float((m13 - m6).abs().max()),
           "var_rel_max": float(((v13 - v6).abs()
                                 / v6.clamp(min=1e-12)).max()),
           "var_rel_median": float(((v13 - v6).abs()
                                    / v6.clamp(min=1e-12)).median())}
    log(phase, f"bf16 BN statistics at {name} (C={c}), K13 route vs K6: "
        f"mean gap max {gap['mean_abs_max']:.3g} abs; variance gap max "
        f"{100 * gap['var_rel_max']:.3f}%, median "
        f"{100 * gap['var_rel_median']:.3f}% relative")
    return gap


def phase_seg_train_parity(cfg, name: str) -> dict:
    """The train step's kernels vs their plain versions at every call
    shape of the config, f32 and bf16, on a padded, an all-masked and a
    duplicated cloud: ball query, FPS and the upsample k-NN; the
    aggregation kernels of ``AGG_KERNELS`` forward and backward (for the
    point-wise MLP K6 and K7 at every call and K13 at the calls on its
    route); the shortcut max forward and backward. {kernel: max abs
    err}."""
    from closerlook3d_tpu_torch.models.backbone import compute_geometry
    from closerlook3d_tpu_torch.ops.neighbors import knn_plain

    kind = config_kind(cfg)
    dev = torch.device(DEVICE)
    nb = cfg.batch_size
    b = seg_batch(cfg, SEED + 1100, padded=(nb - 4,), all_masked=(nb - 3,),
                  duplicated=(nb - 2, nb - 1))
    with torch.no_grad():
        g = compute_geometry(cfg, torch.from_numpy(b["xyz"]).to(dev),
                             torch.from_numpy(b["mask"]).to(dev),
                             need_up=True)
    bq, pp, up = seg_calls(cfg, g)
    phase = f"seg-train-parity:{name}"
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    errs = dict(_geometry_parity(bq, fps_calls(cfg, g)), knn=0.0)
    for call, (q, s, k, sm) in up:
        fn = _knn_route(q, s, k, sm)
        errs["knn"] = max(errs["knn"], _knn_err(f"knn {call}",
                                                fn(q, s, k, sm),
                                                knn_plain(q, s, k, sm)))
        log(phase, f"knn {call} q{tuple(q.shape)} s{tuple(s.shape)} "
            f"({fn.__name__}): idx and d2 equal")
    if kind == "pwmlp":
        errs.update(_pwmlp_parity(pp, gen, phase))
        # where the step takes the K13 route (B·Nq <= 64 at a call)
        if seg_train_launches(cfg, kind, "train")["neighborhood_sum"]:
            errs.update(_nsum_parity(pp, gen, phase))
            errs["route_bn_gap"] = _route_bn_gap(pp, gen, phase)
    elif kind == "pgrid":
        errs.update(_pgrid_parity(cfg, pp, gen, phase))
    else:
        errs.update(_agg_parity(kind, pp, gen, phase))
    errs.update(_max_parity(cfg, pp, gen, phase))
    return errs


def phase_seg_train_step_parity(cfg, name: str, wrappers) -> dict:
    """One f32 train step through the kernels vs one through the plain
    versions on the card, same weights and batch. Each step computes its
    own geometry (FPS or grid subsampling, the ball queries, the upsample
    k-NN; the plain ball query and k-NN in their query chunks), so the
    kernel step's launches count the geometry kernels too."""
    from closerlook3d_tpu_torch.models import build_model_and_loss
    from closerlook3d_tpu_torch.models.build import part_counts
    from closerlook3d_tpu_torch.train import (
        create_train_state, make_optimizer, make_train_step)

    kind = config_kind(cfg)
    cfg = copy.deepcopy(cfg)
    cfg.precision = "f32"
    cfg.dropout_rate = 0.0
    batch = seg_train_batch(cfg, SEED + 1200, padded=(1,))
    model, loss_fn = build_model_and_loss(cfg)
    num_parts = (part_counts(cfg) if cfg.task == "part_segmentation"
                 else None)
    step = make_train_step(loss_fn, cfg.task, num_parts)
    runs = {}
    for route in ("kernel", "plain"):
        tx, _ = make_optimizer(cfg, SEG_STEPS_PER_EPOCH)
        state = create_train_state(copy.deepcopy(model), tx, device=DEVICE)
        reset_counts(wrappers)
        with (plain_route() if route == "plain"
              else contextlib.nullcontext()):
            state, metrics = step(state, batch, SEED)
        torch.cuda.synchronize()
        runs[route] = (state.model, float(metrics["loss"]),
                       read_counts(wrappers))
    (km, kloss, kcounts), (pm, ploss, pcounts) = runs["kernel"], runs["plain"]
    phase = f"seg-train-step:{name}"
    check_counts(f"{phase} kernel step", kcounts,
                 seg_train_launches(cfg, kind, "train"))
    check_counts(f"{phase} plain step", pcounts, dict.fromkeys(wrappers, 0))
    if abs(kloss - ploss) > 1e-5 * abs(ploss):
        raise AssertionError(f"{phase} loss: kernel {kloss}, plain {ploss}")
    gaps = _grad_gaps(phase, km, pm)
    pstate = pm.state_dict()
    for key, t in km.state_dict().items():
        torch.testing.assert_close(t, pstate[key], rtol=1e-4, atol=1e-5,
                                   msg=lambda m, n=key: f"{n}: {m}")
    n = len(gaps)
    median = sorted(gaps.values())[n // 2]
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    # reordering the point-wise MLP's BatchNorm sums moves its gradient by
    # up to ~5% (its variance E[h^2] - mean^2 cancels); K6 and its plain
    # version both sum in f64 and round once
    spread = ("; reordering its BatchNorm sums would move it by up to ~5%, "
              "but both routes sum them in f64 and round once"
              if kind == "pwmlp" else "")
    log(phase, f"f32 step (geometry in the step, {cfg.batch_size} clouds) "
        f"kernels vs plain: loss {kloss:.6f} vs {ploss:.6f}; all {n} "
        f"parameters have a nonzero gradient; relative L2 gradient gap "
        f"(limit 2%{spread}) median {median:.3g}, worst "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst)
        + f"; updated params and running stats agree; launches "
        + str({k: v for k, v in kcounts.items() if v}))
    return {"loss_kernel": kloss, "loss_plain": ploss, "grad_rel_l2": gaps,
            "grad_rel_l2_median": median, "params": n, "launches": kcounts}


def phase_seg_training(cfg, name: str, wrappers,
                       steps: int = TRAIN_STEPS) -> dict:
    """``steps`` bf16 steps of the config on one batch, warmup off at the
    config's base LR, with exact launches per step, every parameter moved
    and, over TRAIN_STEPS steps, a falling loss. Then an eval step, with
    its launches."""
    from closerlook3d_tpu_torch.models import build_model_and_loss
    from closerlook3d_tpu_torch.models.build import part_counts
    from closerlook3d_tpu_torch.train import (
        create_train_state, make_eval_step, make_optimizer, make_train_step)

    kind = config_kind(cfg)
    cfg = copy.deepcopy(cfg)
    cfg.warmup_epoch = 0
    model, loss_fn = build_model_and_loss(cfg)
    num_parts = (part_counts(cfg) if cfg.task == "part_segmentation"
                 else None)
    tx, lr = make_optimizer(cfg, SEG_STEPS_PER_EPOCH)
    state = create_train_state(model, tx, device=DEVICE)
    step = make_train_step(loss_fn, cfg.task, num_parts)
    batch = seg_train_batch(cfg, SEED + 1300, padded=(1,))
    per_step = seg_train_launches(cfg, kind, "train")
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    run = _train_steps(step, state, batch, per_step, wrappers, name, steps)
    still = [n for n, p in state.model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"{name}: {len(still)} parameters did not move "
                             f"over {steps} steps, first {still[:4]}")
    del before
    losses, accs, peak = run["losses"], run["accs"], run["peak_gib"]
    phase = f"seg-training:{name}"
    log(phase, f"{steps} bf16 steps, batch {cfg.batch_size} x "
        f"{cfg.num_points} points, lr {lr(0):g}: loss "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; acc {accs[0]:.3f} -> {accs[-1]:.3f}; launches per step "
        + str({k: n for k, n in per_step.items() if n})
        + f"; peak memory {peak:.2f} GiB")
    reset_counts(wrappers)
    logits, emetrics = make_eval_step(loss_fn, cfg.task, num_parts)(state,
                                                                   batch)
    torch.cuda.synchronize()
    eval_counts = read_counts(wrappers)
    check_counts(f"{name} eval step", eval_counts,
                 seg_train_launches(cfg, kind, "forward"))
    width = state.model.head.fc.out_features
    if (tuple(logits.shape) != (cfg.batch_size, cfg.num_points, width)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"{name} eval logits {tuple(logits.shape)} not "
                             f"finite")
    log(phase, f"eval step: loss {float(emetrics['loss']):.4f} acc "
        f"{float(emetrics['acc']):.3f}; per-point logits "
        f"{tuple(logits.shape)}; launches "
        + str({k: v for k, v in eval_counts.items() if v}))
    return {"state": state, "step": step, "batch": batch, **run,
            "launches_per_step": per_step, "eval_launches": eval_counts,
            "eval": {"loss": float(emetrics["loss"]),
                     "acc": float(emetrics["acc"])}}


def multi_hot(idx, mask, ns: int, dtype):
    """[B, Nq, Ns] counts of the valid slots of each query that hold each
    support row: the TPU kernel's multi-hot matrix."""
    m = torch.zeros((*idx.shape[:2], ns), dtype=torch.float32,
                    device=idx.device)
    m.scatter_add_(2, idx.long(), mask.float())
    return m.to(dtype)


def _nsum_timing(cfg, phase) -> dict:
    """K13 forward and backward per train step (bf16, its calls on the
    route) against the plain version and twin, the bound, and one
    ``torch.bmm`` of the multi-hot count matrix (built outside the timed
    call) with f forward and of its transpose with dy backward; inputs
    from three batches' geometry. Each is timed two ways: by CUDA events
    over eager launches (``ms``/``stream_ms``, ``library_ms``: what the
    eager step pays, host launch path included) and by the device time
    the profiler records (``device_ms``, ``library_device_ms``: kernel
    against library call in turns), beside the device time of an empty
    launch (``launch_floor_ms``)."""
    from closerlook3d_tpu_torch.models.backbone import compute_geometry
    from closerlook3d_tpu_torch.ops import gather_reduce as gr

    dev = torch.device(DEVICE)
    sets = []
    for r in range(3):  # distinct inputs per launch
        b = seg_batch(cfg, SEED + 1400 + r)
        with torch.no_grad():
            g = compute_geometry(cfg, torch.from_numpy(b["xyz"]).to(dev),
                                 torch.from_numpy(b["mask"]).to(dev))
        sets.append(_k13_calls(seg_calls(cfg, g)[1]))
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    bf = torch.bfloat16
    floor_ms, _ = _device_time(empty_launch, [()], 50)
    log(phase, f"empty kernel launch: {floor_ms:.5f} ms device time")
    rows = {k: [] for k in NSUM_KERNELS}
    for i, (name, _, c, count) in enumerate(sets[0]):
        fwd, bwd, lib_f, lib_b = [], [], [], []
        for calls in sets:
            q, s, idx, nmask, _ = calls[i][1]
            g32 = _features(gen, s, c, torch.float32)
            f = torch.cat([g32, g32 * g32], dim=-1).to(bf)
            dy = _features(gen, q, 2 * c, bf)
            m = multi_hot(idx, nmask, s.shape[1], bf)
            fwd.append((f, idx, nmask))
            bwd.append((idx, nmask, dy, s.shape[1]))
            lib_f.append((m, f))
            lib_b.append((m.transpose(1, 2).contiguous(), dy))
        f, idx, nmask = fwd[0]
        dy = bwd[0][2]
        # one f32 add per valid slot and channel; bytes: inputs read once,
        # the output written once (dy has the forward output's size, f the
        # backward's)
        flops = float(nmask.sum()) * f.shape[2]
        cases = {"neighborhood_sum": (gr.neighborhood_sum_cuda,
                                      gr.neighborhood_sum_plain, fwd, lib_f,
                                      _nbytes(f, idx, nmask, dy)),
                 "neighborhood_sum_bwd": (gr.neighborhood_sum_bwd_cuda,
                                          gr.neighborhood_sum_bwd_plain, bwd,
                                          lib_b, _nbytes(idx, nmask, dy, f))}
        for kernel, (fn, plain, ins, lib_ins, nbytes) in cases.items():
            ms, lib_ms = _time(fn, ins, 50), _time(torch.bmm, lib_ins, 50)
            (dev_ms, ops), (lib_dev_ms, lib_ops) = _device_pair(
                fn, ins, torch.bmm, lib_ins, 50)
            plain_ms = _time(plain, ins, 5)
            bound_ms, bound_by = _bound(nbytes, flops)
            rows[kernel].append({
                "call": name, "per_step": count, "ms": ms, "stream_ms": ms,
                "device_ms": dev_ms, "device_ops_per_call": ops,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_device_ms": lib_dev_ms,
                "library_device_ops_per_call": lib_ops,
                "launch_floor_ms": floor_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                "flops": flops})
            log(phase, f"{kernel} {name} f{tuple(f.shape)} K={idx.shape[2]} "
                f"x{count}: device {dev_ms:.5f} ms ({ops:g} device ops a "
                f"call), torch.bmm device {lib_dev_ms:.5f} ms ({lib_ops:g}); "
                f"events over eager launches: kernel {ms:.4f} ms, torch.bmm "
                f"{lib_ms:.4f} ms; plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.5f} ms ({bound_by}; {nbytes / 1e6:.2f} MB)")
    out = {}
    for kernel, calls in rows.items():
        by = {}
        for r in calls:
            by[r["bound_by"]] = (by.get(r["bound_by"], 0.0)
                                 + r["bound_ms"] * r["per_step"])
        out[kernel] = {"calls": calls, **{
            k: sum(r[k] * r["per_step"] for r in calls)
            for k in ("ms", "stream_ms", "device_ms", "plain_ms",
                      "library_ms", "library_device_ms", "launch_floor_ms",
                      "bound_ms")},
            "bound_by": max(by, key=by.get)}
        t = out[kernel]
        log(phase, f"{kernel} per step: device {t['device_ms']:.5f} ms, "
            f"torch.bmm device {t['library_device_ms']:.5f} ms, launch "
            f"floor {t['launch_floor_ms']:.5f} ms; events: kernel "
            f"{t['ms']:.4f} ms, torch.bmm {t['library_ms']:.4f} ms; plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']})")
    return out


def phase_k13_timing() -> dict:
    """K13 per ShapeNetPart point-wise MLP step (``_nsum_timing``), run
    right after the build: in a fresh process the profiler records every
    device op of a window, where after this run's long profiles it has
    missed some, once all. Fails unless each K13 call is one device
    kernel (no fill, no cast)."""
    out = _nsum_timing(seg_train_config("shapenetpart_pwmlp"), "k13-timing")
    for kernel, t in out.items():
        for r in t["calls"]:
            if r["device_ops_per_call"] != 1:
                raise AssertionError(
                    f"{kernel} {r['call']}: {r['device_ops_per_call']:g} "
                    f"device operations a call, expected 1")
    return out


# ---- the ball query by device time -----------------------------------------

# the forwards whose ball queries are timed call by call: the ModelNet40
# xyz train step (32 x 5000 points, FPS), the S3DIS train step (8 x 15000,
# grid sampling) and a flagship request (16 x 1024)
BQ_STEPS = ("xyz", "s3dis", "flagship")


def bq_step_calls(step: str, seed: int) -> list:
    """The 9 ball-query calls of one forward of a ``BQ_STEPS`` entry,
    geometry made on the card from a seeded batch: [(call, args of
    ``ball_query_cuda``)]."""
    from closerlook3d_tpu_torch.models.backbone import compute_geometry

    dev = torch.device(DEVICE)
    if step in ("xyz", "flagship"):
        cfg = train_config("xyz") if step == "xyz" else flagship_config()
        b = make_batch(seed, batch=cfg.batch_size, points=cfg.num_points)
        return path_calls(cfg, torch.from_numpy(b["xyz"]).to(dev),
                          torch.from_numpy(b["mask"]).to(dev))[0]
    cfg = seg_train_config(step)
    b = seg_batch(cfg, seed)
    with torch.no_grad():
        g = compute_geometry(cfg, torch.from_numpy(b["xyz"]).to(dev),
                             torch.from_numpy(b["mask"]).to(dev))
    return seg_calls(cfg, g)[0]


def bq_pairs_in_radius(q, s, radius, smask, chunk: int = 256) -> float:
    """(query, valid support) pairs with d2 <= r2, d2 rounded as the
    kernel and its plain version round it, counted on the card over
    chunks of queries. Every query row counts, masked ones too: the
    kernel computes their indices as well."""
    from closerlook3d_tpu_torch.ops.neighbors import _r2, pairwise_dist2

    r2, n = _r2(radius), 0
    for i in range(0, q.shape[1], chunk):
        d2 = pairwise_dist2(q[:, i:i + chunk], s)
        n += int(((d2 <= r2) & smask[:, None, :]).sum())
    return float(n)


def bq_bound(args) -> dict:
    """The ball query's bound for one call: the larger of its bytes
    (points and masks read once, idx and mask written once) over the HBM
    rate and 8 f32 operations (3 subtractions, 3 multiplies, 2 adds) per
    in-radius (query, valid support) pair over the f32 peak; beside it
    ``all_pairs_ms``, the same 8 operations for every (valid query, valid
    support) pair, the work of a scan that prunes nothing."""
    q, s, r, k, qm, sm = args
    nbytes = _nbytes(q, s, qm, sm) + q.shape[0] * q.shape[1] * k * 5
    pairs = bq_pairs_in_radius(q, s, r, sm)
    all_pairs = float((qm.sum(1) * sm.sum(1)).sum())
    bound_ms, bound_by = _bound(nbytes, 8 * pairs)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": 8 * pairs, "pairs_in_radius": pairs,
            "all_pairs": all_pairs,
            "all_pairs_ms": 8 * all_pairs / F32_FLOPS * 1e3}


def _op_name(name: str) -> str:
    """A device op's function name without namespace or arguments."""
    m = re.search(r"(\w+)(<[^(]*>)?\(", name)
    return m.group(1) if m else name


def _bq_timing(reps: int = 20, seed: int = SEED + 600) -> dict:
    """The ball query per call and per step (or request) at the 9 calls of
    each ``BQ_STEPS`` forward (inputs from three seeded batches): device time
    (``_device_time``: the profiler's mean per device op, summed over the
    call's ops) and CUDA events over eager launches (``stream_ms``),
    beside ``bq_bound``."""
    from closerlook3d_tpu_torch.ops.neighbors import ball_query_cuda

    out = {}
    for step in BQ_STEPS:
        sets = [bq_step_calls(step, seed + r) for r in range(3)]
        rows = []
        for i, (name, a) in enumerate(sets[0]):
            ins = [cs[i][1] for cs in sets]
            row = {"call": name, "q": list(a[0].shape),
                   "s": list(a[1].shape), "radius": a[2], "k": a[3],
                   **bq_bound(a)}
            row["stream_ms"] = _time(ball_query_cuda, ins, reps)
            ops = row["device_ms_by_op"] = {}
            row["device_ms"], row["device_ops_per_call"] = _device_time(
                ball_query_cuda, ins, reps, ops)
            rows.append(row)
            log("bq-timing", f"{step} {name} q{tuple(a[0].shape)} "
                f"s{tuple(a[1].shape)} r={a[2]:g} K={a[3]}: device "
                f"{row['device_ms']:.5f} ms ("
                + ", ".join(f"{_op_name(n)} {v:.5f}"
                            for n, v in ops.items()) + ")"
                + f"; events {row['stream_ms']:.4f} ms; bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}; "
                f"{row['pairs_in_radius']:.4g} pairs in radius), all pairs "
                f"{row['all_pairs_ms']:.5f} ms")
        keys = ["device_ms", "stream_ms", "bound_ms", "all_pairs_ms"]
        tot = {k: sum(r[k] for r in rows) for k in keys}
        by = {}
        for r in rows:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
        out[step] = {"calls": rows, **tot, "bound_by": max(by, key=by.get)}
        log("bq-timing", f"{step} per step: " + ", ".join(
            f"{k} {v:.5f}" for k, v in tot.items()))
    return out


def phase_bq_timing() -> dict:
    """The ball query by device time at the 9 calls of the ModelNet40 xyz
    and the S3DIS train steps and of a flagship request (``_bq_timing``),
    right after the build as K13's timing; fails unless each call runs
    the kernel's two device ops (the preparation pass and the query
    kernel)."""
    out = _bq_timing()
    for step, t in out.items():
        for r in t["calls"]:
            if r["device_ops_per_call"] != 2:
                raise AssertionError(
                    f"ball_query {step} {r['call']}: "
                    f"{r['device_ops_per_call']:g} device operations a "
                    f"call, expected 2")
    return out


# ---- every segmentation config of configs/ ---------------------------------

def phase_config_logits(cfg, name: str, weights, wrappers) -> dict:
    """f32 per-point logits of one request through the kernels against
    the same request through the plain versions, both on the card (a
    padded and a duplicated cloud), with the f32 request's exact launches
    and none on the plain route; and the request's geometry (sampling,
    neighborhoods and upsample indices) equal on both routes."""
    from closerlook3d_tpu_torch.models.backbone import compute_geometry
    from closerlook3d_tpu_torch.serving import Predictor

    cfg32 = copy.deepcopy(cfg)
    cfg32.precision = "f32"
    nb = cfg32.batch_size
    b = seg_batch(cfg32, SEED + 1400, padded=(1,), duplicated=(nb - 1,))
    predictor = Predictor(cfg32, weights, device=DEVICE)
    phase = f"config-logits:{name}"
    out, counts, geometry = {}, {}, {}
    for route in ("kernel", "plain"):
        with (plain_route() if route == "plain"
              else contextlib.nullcontext()):
            reset_counts(wrappers)
            out[route] = predictor(b["xyz"], b["mask"], b["features"])
            torch.cuda.synchronize()
            counts[route] = read_counts(wrappers)
            with torch.no_grad():
                geometry[route] = compute_geometry(
                    cfg32, torch.from_numpy(b["xyz"]).to(DEVICE),
                    torch.from_numpy(b["mask"]).to(DEVICE), need_up=True)
    expected = seg_launches(cfg32)
    check_counts(f"{phase} request", counts["kernel"], expected)
    check_counts(f"{phase} plain route", counts["plain"],
                 dict.fromkeys(wrappers, 0))
    for k, t in geometry["plain"].items():
        if not torch.equal(geometry["kernel"][k], t):
            raise AssertionError(f"{phase} geometry {k}: kernels and plain "
                                 f"versions differ")
    lk, lp = out["kernel"], out["plain"]
    width = predictor.model.head.fc.out_features
    if tuple(lk.shape) != (nb, cfg32.num_points, width):
        raise AssertionError(f"{phase}: logits {tuple(lk.shape)}")
    # f32 throughout (TF32 off): the kernels and the plain versions sum
    # the neighborhoods in different orders
    torch.testing.assert_close(lk, lp, rtol=1e-3, atol=1e-4)
    err = float((lk - lp).abs().max())
    log(phase, f"f32 per-point logits {tuple(lk.shape)}, kernels vs plain "
        f"versions on the card: max abs err {err:.3g} (|logits| max "
        f"{float(lp.abs().max()):.3g}; rtol 1e-3, atol 1e-4); geometry "
        f"({len(geometry['plain'])} tensors) equal; request launches "
        + str({k: v for k, v in expected.items() if v}))
    return {"max_abs_err": err, "clouds": nb,
            "geometry_tensors": len(geometry["plain"]),
            "launches": expected}


def run_config(name: str, wrappers) -> dict:
    """One config of ``CONFIG_RUNS`` on the card: f32 logits through the
    kernels against the plain versions (``phase_config_logits``); for
    ``PARTNET_FULL`` also bf16 requests through ``Predictor`` with exact
    launches, timed, and f32 logits against the CPU on two clouds; at
    ``SEG_TRAIN_BATCH`` clouds, every kernel of the train step against its
    plain version at every call shape, f32 and bf16, forward and backward
    (``phase_seg_train_parity``), and one f32 train step through the
    kernels against one through the plain versions (each gradient within
    2% relative L2); TRAIN_STEPS bf16 steps for the ``SEG_TRAIN_FILES``
    runs, else ``CONFIG_STEPS``, with exact launches, finite losses and
    every parameter moved, and an eval step; the step's median, device
    busy and peak memory."""
    cfg = file_config(name)
    kind = config_kind(cfg)
    run = {"kind": kind, "batch_size": cfg.batch_size,
           "num_points": cfg.num_points, "depth": cfg.depth}
    weights = seeded_weights(cfg, torch.Generator().manual_seed(SEED + 40))
    run["logits"] = phase_config_logits(cfg, name, weights, wrappers)
    main_path = []
    if name == PARTNET_FULL:
        serving = phase_seg_serving(cfg, name, weights, wrappers)
        run["serving"] = {k: v for k, v in serving.items()
                          if k not in ("predictor", "batches")}
        main_path.append(serving["launches"])
        # the CPU's plain forward at 10000 points and depth 3: two clouds
        run["forward_parity"] = phase_seg_forward_parity(
            cfg, name, weights, serving["batches"][1], clouds=2)
        del serving
    pcfg = copy.deepcopy(cfg)
    pcfg.batch_size = min(cfg.batch_size, SEG_TRAIN_BATCH)
    run["parity"] = phase_seg_train_parity(pcfg, name)
    run["step_parity"] = phase_seg_train_step_parity(pcfg, name, wrappers)
    run["parity_clouds"] = pcfg.batch_size
    steps = (TRAIN_STEPS if name in SEG_TRAIN_FILES.values()
             else CONFIG_STEPS)
    training = phase_seg_training(cfg, name, wrappers, steps)
    run["training"] = {k: v for k, v in training.items()
                       if k not in ("state", "step", "batch")}
    phase = f"config:{name}"
    run["timing"] = _step_timing(cfg, training, phase)
    main_path += [training["launches"], training["eval_launches"]]
    run["launches"] = {k: sum(r[k] for r in main_path) for k in wrappers}
    run["launches_per_step"] = training["launches_per_step"]
    run["eval_launches"] = training["eval_launches"]
    del training
    torch.cuda.empty_cache()
    t = run["timing"]
    log(phase, f"{kind}, {cfg.batch_size} x {cfg.num_points} points, depth "
        f"{cfg.depth}: step median {t['step_ms_median']:.3f} ms, device "
        f"busy {t['split']['device_busy_ms']:.3f} ms/step, peak "
        f"{run['training']['peak_gib']:.2f} GiB; launches a step "
        + str({k: v for k, v in run["launches_per_step"].items() if v}))
    return run


# ---- S3DIS evaluation -----------------------------------------------------

# two test-area rooms of about a million points each, the size of a real
# S3DIS room. The config's 20 votes (configs/s3dis/pospool_xyz_avg.yaml)
# took 427 sphere batches, 64 s of voting and 84 s for the phase on one
# H100 machine; the host's numpy sets the pace (6.6-9.9 sphere batches a
# second between machines); 12 votes took 41-57 s for the phase and 8
# took 35.6-36.8 s; 6 (since the data-parallel phase came in) keep it
# under half a minute
VOTING_ROOMS = 2
VOTING_ROOM_POINTS = 1_000_000
VOTING_VOTES = 6
# queries a room held to knn_plain on the card
PROJECTION_CHECKS = 16384
# colours by S3DIS class id (ceiling, floor, wall, ..., clutter)
_CLASS_RGB = np.array([
    [0.9, 0.9, 0.85], [0.55, 0.45, 0.35], [0.8, 0.78, 0.7], [0.6, 0.6, 0.6],
    [0.7, 0.7, 0.65], [0.5, 0.7, 0.9], [0.45, 0.3, 0.2], [0.6, 0.4, 0.25],
    [0.2, 0.2, 0.25], [0.5, 0.1, 0.1], [0.35, 0.25, 0.15], [0.95, 0.95, 0.95],
    [0.3, 0.5, 0.3]], np.float32)


def _box_faces(lo, size, label):
    """The five faces (no bottom) of an axis-aligned box as rectangles
    (corner, edge u, edge v, label)."""
    x, y, z = np.asarray(lo, np.float64)
    a, b, c = size
    ex, ey, ez = np.array([a, 0, 0]), np.array([0, b, 0]), np.array([0, 0, c])
    o = np.array([x, y, z])
    return [(o + ez, ex, ey, label), (o, ex, ez, label),
            (o + ey, ex, ez, label),
            (o, ey, ez, label), (o + ex, ey, ez, label)]


def voting_room(seed: int, n: int):
    """A room of ``n`` points as a scanner sees it: floor, ceiling and four
    walls with a door, a window and a board on them, a column, tables,
    chairs, a bookcase and clutter, each a box of its S3DIS class, with
    colours; jittered by 3 mm and placed off the origin as the areas'
    rooms are. (xyz f32 [n, 3], rgb f32 [n, 3] in [0, 1], labels int32
    [n]), points grouped by surface as the annotation files list them."""
    rng = np.random.default_rng(seed)
    lx, ly, h = rng.uniform(6.5, 9.0), rng.uniform(5.0, 7.0), 3.0
    ex, ey, ez = (np.array([lx, 0, 0]), np.array([0, ly, 0]),
                  np.array([0, 0, h]))
    o = np.zeros(3)
    rects = [(o, ex, ey, 1), (o + ez, ex, ey, 0),
             (o, ex, ez, 2), (o + ey, ex, ez, 2), (o, ey, ez, 2),
             (o + ex, ey, ez, 2),
             (np.array([1.0, 0.01, 0]), np.array([0.9, 0, 0]),
              np.array([0, 0, 2.1]), 6),  # door
             (np.array([lx - 0.01, 1.5, 1.0]), np.array([0, 1.8, 0]),
              np.array([0, 0, 1.2]), 5),  # window
             (np.array([0.01, 2.0, 0.9]), np.array([0, 2.4, 0]),
              np.array([0, 0, 1.2]), 11)]  # board
    rects += _box_faces([lx / 2, ly - 0.6, 0], (0.5, 0.5, h), 4)  # column
    for t in range(4):
        tx, ty = 1.5 + 1.6 * (t % 2) + rng.uniform(0, 1), 1.2 + 2.0 * (t // 2)
        rects += _box_faces([tx, ty, 0], (1.2, 0.8, 0.75), 7)
        for side in (-0.55, 0.85):
            rects += _box_faces([tx + 0.35, ty + side, 0], (0.45, 0.45, 0.9),
                                8)
    rects += _box_faces([lx - 2.5, 0.05, 0], (2.0, 0.4, 2.0), 10)  # bookcase
    for _ in range(6):
        s = rng.uniform(0.2, 0.6, 3)
        rects += _box_faces([rng.uniform(0.5, lx - 1),
                             rng.uniform(0.5, ly - 1), 0], s, 12)
    areas = np.array([np.linalg.norm(u) * np.linalg.norm(v)
                      for _, u, v, _ in rects])
    counts = rng.multinomial(n, areas / areas.sum())
    xyz, labels = [], []
    for (p, u, v, label), m in zip(rects, counts):
        ab = rng.random((m, 2))
        xyz.append(p + ab[:, :1] * u + ab[:, 1:] * v)
        labels.append(np.full(m, label, np.int32))
    xyz = np.concatenate(xyz) + rng.normal(0, 0.003, (n, 3))
    xyz += np.array([rng.uniform(-20, 20), rng.uniform(-20, 20), 0.0])
    labels = np.concatenate(labels)
    rgb = np.clip(_CLASS_RGB[labels] + rng.normal(0, 0.05, (n, 3)), 0, 1)
    return xyz.astype(np.float32), rgb.astype(np.float32), labels


def write_voting_rooms(root: str, cell: float) -> float:
    """Prepare ``VOTING_ROOMS`` test-area rooms straight into the processed
    cache that ``data/s3dis.py::S3DIS`` reads (raw text would make the
    parse the bottleneck): sub-clouds by ``grid_subsample_np`` at
    ``cell`` (the native library's once it is built). Returns the seconds
    it took."""
    from closerlook3d_tpu_torch.data.s3dis import grid_subsample_np

    t0 = time.perf_counter()
    out = os.path.join(root, f"s3dis_processed_{cell:g}")
    os.makedirs(out, exist_ok=True)
    for r in range(VOTING_ROOMS):
        xyz, rgb, labels = voting_room(SEED + 1300 + r, VOTING_ROOM_POINTS)
        sxyz, srgb, slab = grid_subsample_np(xyz, cell, rgb, labels)
        np.savez(os.path.join(out, f"Area_5__room_{r}.npz"), sub_xyz=sxyz,
                 sub_rgb=srgb, sub_labels=slab, full_xyz=xyz,
                 full_labels=labels)
    return time.perf_counter() - t0


# ---- the native host ops (the S3DIS data path) ------------------------------

# full-cloud queries a room for the k-NN at k = 16 (k = 1 takes the whole
# full cloud, the projection's shape), and sphere centers a room for the
# radius queries
NATIVE_KNN16_QUERIES = 200_000
NATIVE_RADIUS_CENTERS = 64
# the native ops sum f32 squares of f32 differences where scipy sums in
# f64: two distances (or a distance and the radius) within this relative
# gap are a tie at f32 precision
NATIVE_TIE_RTOL = 1e-6


def native_grid_twin(points, cell, features=None, labels=None):
    """numpy twin of ``native.grid_subsample_cpu``'s arithmetic: the voxel
    of (p - min) in f32 times 1 / cell in f64, truncated; voxels numbered
    in the order of their first point; f32 sums in input order
    (``np.add.at``) scaled by the f32 1 / count; the first of the most
    voted labels."""
    pts = np.ascontiguousarray(points, np.float32)
    cells = ((pts - pts.min(0)).astype(np.float64) * (1.0 / cell)).astype(
        np.uint64)
    key = ((cells[:, 2] << np.uint64(42)) | (cells[:, 1] << np.uint64(21))
           | cells[:, 0])
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    number = np.empty(len(first), np.int64)
    number[np.argsort(first)] = np.arange(len(first))
    voxel = number[inverse.reshape(-1)]
    scale = (np.float32(1) / np.bincount(voxel).astype(np.float32))[:, None]

    def mean(x):
        sums = np.zeros((len(first), x.shape[1]), np.float32)
        np.add.at(sums, voxel, np.ascontiguousarray(x, np.float32))
        return sums * scale

    out_labels = None
    if labels is not None:
        votes = np.zeros((len(first), int(labels.max()) + 1), np.int32)
        np.add.at(votes, (voxel, labels), 1)
        out_labels = votes.argmax(1).astype(np.int32)
    return (mean(pts), None if features is None else mean(features),
            out_labels)


def _same_arrays(what, got, ref) -> None:
    """Raise unless every array of ``got`` equals ``ref``'s in dtype,
    shape and bits."""
    for i, (a, b) in enumerate(zip(got, ref)):
        if (a is None) != (b is None):
            raise AssertionError(f"{what}: output {i} present on one side")
        if a is not None and (a.dtype != b.dtype or a.shape != b.shape
                              or a.tobytes() != b.tobytes()):
            raise AssertionError(f"{what}: output {i} differs ({a.dtype} "
                                 f"{a.shape} against {b.dtype} {b.shape})")


def knn_vs_scipy(what, sub, queries, got, ref) -> dict:
    """The native tree's ``query`` result ``got`` (dists, idx) against
    scipy's ``ref`` on the same sub-cloud and queries: same shapes; every
    slot where the indices differ holds two points at the same distance
    within ``NATIVE_TIE_RTOL`` (a tie at f32 precision, counted), and
    every distance within it of scipy's (1 um at 0)."""
    (dn, idn), (ds, ids) = got, ref
    if dn.shape != ds.shape or idn.shape != ids.shape:
        raise AssertionError(f"{what}: shapes {dn.shape}, {idn.shape} "
                             f"against scipy's {ds.shape}, {ids.shape}")
    idn, ids = idn.reshape(len(queries), -1), ids.reshape(len(queries), -1)
    rows, cols = np.nonzero(idn != ids)
    q = queries[rows].astype(np.float64)
    da = np.linalg.norm(q - sub[idn[rows, cols]].astype(np.float64), axis=1)
    db = np.linalg.norm(q - sub[ids[rows, cols]].astype(np.float64), axis=1)
    gap = np.abs(da - db)
    if (gap > NATIVE_TIE_RTOL * db).any():
        i = int(np.argmax(gap - NATIVE_TIE_RTOL * db))
        raise AssertionError(f"{what}: query {rows[i]} slot {cols[i]}: "
                             f"index {idn[rows[i], cols[i]]} at {da[i]!r} "
                             f"where scipy has {ids[rows[i], cols[i]]} at "
                             f"{db[i]!r}")
    derr = np.abs(dn.astype(np.float64) - ds)
    if (derr > NATIVE_TIE_RTOL * ds + 1e-6).any():
        raise AssertionError(f"{what}: distances differ from scipy's by up "
                             f"to {float(derr.max())!r}")
    return {"ties": len(rows), "max_dist_err": float(derr.max())}


def radius_vs_scipy(what, sub, center, r, got, ref) -> int:
    """The native ``query_ball_point`` result ``got`` against scipy's
    ``ref``: no index twice, and equal as sets but for points within
    ``NATIVE_TIE_RTOL`` of the radius (a tie at f32 precision, counted)."""
    if len(np.unique(got)) != len(got):
        raise AssertionError(f"{what}: an index listed twice")
    odd = np.array(sorted(set(got.tolist()) ^ set(ref)), np.int64)
    d2 = np.sum((sub[odd].astype(np.float64)
                 - center.astype(np.float64)) ** 2, axis=1)
    if (np.abs(d2 - r * r) > NATIVE_TIE_RTOL * r * r).any():
        raise AssertionError(f"{what}: the sets differ at points off the "
                             f"radius ({len(odd)} in one set only)")
    return len(odd)


def _host_turns(fns: dict, turns: int = 2):
    """({name: median host seconds}, {name: last result}) of callables
    run in turns, the order reversed every other turn."""
    names = list(fns)
    times, out = {n: [] for n in names}, {}
    for t in range(turns):
        for n in (names if t % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            out[n] = fns[n]()
            times[n].append(time.perf_counter() - t0)
    return {n: float(np.median(v)) for n, v in times.items()}, out


def phase_native() -> dict:
    """The native host ops (``closerlook3d_tpu_torch/native/``) on this
    machine's host, at the S3DIS size: the two generated rooms of
    ``VOTING_ROOM_POINTS`` points that ``phase_s3dis_voting`` votes on,
    cell and radius of ``configs/s3dis/pospool_xyz_avg.yaml``.
    ``grid_subsample_cpu`` equal to its numpy twin to the bit (voxel
    order, points, colours, labels); ``KDTree`` on the sub-cloud against
    scipy's ``cKDTree``: the k-NN at k = 1 (every full-cloud point, the
    projection's shape) and k = 16 (``NATIVE_KNN16_QUERIES`` of them),
    indices equal but at ties, and the radius queries at ``in_radius``
    around ``NATIVE_RADIUS_CENTERS`` sub-cloud points, equal as sets. Each
    op timed against numpy (``grid_subsample_numpy``) or scipy on the
    host's clock, in turns."""
    from scipy.spatial import cKDTree

    from closerlook3d_tpu_torch import native
    from closerlook3d_tpu_torch.data.s3dis import grid_subsample_numpy

    phase = "native"
    t_start = time.perf_counter()
    cfg = seg_config("s3dis")
    cell, radius = cfg.first_subsampling_dl, float(cfg.in_radius)
    gen = np.random.default_rng(SEED + 1400)
    rows = []
    for r in range(VOTING_ROOMS):
        xyz, rgb, labels = voting_room(SEED + 1300 + r, VOTING_ROOM_POINTS)
        row = {"points": len(xyz)}
        sec, grid = _host_turns({
            "native": lambda: native.grid_subsample_cpu(xyz, cell, rgb,
                                                        labels),
            "numpy": lambda: grid_subsample_numpy(xyz, cell, rgb, labels)})
        t0 = time.perf_counter()
        twin = native_grid_twin(xyz, cell, rgb, labels)
        sec["twin"] = time.perf_counter() - t0
        _same_arrays(f"{phase} room {r}: grid_subsample_cpu vs its twin",
                     grid["native"], twin)
        row["grid"] = {"s": sec, "voxels": len(grid["native"][0]),
                       "voxels_numpy": len(grid["numpy"][0])}
        sub = grid["native"][0]
        sec, trees = _host_turns({"native": lambda: native.KDTree(sub),
                                  "scipy": lambda: cKDTree(sub)})
        row["tree"] = {"s": sec}
        nat, ref = trees["native"], trees["scipy"]
        for k, q in ((1, xyz), (16, xyz[np.sort(gen.choice(
                len(xyz), NATIVE_KNN16_QUERIES, replace=False))])):
            sec, res = _host_turns({"native": lambda: nat.query(q, k),
                                    "scipy": lambda: ref.query(q, k)})
            row[f"knn{k}"] = {"s": sec, "queries": len(q), **knn_vs_scipy(
                f"{phase} room {r} k = {k}", sub, q, res["native"],
                res["scipy"])}
        centers = sub[gen.choice(len(sub), NATIVE_RADIUS_CENTERS,
                                 replace=False)]
        sec, res = _host_turns({
            "native": lambda: [nat.query_ball_point(c, radius)
                               for c in centers],
            "scipy": lambda: [ref.query_ball_point(c, radius)
                              for c in centers]})
        boundary = sum(radius_vs_scipy(f"{phase} room {r} center {i}", sub,
                                       c, radius, a, b)
                       for i, (c, a, b) in enumerate(zip(
                           centers, res["native"], res["scipy"])))
        row["radius"] = {"s": sec, "centers": len(centers),
                         "boundary_ties": boundary,
                         "mean_points": float(np.mean(
                             [len(a) for a in res["native"]]))}
        rows.append(row)
        g, t, rad = row["grid"], row["tree"]["s"], row["radius"]
        knn = "; ".join(
            f"k = {k} on {row[f'knn{k}']['queries']} queries native "
            f"{row[f'knn{k}']['s']['native']:.4f} s, scipy "
            f"{row[f'knn{k}']['s']['scipy']:.4f} s, "
            f"{row[f'knn{k}']['ties']} slots differ at ties" for k in (1, 16))
        log(phase, f"room {r}: {len(xyz)} points -> {g['voxels']} voxels "
            f"(numpy path {g['voxels_numpy']}), equal to the twin to the "
            f"bit; grid native {g['s']['native']:.4f} s, numpy "
            f"{g['s']['numpy']:.4f} s, twin {g['s']['twin']:.4f} s; tree "
            f"native {t['native']:.4f} s, scipy {t['scipy']:.4f} s; {knn}; "
            f"radius {radius} around {len(centers)} centers "
            f"({rad['mean_points']:.0f} points each) native "
            f"{rad['s']['native']:.4f} s, scipy {rad['s']['scipy']:.4f} s, "
            f"{boundary} points at the radius in one set only")
    seconds = time.perf_counter() - t_start
    log(phase, f"{gpu_line()} | host times; phase {seconds:.2f} s")
    return {"rooms": rows, "cell": cell, "radius": radius,
            "nvidia_smi": gpu_line(), "seconds": seconds}


def _projection_check(phase, r, sub_xyz, full_xyz, idx, d2, gen) -> dict:
    """The projection's output at ``PROJECTION_CHECKS`` seeded queries
    against ``knn_plain`` (k = 2, supports as stored) on the card: d2
    equal to the bit everywhere, the index equal wherever the nearest is
    unique. Returns the counts and the plain version's ms."""
    from closerlook3d_tpu_torch.ops.neighbors import knn_plain

    sel = np.sort(gen.choice(len(full_xyz), PROJECTION_CHECKS, replace=False))
    q = torch.from_numpy(full_xyz[sel]).to(DEVICE)[None]
    s = torch.from_numpy(sub_xyz).to(DEVICE)[None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pi, pd = knn_plain(q, s, 2, chunk_size=512)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pi, pd = pi[0].cpu().numpy(), pd[0].cpu().numpy()
    if not np.array_equal(d2[sel], pd[:, 0]):
        bad = np.flatnonzero(d2[sel] != pd[:, 0])
        raise AssertionError(f"{phase} room {r}: projection d2 differs from "
                             f"knn_plain's at {len(bad)} of {len(sel)} "
                             f"queries, first {sel[bad[:4]].tolist()}")
    unique = pd[:, 0] < pd[:, 1]
    wrong = unique & (idx[sel] != pi[:, 0])
    if wrong.any():
        raise AssertionError(f"{phase} room {r}: projection index differs "
                             f"from knn_plain's at {int(wrong.sum())} "
                             f"queries with a unique nearest")
    return {"checked": len(sel), "unique": int(unique.sum()),
            "ties": int((~unique).sum()),
            "ties_other_index": int((~unique & (idx[sel] != pi[:, 0])).sum()),
            "plain_ms_checked_queries": plain_ms}


def phase_s3dis_voting(wrappers) -> dict:
    """S3DIS sphere voting, the evaluation the paper reports, at the full
    width of ``configs/s3dis/pospool_xyz_avg.yaml`` (8 x 15000 points a
    sphere batch, in_radius 2.0, cell 0.04; set in code): two test-area
    rooms of ``VOTING_ROOM_POINTS`` points written into the processed
    cache, ``evaluate_s3dis_voting`` through ``Predictor`` with seeded
    weights and ``VOTING_VOTES`` votes. Every sphere batch must launch its
    forward's kernels (``seg_launches``), the projection to the full
    clouds one pruned 1-NN a room; its d2 must equal ``knn_plain``'s at
    ``PROJECTION_CHECKS`` queries a room and its index wherever the nearest
    is unique; the metrics must be finite and ``sphere_batches`` the
    number of forwards. The rooms' preparation and sphere queries must go
    through the native host ops (built by ``phase_build``). Times the
    projection by device time with the sub-cloud as stored and
    Morton-sorted."""
    import shutil
    import tempfile

    from closerlook3d_tpu_torch import native
    from closerlook3d_tpu_torch.data.s3dis import S3DIS
    from closerlook3d_tpu_torch.data.spatial_host import morton_keys_np
    from closerlook3d_tpu_torch.ops.neighbors import knn1_cuda
    from closerlook3d_tpu_torch.ops.spatial import (
        apply_permutation, morton_sort)
    from closerlook3d_tpu_torch.serving import Predictor
    from closerlook3d_tpu_torch.train import evaluate as ev

    phase = "s3dis-voting"
    t_start = time.perf_counter()
    cfg = seg_config("s3dis")
    cfg.num_votes = VOTING_VOTES
    if not native.is_built():
        raise AssertionError(f"{phase}: the native host ops are not built")
    root = tempfile.mkdtemp(prefix="_voting_rooms_", dir=REPO)
    try:
        prep_s = write_voting_rooms(root, cfg.first_subsampling_dl)
        cfg.data_root = root
        ds = S3DIS(cfg, "test")
        if not all(isinstance(t, native.KDTree) for t in ds.trees):
            raise AssertionError(f"{phase}: the rooms' sphere queries do not "
                                 f"go through the native kd-tree")
        weights = seeded_weights(cfg, torch.Generator().manual_seed(SEED + 30))
        predictor = Predictor(cfg, weights, device=DEVICE)
        per_forward = seg_launches(cfg)
        forwards = []

        def eval_logits(state, batch):
            before = read_counts(wrappers)
            out = state(batch["xyz"], batch["mask"], batch["features"])
            counts = read_counts(wrappers)
            check_counts(f"{phase} sphere batch {len(forwards)}",
                         {k: counts[k] - before[k] for k in counts},
                         per_forward)
            forwards.append(int(batch["mask"].sum()))
            return out

        projections = []
        project = ev.project_to_full

        def recording_projection(sub_xyz, full_xyz, device):
            idx, d2 = project(sub_xyz, full_xyz, device)
            projections.append((idx, d2))
            return idx, d2

        ev.project_to_full = recording_projection
        try:
            reset_counts(wrappers)
            t0 = time.perf_counter()
            res = ev.evaluate_s3dis_voting(cfg, ds, predictor, eval_logits)
            torch.cuda.synchronize()
            vote_s = time.perf_counter() - t0
            launches = read_counts(wrappers)
        finally:
            ev.project_to_full = project
        nb, rooms = res["sphere_batches"], len(ds.xyz)
        expected = {k: v * nb for k, v in per_forward.items()}
        expected["knn1"] += rooms
        check_counts(phase, launches, expected)
        if nb != len(forwards) or nb < 1:
            raise AssertionError(f"{phase}: {nb} sphere batches, "
                                 f"{len(forwards)} forwards")
        metrics = [res[k] for k in ("miou", "oa", "subcloud_miou",
                                    "subcloud_oa")] + res["iou_per_class"]
        if not np.isfinite(metrics).all():
            raise AssertionError(f"{phase}: metrics not finite {res}")
        gen = np.random.default_rng(SEED + 31)
        rows = []
        for r, (idx, d2) in enumerate(projections):
            full_xyz, _ = ds.full_cloud(r)
            check = _projection_check(phase, r, ds.xyz[r], full_xyz, idx, d2,
                                      gen)
            # the sub-cloud as stored (voxels in the order of their first
            # point) and Morton-sorted, as project_to_full sorts it on the
            # card: the host's keys (data/spatial_host.py) give the same
            # permutation
            sub = ds.xyz[r]
            q = torch.from_numpy(full_xyz).to(DEVICE)[None]
            s_stored = torch.from_numpy(sub).to(DEVICE)[None]
            perm = morton_sort(s_stored)[0]
            host_perm = np.argsort(morton_keys_np(sub[None], np.ones(
                (1, len(sub)), bool))[0], kind="stable")
            if not np.array_equal(perm[0].cpu().numpy(), host_perm):
                raise AssertionError(f"{phase} room {r}: the card's Morton "
                                     f"order differs from the host's")
            s_morton = apply_permutation(s_stored, perm)
            smask = torch.ones(s_stored.shape[:2], dtype=torch.bool,
                               device=DEVICE)

            def one_nn(qq, ss):
                return knn1_cuda(qq, ss, 1, smask)

            def sorted_nn(qq, ss):
                pp = morton_sort(ss)[0]
                idx, d2 = knn1_cuda(qq, apply_permutation(ss, pp), 1, smask)
                return torch.gather(pp, 1, idx[..., 0].long()), d2

            (stored_ms, stored_ops), (morton_ms, morton_ops) = _device_pair(
                one_nn, [(q, s_stored)], one_nn, [(q, s_morton)], 10)
            with_sort = {}
            sorted_ms, sorted_ops = _device_time(sorted_nn, [(q, s_stored)],
                                                 10, per_op=with_sort)
            bound = knn_bound(q, s_stored, 1, smask)

            def stored_projection():
                qq = torch.as_tensor(full_xyz, device=DEVICE)[None]
                ss = torch.as_tensor(sub, device=DEVICE)[None]
                idx, d2 = knn1_cuda(qq, ss, 1)
                return idx[0, :, 0].cpu().numpy(), d2[0, :, 0].cpu().numpy()

            # the whole call on the host's clock, copies included, in turns
            wall = {"stored": [], "morton": []}
            for what in ("stored", "morton", "morton", "stored") * 2:
                fn = stored_projection if what == "stored" else (
                    lambda: ev.project_to_full(sub, full_xyz, DEVICE))
                fn()
                t0 = time.perf_counter()
                fn()
                wall[what].append((time.perf_counter() - t0) * 1e3)
            row = {"room": ds.room_names[r], "full_points": len(full_xyz),
                   "sub_points": len(ds.xyz[r]),
                   "device_ms_stored": stored_ms,
                   "device_ms_morton": morton_ms,
                   "device_ops": stored_ops,
                   "device_ms_with_sort": sorted_ms,
                   "device_ops_with_sort": sorted_ops,
                   "ms_stored": _time(one_nn, [(q, s_stored)], 10),
                   "ms_morton": _time(one_nn, [(q, s_morton)], 10),
                   "kept": "morton",
                   "wall_ms_stored": float(np.median(wall["stored"])),
                   "wall_ms_morton": float(np.median(wall["morton"])),
                   **bound, **check}
            rows.append(row)
            log(phase, f"room {r}: {len(full_xyz)} points onto "
                f"{len(ds.xyz[r])} sub-points: projection device "
                f"{stored_ms:.5f} ms with the sub-cloud as stored, "
                f"{morton_ms:.5f} ms "
                f"Morton-sorted ({stored_ops} ops), {sorted_ms:.5f} ms with "
                f"the sort and the map back on the card ({sorted_ops} ops; "
                f"kept: {row['kept']}); "
                f"events {row['ms_stored']:.4f} / {row['ms_morton']:.4f} ms; "
                f"whole call on the host's clock (copies in) "
                f"{row['wall_ms_stored']:.3f} / {row['wall_ms_morton']:.3f} "
                f"ms; "
                f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}), "
                f"all pairs {bound['all_pairs_ms']:.3f} ms; d2 equal to "
                f"knn_plain at {check['checked']} queries, index at the "
                f"{check['unique']} with a unique nearest ({check['ties']} "
                f"ties, {check['ties_other_index']} of them another tied "
                f"sub-point; plain {check['plain_ms_checked_queries']:.1f} "
                f"ms for those queries)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_start
    log(phase, f"{nb} sphere batches of {cfg.batch_size} x "
        f"{cfg.num_points} points over {rooms} rooms, {VOTING_VOTES} votes: "
        f"{nb / vote_s:.3f} sphere batches/s ({vote_s:.2f} s voting and "
        f"projection, {prep_s:.2f} s writing the rooms, phase {seconds:.2f} "
        f"s; rooms prepared and queried by the native host ops); mIoU "
        f"{res['miou']:.4f}, OA {res['oa']:.4f}, sub-cloud mIoU "
        f"{res['subcloud_miou']:.4f} (random weights); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return {"result": res, "launches": launches, "sphere_batches": nb,
            "valid_points_per_batch": float(np.mean(forwards)),
            "votes": VOTING_VOTES, "rooms": rows,
            "sphere_batches_per_s": nb / vote_s, "voting_s": vote_s,
            "prep_s": prep_s, "seconds": seconds}


def phase_device_sort(wrappers) -> dict:
    """The model's device sort (``spatial_sort``: always, or auto above
    2048 points): ``morton_sort`` of an 8 x 15000 batch on the card gives
    the CPU's permutation exactly, and an f32 S3DIS request with
    ``spatial_sort: auto`` on an unsorted batch equals, in caller order,
    the request on the host-sorted batch (the segmentation serving
    phase's card-vs-CPU tolerance)."""
    from closerlook3d_tpu_torch.data.spatial_host import (
        morton_keys_np, morton_sort_batch)
    from closerlook3d_tpu_torch.ops.spatial import morton_sort
    from closerlook3d_tpu_torch.serving import Predictor

    phase = "device-sort"
    cfg = seg_config("s3dis")
    cfg.precision = "f32"
    b = seg_batch(cfg, SEED + 1400, padded=(2,), duplicated=(5,), sort=False)
    xyz, mask = torch.from_numpy(b["xyz"]), torch.from_numpy(b["mask"])
    cpu = morton_sort(xyz, mask)
    card = morton_sort(xyz.to(DEVICE), mask.to(DEVICE))
    for what, c, g in zip(("perm", "inv"), cpu, card):
        if not torch.equal(c, g.cpu()):
            raise AssertionError(f"{phase}: card {what} differs from the "
                                 f"CPU's at {int((c != g.cpu()).sum())}")
    sort_ms = _time(morton_sort, [(xyz.to(DEVICE), mask.to(DEVICE))], 20)
    weights = seeded_weights(cfg, torch.Generator().manual_seed(SEED + 32))
    host = morton_sort_batch(b)
    perm = np.argsort(morton_keys_np(b["xyz"], b["mask"]), axis=1,
                      kind="stable")
    auto = copy.deepcopy(cfg)
    auto.spatial_sort = "auto"
    reset_counts(wrappers)
    got = Predictor(auto, weights, device=DEVICE)(
        b["xyz"], b["mask"], b["features"]).cpu()
    check_counts(phase, read_counts(wrappers), seg_launches(cfg))
    ref = Predictor(cfg, weights, device=DEVICE)(
        host["xyz"], host["mask"], host["features"]).cpu()
    inv = torch.from_numpy(np.argsort(perm, axis=1))
    ref = torch.gather(ref, 1, inv[..., None].expand(-1, -1, ref.shape[-1]))
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4)
    err = float((got - ref).abs().max())
    log(phase, f"morton_sort of {tuple(xyz.shape)} on the card: perm and "
        f"inverse equal to the CPU's ({sort_ms:.4f} ms); spatial_sort auto "
        f"request on the unsorted batch vs host-sorted, caller order: max "
        f"abs err {err:.3g}")
    return {"sort_ms": sort_ms, "request_max_abs_err": err}


# ---- the training engine ---------------------------------------------------

ENGINE_CFG = "configs/modelnet40/pospool_xyz_avg.yaml"
# full width and depth as the file stands (bf16, 5000 points, batch 32),
# on synthetic clouds: 4 steps an epoch and 2 validation batches
ENGINE_OVERRIDES = ["datasets=synthetic", "synthetic_train_size=128",
                    "synthetic_val_size=64", "epochs=2", "save_interval=1",
                    "val_interval=1", "log_interval=1", "num_workers=1"]


def engine_config(**changes):
    """The engine phase's config, read from ``ENGINE_CFG`` by the port's
    YAML reader (no PyYAML on the card's machine) with its overrides."""
    from closerlook3d_tpu_torch.utils.config import (
        load_config, parse_overrides)

    cfg = load_config(os.path.join(REPO, ENGINE_CFG),
                      parse_overrides(ENGINE_OVERRIDES))
    for key, value in changes.items():
        cfg[key] = value
    return cfg


def engine_launches(steps: int, forwards: int) -> dict:
    """Exact launches of ``steps`` train steps and ``forwards`` eval
    forwards of the xyz config."""
    train, fwd = launches_per("xyz", "train"), launches_per("xyz", "forward")
    return {k: steps * train[k] + forwards * fwd[k] for k in train}


def _step_seconds(scalars: list, steps_per_epoch: int) -> dict:
    """{step: seconds} from ``train/batch_time``, logged at every step
    (log_interval 1) as the epoch's running mean."""
    means = {r["step"]: r["value"] for r in scalars
             if r["tag"] == "train/batch_time"}
    out = {}
    for step, mean in sorted(means.items()):
        i = (step - 1) % steps_per_epoch + 1  # the step's place in its epoch
        out[step] = i * mean - (i - 1) * means[step - 1] if i > 1 else mean
    return out


def _state_tensors(state) -> dict:
    """Every tensor of a train state: parameters, BatchNorm buffers and
    the optimizer's per-parameter state (momentum)."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for idx, per in state.optimizer.state_dict()["state"].items():
        out.update({f"opt/{idx}/{k}": v for k, v in per.items()})
    return out


def phase_engine(wrappers) -> dict:
    """The training engine at full width, as a user runs it: the train CLI
    on ``ENGINE_CFG`` read without PyYAML, 2 epochs on synthetic clouds
    (checkpoints at steps 4 and 8, the best one, scalars, finite losses,
    the exact launches of its 8 steps and 4 validation forwards); a
    resumed ``Trainer`` to epoch 3 (step 12), and a further one whose
    restored state must equal it bit for bit; the evaluate CLI on the
    saved checkpoint, whose accuracy must equal ``evaluate_classification``
    on that state. Prints the host time of each epoch, the median step
    time from ``scalars.jsonl``, checkpoint save and restore times, and one
    more epoch without the prefetcher beside a prefetched one."""
    import io
    import shutil
    import tempfile

    from closerlook3d_tpu_torch.cli import evaluate as cli_evaluate
    from closerlook3d_tpu_torch.cli import train as cli_train
    from closerlook3d_tpu_torch.data.build import build_dataset
    from closerlook3d_tpu_torch.data.loader import BatchIterator
    from closerlook3d_tpu_torch.train import loop
    from closerlook3d_tpu_torch.train.checkpoints import CheckpointManager
    from closerlook3d_tpu_torch.train.evaluate import evaluate_classification
    from closerlook3d_tpu_torch.train.step import eval_logits

    phase = "engine"
    t_start = time.perf_counter()
    cfg = engine_config()
    spe = cfg.synthetic_train_size // cfg.batch_size
    val_batches = -(-cfg.synthetic_val_size // cfg.batch_size)
    epoch_s = {}
    untimed = loop.Trainer.train_one_epoch

    def timed(self, epoch):
        # the epoch's last step reads the loss, so the card is done
        t0 = time.perf_counter()
        out = untimed(self, epoch)
        epoch_s[epoch] = time.perf_counter() - t0
        return out

    root = tempfile.mkdtemp(prefix="_engine_", dir=REPO)
    loop.Trainer.train_one_epoch = timed
    try:
        run = os.path.join(root, "run")
        reset_counts(wrappers)
        cli_train.main(["--cfg", os.path.join(REPO, ENGINE_CFG),
                        "--log_dir", run] + ENGINE_OVERRIDES)
        launches = read_counts(wrappers)
        check_counts(f"{phase} cli train", launches, engine_launches(
            cfg.epochs * spe, cfg.epochs * val_batches))
        ckpt = CheckpointManager(os.path.join(run, "ckpt"))
        best = CheckpointManager(os.path.join(run, "ckpt_best"))
        if ckpt.steps() != [spe, 2 * spe] or len(best.steps()) != 1:
            raise AssertionError(f"{phase}: checkpoints {ckpt.steps()}, "
                                 f"best {best.steps()}")
        with open(os.path.join(run, "scalars.jsonl")) as f:
            scalars = [json.loads(ln) for ln in f]
        tags = {r["tag"] for r in scalars}
        losses = [r["value"] for r in scalars if r["tag"] == "train/loss"]
        if not {"train/loss", "val/acc"} <= tags or not losses or not all(
                np.isfinite(losses)):
            raise AssertionError(f"{phase}: scalars {sorted(tags)}, "
                                 f"losses {losses}")

        resumed = loop.Trainer(engine_config(epochs=3), run, device=DEVICE)
        if (resumed.start_epoch, resumed.state.step) != (3, 2 * spe):
            raise AssertionError(
                f"{phase}: resumed at epoch {resumed.start_epoch}, step "
                f"{resumed.state.step}")
        reset_counts(wrappers)
        resumed.fit()
        check_counts(f"{phase} resumed epoch", read_counts(wrappers),
                     engine_launches(spe, val_batches))
        if resumed.state.step != 3 * spe:
            raise AssertionError(f"{phase}: fit ended at step "
                                 f"{resumed.state.step}")
        again = loop.Trainer(engine_config(epochs=3, num_workers=0), run,
                             device=DEVICE)
        if (again.start_epoch, again.state.step) != (4, 3 * spe):
            raise AssertionError(
                f"{phase}: second resume at epoch {again.start_epoch}, "
                f"step {again.state.step}")
        want, got = _state_tensors(resumed.state), _state_tensors(again.state)
        differ = [k for k in want if k not in got
                  or not torch.equal(want[k], got[k])]
        if differ or len(want) != len(got):
            raise AssertionError(f"{phase}: restored state differs at "
                                 f"{differ[:5]} ({len(differ)} tensors)")

        out = io.StringIO()
        reset_counts(wrappers)
        with contextlib.redirect_stdout(out):
            cli_evaluate.main(["--cfg", os.path.join(REPO, ENGINE_CFG),
                               "--load_path", os.path.join(run, "ckpt"),
                               "--log_dir", os.path.join(root, "eval")]
                              + ENGINE_OVERRIDES)
        check_counts(f"{phase} cli evaluate", read_counts(wrappers),
                     engine_launches(0, val_batches))
        result = json.loads(out.getvalue().strip().splitlines()[-1])
        ecfg = engine_config()
        it = BatchIterator(build_dataset(ecfg, "test"), ecfg.batch_size,
                           shuffle=False, feature_spec=ecfg.input_features,
                           drop_last=False,
                           spatial_sort=ecfg.spatial_sort == "host")
        ref = evaluate_classification(ecfg, again.state, eval_logits, it)
        if result["accuracy"] != ref["accuracy"]:
            raise AssertionError(f"{phase}: cli accuracy {result}, the "
                                 f"state's {ref}")

        ckpt_ms = {"save": [], "restore": []}
        timing = CheckpointManager(os.path.join(root, "timing"), keep=2)
        for i in range(5):
            t0 = time.perf_counter()
            timing.save(again.state.step, again.state, extra={"epoch": 3})
            ckpt_ms["save"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            timing.restore(again.state)
            torch.cuda.synchronize()
            ckpt_ms["restore"].append((time.perf_counter() - t0) * 1e3)
        ckpt_bytes = os.path.getsize(os.path.join(
            root, "timing", f"ckpt_{again.state.step}.pt"))

        # the host's share: assembling a training batch, no device work
        batch_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in again.train_iter:
                batch_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
        again.train_one_epoch(4)  # one more epoch without the prefetcher
        again.writer.close()
        with open(os.path.join(run, "scalars.jsonl")) as f:
            scalars = [json.loads(ln) for ln in f]
    finally:
        loop.Trainer.train_one_epoch = untimed
        shutil.rmtree(root, ignore_errors=True)
    steps = _step_seconds(scalars, spe)
    prefetched = [v for k, v in steps.items() if k <= 3 * spe]
    plain = [v for k, v in steps.items() if k > 3 * spe]
    rec = {"epoch_s": epoch_s, "step_s": steps,
           "median_step_ms_prefetch": float(np.median(prefetched) * 1e3),
           "median_step_ms_no_prefetch": float(np.median(plain) * 1e3),
           "ckpt_save_ms": float(np.median(ckpt_ms["save"])),
           "ckpt_restore_ms": float(np.median(ckpt_ms["restore"])),
           "ckpt_bytes": ckpt_bytes, "launches": launches,
           "median_batch_assembly_ms": float(np.median(batch_ms)),
           "tensors_compared": len(want), "accuracy": result["accuracy"],
           "seconds": time.perf_counter() - t_start}
    log(phase, f"{gpu_line()} | cli train {cfg.epochs} epochs x {spe} steps "
        f"of {cfg.batch_size} x {cfg.num_points} points (width "
        f"{cfg.width}, depth {cfg.depth}, {cfg.precision}) + {val_batches} "
        f"validation batches an epoch: epochs on the host's clock "
        f"{ {k: round(v, 4) for k, v in epoch_s.items()} } s (1-3 "
        f"prefetched, 4 without); median step "
        f"{rec['median_step_ms_prefetch']:.3f} ms prefetched (epochs 1-3), "
        f"{rec['median_step_ms_no_prefetch']:.3f} ms without (epoch 4); "
        f"assembling a batch on the host alone "
        f"{rec['median_batch_assembly_ms']:.3f} ms (median of "
        f"{len(batch_ms)}); "
        f"checkpoint ({ckpt_bytes} bytes) save "
        f"{rec['ckpt_save_ms']:.3f} ms, restore {rec['ckpt_restore_ms']:.3f} "
        f"ms; resume bit-equal over {len(want)} tensors; cli evaluate "
        f"accuracy {result['accuracy']:.4f} (random start, 12 steps) equal "
        f"to evaluate_classification's; phase {rec['seconds']:.2f} s")
    return rec


# ---- export: the artifact of serving/export.py ---------------------------

EXPORT_NAMES = ("flagship", "sincos", "adaptive", "pwmlp", "pgrid",
                "shapenetpart", "s3dis")
# the ModelNet40 operator configs export at depth 1 and 8 clouds (full
# width and points; the pseudo-grid at half width, whose full-width
# artifact took 565 MB), so that the phase stays under a minute
EXPORT_OPERATOR_DEPTH = 1
EXPORT_OPERATOR_BATCH = 8
EXPORT_PGRID_WIDTH = 72
# requests of each served function timed in turns; the flagship alone is
# also profiled and timed with the program's metadata asserts
EXPORT_TIMED = 3
# the kernel each configuration is in the phase for (beside the ball
# query, and FPS or the grid, the PosPool xyz and the max of every one)
EXPORT_KERNELS = {"flagship": ("pospool_xyz", "fps"),
                  "sincos": ("pospool_sincos",), "adaptive": ("moments",),
                  "pwmlp": ("gather_sub_minmax",), "pgrid": ("pseudo_grid",),
                  "shapenetpart": ("knn",), "s3dis": ("knn1", "knn")}


def export_config(name: str):
    """The configuration of ``phase_export``'s ``name``: the flagship, a
    ModelNet40 operator config (``operator_config``) at depth 1 and 8
    clouds (the pseudo-grid at ``EXPORT_PGRID_WIDTH``), or a segmentation
    serving config as ``phase_seg_serving`` serves it."""
    if name == "flagship":
        return flagship_config()
    if name in SEG_NAMES:
        return seg_config(name)
    cfg = operator_config(name)
    cfg.depth = EXPORT_OPERATOR_DEPTH
    cfg.batch_size = EXPORT_OPERATOR_BATCH
    if name == "pgrid":
        cfg.width = EXPORT_PGRID_WIDTH
    return cfg


def export_batch(cfg, name: str, seed: int, padded: bool) -> dict:
    """A request's batch: clouds 1 and the last padded when ``padded``."""
    nb = cfg.batch_size
    pad = (1, nb - 1) if padded else ()
    if name in SEG_NAMES:
        return seg_batch(cfg, seed, padded=pad)
    return make_batch(seed, padded=pad, batch=nb, points=cfg.num_points)


def _turns(fns, batches, n: int) -> list:
    """Host-clock ms of ``n`` requests of each function of ``fns``, read in
    turns (in order, then in reverse, ...) over ``batches``, each ending in
    a synchronize, after a warm-up request of each per batch: a sorted
    list per function."""
    for bt in batches:
        for fn in fns:
            fn(bt["xyz"], bt["mask"], bt["features"])
    torch.cuda.synchronize()
    lat = [[] for _ in fns]
    for i in range(n):
        bt = batches[i % len(batches)]
        order = range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))
        for j in order:
            t0 = time.perf_counter()
            fns[j](bt["xyz"], bt["mask"], bt["features"])
            torch.cuda.synchronize()
            lat[j].append((time.perf_counter() - t0) * 1e3)
    return [sorted(t) for t in lat]


def _export_one(name: str, wrappers, root: str) -> dict:
    """Export, save, load and serve one configuration (see
    ``phase_export``)."""
    import shutil

    from closerlook3d_tpu_torch.serving import (
        Predictor, export_forward, load_forward)

    phase = f"export:{name}"
    cfg = export_config(name)
    weights = seeded_weights(cfg, torch.Generator().manual_seed(SEED + 30))
    predictor = Predictor(cfg, weights, device=DEVICE)
    out_dir = os.path.join(root, name)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    export_forward(cfg, predictor.model, out_dir)
    export_s = time.perf_counter() - t0
    check_counts(f"{phase}: the export", read_counts(wrappers),
                 dict.fromkeys(wrappers, 0))
    nbytes = {f: os.path.getsize(os.path.join(out_dir, f))
              for f in sorted(os.listdir(out_dir))}
    t0 = time.perf_counter()
    artifact, meta = load_forward(out_dir)
    load_s = time.perf_counter() - t0
    if meta["platforms"] != [torch.device(DEVICE).type]:
        raise AssertionError(f"{phase}: platforms {meta['platforms']}")
    graph_ops = {}
    for node in artifact._forward.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith(
                "cl3d."):
            key = str(node.target)
            graph_ops[key] = graph_ops.get(key, 0) + 1

    batches = [export_batch(cfg, name, SEED + 700 + r, padded=r == 1)
               for r in range(REQUESTS)]
    expected = None
    if name == "flagship":
        expected = launches_per("xyz", "forward")
    elif name in SEG_NAMES:
        expected = seg_launches(cfg)
    diffs = []
    for i, bt in enumerate(batches):
        args = (bt["xyz"], bt["mask"], bt["features"])
        reset_counts(wrappers)
        ref = predictor(*args)
        torch.cuda.synchronize()
        eager = read_counts(wrappers)
        if expected is None:  # depth 1: the eager request's own count
            expected = eager
        check_counts(f"{phase}: Predictor request {i}", eager, expected)
        reset_counts(wrappers)
        got = artifact(*args)
        torch.cuda.synchronize()
        check_counts(f"{phase}: artifact request {i}", read_counts(wrappers),
                     expected)
        if (got.shape != ref.shape or got.dtype != torch.float32
                or not torch.isfinite(got).all()):
            raise AssertionError(f"{phase}: request {i} logits "
                                 f"{tuple(got.shape)} {got.dtype}")
        diffs.append(float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"{phase}: request {i}: artifact logits "
                                 f"differ from Predictor's by up to "
                                 f"{diffs[-1]:.3g}")
    for k in EXPORT_KERNELS[name]:
        if not expected[k]:
            raise AssertionError(f"{phase}: {k} not on the path")
    bt = batches[0]
    half = cfg.num_points // 2
    wrong = (bt["xyz"][:, :half], bt["mask"][:, :half],
             bt["features"][:, :half])
    refused = {}
    for what, fn in (("ExportedPredictor", artifact),
                     ("the exported program", lambda *a: artifact._forward(
                         *(torch.as_tensor(x, device=DEVICE) for x in a)))):
        try:
            fn(*wrong)
        except Exception as e:  # noqa: BLE001 - any refusal will do
            refused[what] = type(e).__name__
        else:
            raise AssertionError(f"{phase}: {what} served a request of "
                                 f"{half} points")
    fns = [predictor, artifact]
    kept = None
    n_asserts = 0
    if name == "flagship":
        # the program as saved, with torch.export's metadata asserts, which
        # load_forward drops (serving/export.py::without_metadata_asserts)
        kept = torch.export.load(os.path.join(out_dir, "forward.pt2")).module()
        n_asserts = sum(1 for node in kept.graph.nodes
                        if "_assert_tensor_metadata" in str(node.target))

        def with_asserts(xyz, mask, features):
            with torch.inference_mode():
                return kept(*(torch.as_tensor(x, device=DEVICE)
                              for x in (xyz, mask, features)))

        if not torch.equal(with_asserts(*args), got):
            raise AssertionError(f"{phase}: the program with its asserts "
                                 f"differs")
        fns.append(with_asserts)
    lats = _turns(fns, batches, EXPORT_TIMED)
    lat_p, lat_a = lats[:2]
    lat_k = lats[2] if kept is not None else []
    med_p, med_a = (t[len(t) // 2] for t in (lat_p, lat_a))
    med_k = lat_k[len(lat_k) // 2] if lat_k else None
    busy = {}
    if name == "flagship":
        for label, fn, med in (("predictor", predictor, med_p),
                               ("artifact", artifact, med_a)):
            _, busy[label] = _profiled(
                lambda fn=fn: fn(bt["xyz"], bt["mask"], bt["features"]), 3,
                med)
    n_launch = sum(expected.values())
    log(phase, f"{gpu_line()} | {cfg.batch_size} x {cfg.num_points} points, "
        f"width {cfg.width}, depth {cfg.depth}, {cfg.precision}: export "
        f"{export_s:.3f} s (0 launches), {sum(nbytes.values())} bytes "
        f"{nbytes}, load {load_s:.3f} s; graph {graph_ops}; {REQUESTS} "
        f"requests (the second padded) launched {n_launch} kernels each, "
        f"as Predictor's: "
        + str({k: v for k, v in expected.items() if v})
        + f"; logits equal to Predictor's to the bit; a request of {half} "
        f"points refused ({refused}); request median in turns over "
        f"{EXPORT_TIMED} each: artifact {med_a:.3f} ms, Predictor "
        f"{med_p:.3f} ms"
        + (f", the program with its {n_asserts} metadata asserts "
           f"{med_k:.3f} ms; device busy a request (profiler, 3 requests): "
           f"artifact {busy['artifact']['device_busy_ms']:.3f} ms, "
           f"Predictor {busy['predictor']['device_busy_ms']:.3f} ms"
           if kept is not None else ""))
    del artifact, predictor, kept
    shutil.rmtree(out_dir)
    return {"export_s": export_s, "artifact_bytes": nbytes, "load_s": load_s,
            "graph_ops": graph_ops, "launches_per_request": expected,
            "max_abs_diff": max(diffs), "refused": refused,
            "request_ms_artifact": lat_a, "request_ms_predictor": lat_p,
            "request_ms_median_artifact": med_a,
            "request_ms_median_predictor": med_p,
            "request_ms_with_asserts": lat_k,
            "request_ms_median_with_asserts": med_k,
            "metadata_asserts": n_asserts, "split": busy,
            "batch": cfg.batch_size, "points": cfg.num_points,
            "depth": cfg.depth}


def _dispatch_cost(reps: int = 400, block: int = 50) -> dict:
    """Host us a call of ``torch.ops.cl3d.neighborhood_max`` against its
    wrapper ``neighborhood_max_cuda`` called directly, at the flagship's
    first strided call, in blocks of ``block`` calls read in turns: the
    cost of the op's dispatch, which every kernel call of an eval forward
    pays once."""
    from closerlook3d_tpu_torch.models.backbone import compute_geometry
    from closerlook3d_tpu_torch.ops.grouping import neighborhood_max_cuda
    from closerlook3d_tpu_torch.utils.config import stage_plan

    cfg = flagship_config()
    bt = make_batch(SEED + 710)
    dev = torch.device(DEVICE)
    with torch.inference_mode():
        g = compute_geometry(cfg, torch.from_numpy(bt["xyz"]).to(dev),
                             torch.from_numpy(bt["mask"]).to(dev))
        gen = torch.Generator(device=dev).manual_seed(SEED + 711)
        f = _features(gen, g["xyz_0"], stage_plan(cfg)["widths"][0],
                      torch.bfloat16)
        args = (f, g["sidx_1"], g["smask_1"])
        op = torch.ops.cl3d.neighborhood_max.default
        if not torch.equal(op(*args), neighborhood_max_cuda(*args)):
            raise AssertionError("cl3d.neighborhood_max differs from its "
                                 "wrapper")
        us = {"op": [], "wrapper": []}
        for i in range(2 * reps // block):
            name = ("op", "wrapper", "wrapper", "op")[i % 4]
            fn = op if name == "op" else neighborhood_max_cuda
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(block):
                fn(*args)
            us[name].append((time.perf_counter() - t0) * 1e6 / block)
            torch.cuda.synchronize()
    med = {k: float(np.median(v)) for k, v in us.items()}
    calls = sum(launches_per("xyz", "forward").values())
    out = {"op_us": med["op"], "wrapper_us": med["wrapper"],
           "dispatch_us": med["op"] - med["wrapper"],
           "calls_per_flagship_request": calls,
           "dispatch_ms_per_flagship_request":
               (med["op"] - med["wrapper"]) * calls / 1e3}
    log("export:dispatch", f"{gpu_line()} | host us a call at the flagship's "
        f"first strided max, median of {reps // block} blocks of {block} "
        f"each, in turns: cl3d op {med['op']:.2f}, wrapper "
        f"{med['wrapper']:.2f}: the op's dispatch {out['dispatch_us']:.2f} "
        f"us a call, {out['dispatch_ms_per_flagship_request']:.4f} ms over "
        f"the {calls} kernel calls of a flagship request")
    return out


def phase_export(wrappers) -> dict:
    """``serving/export.py`` on the card, for every configuration of
    ``EXPORT_NAMES`` (together they put every ``cl3d`` op into an
    exported program): export the eval forward (no kernel launches),
    save, load it back from disk, serve 3 requests (the second with
    padded clouds) with exactly the launches of ``Predictor``'s eager
    request on the same batch (``launches_per("xyz", "forward")``,
    ``seg_launches``, or the eager count for the depth-1 configs) and
    logits equal to its to the bit; refuse a request of half the points;
    time requests of the artifact and of ``Predictor`` in turns. Then the
    op's dispatch cost a call (``_dispatch_cost``)."""
    import shutil

    t0 = time.perf_counter()
    root = os.path.join(REPO, f"_export_{os.getpid()}")
    os.makedirs(root, exist_ok=True)
    try:
        out = {name: _export_one(name, wrappers, root)
               for name in EXPORT_NAMES}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["dispatch"] = _dispatch_cost()
    out["seconds"] = time.perf_counter() - t0
    log("export", f"{len(EXPORT_NAMES)} configurations exported, loaded "
        f"and served in {out['seconds']:.1f} s")
    return out


# ---- data parallelism: ranks that share the card --------------------------

DP_RANKS = 2
DP_KINDS = ("xyz", "pwmlp")
DP_BATCH = 16  # clouds a rank
DP_POINTS = 1024
DP_STEPS = 3  # bf16 steps held to one process
DP_TIMED = 5  # bf16 steps timed after them
DP_TIMEOUT = 300.0
# the train CLI under torchrun: the flagship yaml cut to a small model
# (width 48, depth 1) on small synthetic splits: the machinery, not the
# model, is under test there
DP_CLI_OVERRIDES = ["datasets=synthetic", "synthetic_train_size=64",
                    "synthetic_val_size=40", "num_points=1024", "npoints=[]",
                    "radius=0.1", "width=48", "depth=1", "batch_size=8",
                    "epochs=1", "save_interval=1", "val_interval=1",
                    "log_interval=1", "keep_checkpoints=3"]


def dp_config(kind: str):
    """``train_config(kind)`` at ``DP_POINTS`` points (stages 1024, 256,
    64, 16, 4) and the flagship's radius, so that neighborhoods fill as
    at that size; full width and depth; ``DP_BATCH`` clouds a rank."""
    cfg = train_config(kind)
    cfg.num_points = DP_POINTS
    cfg.npoints = []
    cfg.radius = 0.1
    cfg.batch_size = DP_BATCH
    cfg.warmup_epoch = 0
    return cfg


def _params_digest(model) -> str:
    import hashlib

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def _dp_steps(cfg, weights, batch, wrappers, keep_state: bool,
              orders=(), timed=DP_TIMED) -> dict:
    """This process's share of the global ``batch`` (all of it without a
    process group), from ``weights``: one f32 step with dropout off
    (loss, global gradients, state), the same from ``weights`` again on
    the batch's clouds in each of ``orders`` ("f32_reordered"), then
    ``DP_STEPS`` bf16 steps with the config's dropout (losses, launches,
    parameter digests, collectives, state) and ``timed`` more, timed by
    CUDA events."""
    from closerlook3d_tpu_torch.models import build_classification
    from closerlook3d_tpu_torch.parallel import collectives
    from closerlook3d_tpu_torch.parallel.mesh import layout, shard_batch
    from closerlook3d_tpu_torch.train import (
        create_train_state, make_optimizer, make_train_step)

    lay = layout(DEVICE)
    ranks, rank = collectives.world()
    n = batch["xyz"].shape[0] // ranks
    local = shard_batch({k: v[rank * n:(rank + 1) * n]
                         for k, v in batch.items()}, lay)
    out = {"rank": rank, "ranks": ranks, "backend": lay.backend}

    def fresh(precision, dropout):
        c = copy.deepcopy(cfg)
        c.precision = precision
        c.dropout_rate = dropout
        model, loss_fn = build_classification(c)
        model.load_state_dict(weights)
        tx, _ = make_optimizer(c, STEPS_PER_EPOCH)
        return (create_train_state(model, tx, device=lay.device),
                make_train_step(loss_fn, c.task))

    state, step = fresh("f32", 0.0)
    runs = []
    for order in (None, *orders):
        if order is not None:  # the weights again, a fresh optimizer
            state.model.load_state_dict(weights)
            state.optimizer = state.tx.init(state.model)
            state.step = 0
        state, m = step(state, local if order is None else shard_batch(
            {k: v[order] for k, v in batch.items()}, lay), SEED)
        run = {"loss": float(m["loss"]), "digest": _params_digest(
            state.model)}
        if keep_state:
            run["grads"] = {k: p.grad.detach().float().cpu().clone()
                            for k, p in state.model.named_parameters()}
            run["state"] = {k: v.detach().cpu().clone()
                            for k, v in state.model.state_dict().items()}
        runs.append(run)
    out["f32"], out["f32_reordered"] = runs[0], runs[1:]
    del state, step
    state, step = fresh("bf16", cfg.dropout_rate)
    rec = {"losses": [], "accs": [], "launches": [], "digests": [],
           "collectives": [], "collective_ms": [], "step_ms": []}
    for i in range(DP_STEPS + timed):
        reset_counts(wrappers)
        collectives.reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        state, m = step(state, local, SEED)
        end.record()
        torch.cuda.synchronize()
        rec["step_ms"].append(start.elapsed_time(end))
        rec["collectives"].append(collectives.COUNTS["calls"])
        rec["collective_ms"].append(collectives.COUNTS["seconds"] * 1e3)
        if i < DP_STEPS:
            rec["launches"].append(read_counts(wrappers))
            rec["losses"].append(float(m["loss"]))
            rec["accs"].append(float(m["acc"]))
            rec["digests"].append(_params_digest(state.model))
            if i == DP_STEPS - 1 and keep_state:
                rec["state"] = {k: v.detach().float().cpu().clone()
                                for k, v in state.model.state_dict().items()}
    out["bf16"] = rec
    return out


def _dp_orders(n: int) -> list:
    """Other orders of a batch of ``n`` clouds: its halves swapped, the
    clouds reversed, and interleaved."""
    idx = np.arange(n)
    return [np.concatenate([idx[n // 2:], idx[:n // 2]]), idx[::-1],
            np.concatenate([idx[0::2], idx[1::2]])]


def _sums_per_rank(ctx, x):
    """A planted fault: the sum over ranks left out (each rank keeps its
    own statistics)."""
    return x.clone()


def _cotangents_per_rank(ctx, g):
    """A planted fault: the statistics' cotangents not summed over ranks
    (the step's gradients wrong yet finite)."""
    return g.clone()


# the controls of phase_data_parallel: broken syncs its limits must fail
# (the in-graph sum of the BatchNorm statistics, K6f's sums included)
DP_CONTROLS = {
    "per_rank_statistics": {"forward": staticmethod(_sums_per_rank),
                            "backward": staticmethod(_cotangents_per_rank)},
    "per_rank_cotangents": {"backward": staticmethod(_cotangents_per_rank)}}


def _dp_rank(rank: int, cases: list) -> dict:
    """One rank of ``phase_data_parallel``'s step: every case's
    ``_dp_steps`` (rank 0 returns its states and gradients), then, as
    controls, each case's f32 step and bf16 steps again under each fault
    of ``DP_CONTROLS`` ("controls")."""
    del rank
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from closerlook3d_tpu_torch.parallel import collectives

    wrappers = kernel_wrappers()
    keep = collectives.world()[1] == 0
    out, seconds = {"controls": {}}, {}
    for kind, cfg, weights, batch in cases:
        t0 = time.perf_counter()
        out[kind] = _dp_steps(cfg, weights, batch, wrappers, keep)
        seconds[kind] = time.perf_counter() - t0
    sound = collectives._AllReduceSum
    for name, faults in DP_CONTROLS.items():
        t0 = time.perf_counter()
        collectives._AllReduceSum = type("Faulty", (sound,), faults)
        try:
            out["controls"][name] = {
                kind: _dp_steps(cfg, weights, batch, wrappers, keep,
                                timed=0)
                for kind, cfg, weights, batch in cases}
        finally:
            collectives._AllReduceSum = sound
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def _rel_l2(got, ref) -> float:
    return float((got - ref).norm() / ref.norm())


def _state_gaps(prefix, got, ref) -> dict:
    """Relative L2 of the parameters and of the running statistics (each
    set concatenated), and the largest absolute difference."""
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    params = [k for k in ref if k not in stats]
    out = {f"{prefix}_abs_max": max(float((got[k].float() - v.float())
                                          .abs().max())
                                    for k, v in ref.items())}
    for part, keys in (("params", params), ("stats", stats)):
        out[f"{prefix}_{part}_rel_l2"] = _rel_l2(
            torch.cat([got[k].float().reshape(-1) for k in keys]),
            torch.cat([ref[k].float().reshape(-1) for k in keys]))
    return out


def _f32_gaps(got, ref) -> dict:
    """The f32 step's gaps of ``got`` against ``ref``."""
    grads = {k: _rel_l2(g, ref["grads"][k]) for k, g in got["grads"].items()}
    worst = max(grads, key=grads.get)
    return {"f32_loss_rel": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "f32_grad_rel_l2_max": grads[worst], "f32_grad_worst": worst,
            **_state_gaps("f32", got["state"], ref["state"])}


def _dp_gaps(single, r0) -> dict:
    """Rank 0's gaps to one process: the f32 step's and the bf16 steps'."""
    gaps = _f32_gaps(r0["f32"], single["f32"])
    gaps.update(_state_gaps("bf16", r0["bf16"]["state"],
                            single["bf16"]["state"]))
    gaps["bf16_loss_rel_max"] = float(np.max(np.abs(
        np.array(r0["bf16"]["losses"]) / np.array(single["bf16"]["losses"])
        - 1)))
    return gaps


def _dp_compare(kind, single, ranks, controls, expected) -> dict:
    """Hold the ranks to one process on the whole batch, and each control
    of ``DP_CONTROLS`` past the limits (see ``phase_data_parallel``); the
    gaps, limits and control gaps, and ("bad") every gap past its limit
    and every control key within it."""
    what = f"data-parallel:{kind}"
    r0 = ranks[0]
    gaps = _dp_gaps(single, r0)
    # the yardstick: one process against itself on the batch's clouds in
    # other orders, the same step summed in other orders
    spread = [_f32_gaps(r, single["f32"]) for r in single["f32_reordered"]]
    own = {k: max(g[k] for g in spread) for k in DP_F32_FLOOR[kind]}
    gaps.update({f"reordered_{k}": v for k, v in own.items()})
    limits = {key: max(floor, 2 * own[key])
              for key, floor in DP_F32_FLOOR[kind].items()}
    limits.update(DP_BF16_LIMIT[kind])
    bad = [f"{key} {gaps[key]:.3g} > {limit:.3g}"
           for key, limit in limits.items() if gaps[key] > limit]
    for r in ranks:
        for i, counts in enumerate(r["bf16"]["launches"]):
            check_counts(f"{what} rank {r['rank']} step {i}", counts,
                         expected)
        if r["bf16"]["digests"] != r0["bf16"]["digests"] or (
                r["f32"]["digest"] != r0["f32"]["digest"]):
            bad.append(f"rank {r['rank']}'s parameters differ from rank 0's")
    for i, counts in enumerate(single["bf16"]["launches"]):
        check_counts(f"{what} one process step {i}", counts, expected)
    control_gaps = {}
    for name, run in controls.items():
        c = control_gaps[name] = _dp_gaps(single, run)
        within = [f"{key} {c[key]:.3g} <= {limits[key]:.3g}"
                  for key in limits if key not in DP_CONTROL_BLIND[name]
                  and key not in DP_UNSEPARATED[kind]
                  and c[key] <= limits[key]]
        if within:
            bad.append(f"control {name} passes: " + ", ".join(within))
    log(what, "gaps to one process: " + ", ".join(
        f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
        for k, v in gaps.items()))
    log(what, "limits: " + ", ".join(f"{k} {v:.3g}"
                                     for k, v in limits.items()))
    for name, c in control_gaps.items():
        log(what, f"control {name}: " + ", ".join(
            f"{k} {c[k]:.3g}" for k in limits))
    return {"gaps": gaps, "limits": limits, "controls": control_gaps,
            "bad": [f"{what}: {b}" for b in bad]}


# The f32 step (dropout off) is the exact check: each gap within its floor
# or twice the largest gap of one process against itself on the clouds
# in ``_dp_orders`` (the same step summed in other orders), whichever is
# larger. The flagship's floors are phase_train_step_parity's. The point-
# wise MLP's BatchNorm variance E[h^2] - mean^2 cancels, and where a
# channel's variance is near 0 its clamp at 0 takes one side or the other
# with the summation order: one process on its clouds reordered moves
# its gradients by 0.1-5.5% (relative L2; the CPU rehearsal, all 23
# orders of 4 clouds), as the JAX package's own 1- and 2-device steps
# part (tests/test_torch_dp_parity.py). Its floors say so. Every limit
# lies below the controls' gaps (DP_CONTROLS, read on an H100; PERF.md
# §6): their f32 gradients part by 152-191%, their parameters by
# 1.5e-4 to 1.3e-2.
DP_F32_FLOOR = {
    "xyz": {"f32_loss_rel": 1e-5, "f32_grad_rel_l2_max": 2e-2,
            "f32_params_rel_l2": 1e-5, "f32_stats_rel_l2": 1e-4},
    "pwmlp": {"f32_loss_rel": 1e-4, "f32_grad_rel_l2_max": 1e-1,
              "f32_params_rel_l2": 1e-4, "f32_stats_rel_l2": 1e-4}}
# In bf16 (dropout on, equal seeds) a difference of the f32 statistics
# flips the rounding of some bf16 activations by an ulp (2^-8), and the
# head's BatchNorm over 32 pooled rows amplifies it. The 3 steps' losses,
# parameters and running statistics (relative L2 of each set) are held
# to limits a config that lie between the sound runs' gaps and those of
# the controls (DP_CONTROLS), both read on an H100 (PERF.md §6):
# the flagship's loss 0.46% against 2.4% and 3.5%, parameters 0.066%
# against 0.094% and 0.16%, statistics 0.56% against 0.89% and 4.7%; the
# point-wise MLP's loss 2.1% against 4.6% and 5.2%. Its bf16 parameters
# and statistics (4.8% and 4.2%) part from one process as far as under
# a broken sync (4.6-5.3%, 4.3-5.0%): three bf16 steps of it are only
# defined to that, so those two are bounds against a blow-up, not a
# check of the sync (DP_UNSEPARATED), which its f32 step makes.
DP_BF16_LIMIT = {
    "xyz": {"bf16_loss_rel_max": 1e-2, "bf16_params_rel_l2": 8e-4,
            "bf16_stats_rel_l2": 7e-3},
    "pwmlp": {"bf16_loss_rel_max": 3e-2, "bf16_params_rel_l2": 1e-1,
              "bf16_stats_rel_l2": 1e-1}}
DP_UNSEPARATED = {"xyz": (),
                  "pwmlp": ("bf16_params_rel_l2", "bf16_stats_rel_l2")}
# what a control cannot move: the cotangents' fault leaves the first
# step's forward (its loss, the running statistics it sets) as it was
DP_CONTROL_BLIND = {"per_rank_statistics": (),
                    "per_rank_cotangents": ("f32_loss_rel",
                                            "f32_stats_rel_l2")}


# The resume and the evaluation share one torchrun launch (a launch's
# processes spend most of it starting up): each rank joins the group,
# resumes with cli.train's main and evaluates with cli.evaluate's, each
# given its command line, and leaves the group
DP_RESUME_EVALUATE = """
import json, sys
from closerlook3d_tpu_torch.cli import evaluate, train
from closerlook3d_tpu_torch.parallel import mesh
argv = json.loads(sys.argv[1])
mesh.maybe_initialize_distributed(argv["device"])
train.main(argv["train"])
evaluate.main(argv["evaluate"])
mesh.destroy()
"""


def _torchrun(what: str, program: list, timeout: float) -> tuple:
    """``program`` (``["-m", module, *args]``, or ``["--no-python",
    executable, *args]``) under ``torch.distributed.run --standalone``
    with ``DP_RANKS`` processes on this machine (a rendezvous on a free
    localhost port); (JSON lines printed, host seconds). Raises on a
    failure or past ``timeout``, killing the job."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(DP_RANKS), *program]
    env = dict(os.environ, PYTHONPATH=REPO)
    log("data-parallel:cli", f"{time.strftime('%H:%M:%S')} torchrun {what}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        raise AssertionError(f"{what} under torchrun: still running after "
                             f"{timeout:.0f} s, killed:\n{out[-3000:]}")
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{what} under torchrun: rc "
                             f"{proc.returncode}:\n{out[-3000:]}")
    return ([json.loads(ln) for ln in out.splitlines()
             if ln.startswith("{")], seconds)


def _dp_cli(root: str) -> dict:
    """``cli.train`` under torchrun for 1 epoch, then one torchrun launch
    (``DP_RESUME_EVALUATE``) of ``cli.train``'s main resuming to a second
    and ``cli.evaluate``'s main; see ``phase_data_parallel``."""
    what = "data-parallel:cli"
    run = os.path.join(root, "run")
    base = ["--cfg", os.path.join(REPO, ENGINE_CFG), "--log_dir", run]
    first, s1 = _torchrun(
        "-m closerlook3d_tpu_torch.cli.train",
        ["-m", "closerlook3d_tpu_torch.cli.train", *base, *DP_CLI_OVERRIDES],
        DP_TIMEOUT)
    spe = 64 // (8 * DP_RANKS)
    if sorted((r["rank"], r["world_size"], r["resumed_step"], r["step"])
              for r in first) != [(r, DP_RANKS, None, spe)
                                  for r in range(DP_RANKS)]:
        raise AssertionError(f"{what}: first run {first}")
    argv = {"device": DEVICE,
            "train": base + DP_CLI_OVERRIDES + ["epochs=2"],
            "evaluate": ["--cfg", os.path.join(REPO, ENGINE_CFG),
                         "--log_dir", os.path.join(root, "eval"),
                         "--load_path", os.path.join(run, "ckpt")]
            + DP_CLI_OVERRIDES}
    lines, s2 = _torchrun(
        "cli.train's main (resume), then cli.evaluate's",
        ["--no-python", sys.executable, "-c", DP_RESUME_EVALUATE,
         json.dumps(argv)], DP_TIMEOUT)
    again = [r for r in lines if "rank" in r]
    results = [r for r in lines if "rank" not in r]
    if sorted((r["rank"], r["resumed_step"], r["step"]) for r in again) != [
            (r, spe, 2 * spe) for r in range(DP_RANKS)]:
        raise AssertionError(f"{what}: resumed run {again}")
    if len({r["best"] for r in again}) != 1:
        raise AssertionError(f"{what}: ranks disagree on the best value "
                             f"{again}")
    ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
    if ckpts != sorted([f"ckpt_{spe}.pt", f"ckpt_{2 * spe}.pt"]):
        raise AssertionError(f"{what}: checkpoints {ckpts}")
    with open(os.path.join(run, "scalars.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    keys = [(r["tag"], r["step"]) for r in rows]
    if len(keys) != len(set(keys)):
        raise AssertionError(f"{what}: duplicate scalar rows: two writers")
    val = {r["step"]: r["value"] for r in rows if r["tag"] == "val/acc"}
    if len(results) != 1:
        raise AssertionError(f"{what}: evaluate printed {results}")
    # the evaluator and the trainer's validation reduce the same shards
    if abs(results[0]["accuracy"] - val[2 * spe]) > 1e-9:
        raise AssertionError(f"{what}: evaluate accuracy {results[0]} "
                             f"against validation's {val}")
    with open(os.path.join(run, "log.txt")) as f:
        log_text = f.read()
    backend = re.search(r"(\d+) process\(es\) of \d+ clouds a step on "
                        r"(\S+) \((\w+)\)", log_text)
    return {"train_s": s1, "resume_evaluate_s": s2,
            "steps_per_epoch": spe, "val_acc": val,
            "evaluate": results[0], "checkpoints": ckpts,
            "layout": backend.groups() if backend else None}


def _dp_step_checks(wrappers) -> dict:
    """Part (a) of ``phase_data_parallel``: the ranks' steps against one
    process's."""
    from closerlook3d_tpu_torch.parallel.spawn import run_ranks

    phase = "data-parallel"
    cases, single = [], {}
    t_single = time.perf_counter()
    for kind in DP_KINDS:
        cfg = dp_config(kind)
        gcfg = copy.deepcopy(cfg)
        gcfg.batch_size = DP_RANKS * DP_BATCH
        batch = train_batch(gcfg, SEED + 800)
        batch["mask"][3, DP_POINTS * 6 // 10:] = False  # padded clouds
        batch["mask"][DP_BATCH + 1, DP_POINTS // 3:] = False
        batch = {k: batch[k] for k in ("xyz", "mask", "features", "label")}
        weights = seeded_weights(cfg, torch.Generator().manual_seed(SEED + 80))
        single[kind] = _dp_steps(cfg, weights, batch, wrappers, True,
                                 _dp_orders(DP_RANKS * DP_BATCH))
        cases.append((kind, cfg, weights, batch))
    torch.cuda.synchronize()
    t_spawn = time.perf_counter()
    ranks = run_ranks(_dp_rank, DP_RANKS, (cases,), device=DEVICE,
                      timeout=DP_TIMEOUT)
    spawn_s = time.perf_counter() - t_spawn
    out = {"ranks": DP_RANKS, "spawn_s": spawn_s,
           "single_s": t_spawn - t_single,
           "rank_seconds": [r["seconds"] for r in ranks]}
    bad = []
    for kind in DP_KINDS:
        per = [r[kind] for r in ranks]
        expected = single[kind]["bf16"]["launches"][0]
        if expected != launches_per(kind, "train"):
            raise AssertionError(f"{phase}:{kind}: one process launched "
                                 f"{expected}")
        checked = _dp_compare(
            kind, single[kind], per,
            {name: ranks[0]["controls"][name][kind] for name in DP_CONTROLS},
            expected)
        gaps = checked["gaps"]
        bad += checked["bad"]
        med = {name: float(np.median(run["bf16"]["step_ms"][DP_STEPS:]))
               for name, run in (("ranks", per[0]), ("single", single[kind]))}
        coll = per[0]["bf16"]["collectives"]
        coll_ms = float(np.median(per[0]["bf16"]["collective_ms"][DP_STEPS:]))
        out[kind] = {"gaps": gaps, "limits": checked["limits"],
                     "controls": checked["controls"],
                     "backend": per[0]["backend"],
                     "step_ms_ranks": [r["bf16"]["step_ms"] for r in per],
                     "step_ms_single": single[kind]["bf16"]["step_ms"],
                     "median_ms_rank0": med["ranks"],
                     "median_ms_single": med["single"],
                     "collectives_per_step": coll,
                     "collective_host_ms_median": coll_ms,
                     "launches_per_step": {k: v for k, v in expected.items()
                                           if v},
                     "losses_single": single[kind]["bf16"]["losses"],
                     "losses_ranks": per[0]["bf16"]["losses"]}
        log(f"{phase}:{kind}", f"{gpu_line()} | {DP_RANKS} ranks "
            f"({per[0]['backend']}, one card shared) x {DP_BATCH} clouds "
            f"against one process x {DP_RANKS * DP_BATCH}, {DP_POINTS} "
            f"points, width {cases[0][1].width}, depth {cases[0][1].depth}: "
            f"f32 step loss rel gap {gaps['f32_loss_rel']:.3g}, gradient "
            f"rel L2 max {gaps['f32_grad_rel_l2_max']:.3g} (one process "
            f"reordered: {gaps['reordered_f32_grad_rel_l2_max']:.3g}), "
            f"params rel L2 {gaps['f32_params_rel_l2']:.3g}; bf16 losses "
            + " ".join(f"{v:.5f}" for v in per[0]["bf16"]["losses"])
            + " against " + " ".join(f"{v:.5f}" for v in
                                     single[kind]["bf16"]["losses"])
            + f" (rel max {gaps['bf16_loss_rel_max']:.3g}; parameters rel "
            f"L2 {gaps['bf16_params_rel_l2']:.3g}, running statistics "
            f"{gaps['bf16_stats_rel_l2']:.3g}); parameters bit-equal "
            f"across ranks; launches a step per rank equal to one "
            f"process's ({sum(expected.values())}); bf16 step median by "
            f"CUDA events over {DP_TIMED}: rank 0 {med['ranks']:.3f} ms, "
            f"one process {med['single']:.3f} ms (ranks share one card, "
            f"the CLI's launches beside: no measure of scaling); "
            f"{coll[-1]} collectives a step, host {coll_ms:.3f} ms a step")
    log(phase, f"one process {out['single_s']:.1f} s; the ranks spawned "
        f"and stepped in {spawn_s:.1f} s (rank 0: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in ranks[0]["seconds"].items()) + ")")
    if bad:  # every config's and control's gaps are logged above
        raise AssertionError("; ".join(bad))
    return out


def phase_data_parallel(wrappers) -> dict:
    """Data parallelism on the card, ``DP_RANKS`` ranks sharing it (gloo:
    NCCL takes one card a rank; with a card a rank the layout picks
    NCCL).

    (a) The step: for the flagship ModelNet40 config and the point-wise
    MLP one (``dp_config``: full width and depth, 1024 points, 16 clouds
    a rank), the ranks (``parallel/spawn.py``) and this process, on the
    whole 32-cloud batch, from the same seeded weights: one f32 step with
    dropout off (loss, every gradient, parameters and running statistics
    within ``DP_F32_FLOOR`` or twice the gaps of one process on the
    clouds reordered), then ``DP_STEPS`` bf16 steps with dropout
    on and equal seeds (within ``DP_BF16_LIMIT``), each
    rank's launches equal to the one process's a step (the point-wise
    MLP's route is the global batch's), parameters bit-equal across the
    ranks after every step; then ``DP_TIMED`` bf16 steps timed by CUDA
    events on each side, and the collectives a step with their host time.
    Then the controls: the ranks' f32 and bf16 steps again under each
    broken sync of ``DP_CONTROLS``, whose gaps must pass the limits
    (but those ``DP_CONTROL_BLIND`` and ``DP_UNSEPARATED`` name).

    (b) The CLI: ``cli.train`` under torchrun for 1 epoch, then one
    torchrun launch that resumes it with ``cli.train``'s main and runs
    ``cli.evaluate``'s (``_dp_cli``), in a thread beside (a): its
    launches are mostly process start-up, and (a)'s step times are read
    with them running beside."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    root = os.path.join(REPO, f"_dp_{os.getpid()}")
    os.makedirs(root, exist_ok=True)
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            # the CLI's launches, mostly process start-up, run beside (a)
            cli_future = pool.submit(_dp_cli, root)
            out = _dp_step_checks(wrappers)
            out["cli"] = cli_future.result()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cli = out["cli"]
    out["seconds"] = time.perf_counter() - t0
    log("data-parallel:cli", f"torchrun x {DP_RANKS} ({cli['layout']}): "
        f"cli.train "
        f"1 epoch ({cli['steps_per_epoch']} steps) {cli['train_s']:.1f} s, "
        f"resumed by both ranks at step {cli['steps_per_epoch']} to "
        f"{2 * cli['steps_per_epoch']}, "
        f"checkpoints {cli['checkpoints']} by one writer, then cli.evaluate "
        f"accuracy {cli['evaluate']['accuracy']:.4f} equal to the "
        f"validation's, in {cli['resume_evaluate_s']:.1f} s; phase "
        f"{out['seconds']:.1f} s, the CLI beside the ranks (spawned and "
        f"stepped in {out['spawn_s']:.1f} s)")
    return out


# ---- the entry hooks ------------------------------------------------------

def phase_hooks(wrappers) -> dict:
    """The entry hooks of ``__graft_entry_torch__`` on the card:
    ``entry()``'s forward, weights passed as an argument, launches exactly
    the flagship request's kernels and gives ``Predictor``'s logits on the
    same weights and batch, to the bit; ``dryrun_multichip(DP_RANKS)``
    trains one step of the tiny flagship in ranks sharing the card and
    prints its line."""
    import __graft_entry_torch__ as hooks
    from closerlook3d_tpu_torch.serving import Predictor

    phase = "hooks"
    t0 = time.perf_counter()
    forward, args = hooks.entry()
    weights, xyz, mask, features = args
    reset_counts(wrappers)
    out = forward(*args)
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    check_counts(f"{phase}: entry() forward", launches,
                 launches_per("xyz", "forward"))
    cfg = hooks._flagship_cfg()
    ref = Predictor(cfg, weights, device=DEVICE)(xyz, mask, features)
    if tuple(out.shape) != (cfg.batch_size, cfg.num_classes) or not (
            torch.isfinite(out).all() and torch.equal(out, ref)):
        raise AssertionError(
            f"{phase}: entry() logits {tuple(out.shape)} differ from "
            f"Predictor's by {float((out - ref).abs().max())!r}")
    entry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = hooks.dryrun_multichip(DP_RANKS)
    dryrun_s = time.perf_counter() - t0
    log(phase, f"entry(): logits {tuple(out.shape)} equal to Predictor's "
        f"to the bit, launches {({k: v for k, v in launches.items() if v})} "
        f"({entry_s:.2f} s); dryrun_multichip({DP_RANKS}) loss "
        f"{ranks[0]['loss']:.4f}, parameters equal across the ranks "
        f"({dryrun_s:.2f} s)")
    return {"entry_launches": launches, "entry_s": entry_s,
            "dryrun": {"loss": ranks[0]["loss"], "acc": ranks[0]["acc"],
                       "step": ranks[0]["step"], "ranks": len(ranks),
                       "seconds": dryrun_s}}


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
    # K8f and K7f (gather_sub_minmax): query groups (csrc/query_groups.cuh)
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
    # K5b and K9b: the reverse index, then a gather per support row that
    # recomputes each slot's term (csrc/row_terms.cuh)
    "pospool_sincos_bwd": ("closerlook3d_tpu_torch/csrc/pospool_sincos.cu",
                           "closerlook3d_tpu/ops/pallas/aggregation.py:507",
                           None),
    "moments": ("closerlook3d_tpu_torch/csrc/moments.cu",
                "closerlook3d_tpu/ops/pallas/moments.py:48", None),
    "moments_bwd": ("closerlook3d_tpu_torch/csrc/moments.cu",
                    "closerlook3d_tpu/ops/pallas/moments.py:96", None),
    "pwmlp_stats": ("closerlook3d_tpu_torch/csrc/gather_reduce.cu",
                    "closerlook3d_tpu/ops/pallas/gather_reduce.py:902", None),
    "pwmlp_stats_bwd": ("closerlook3d_tpu_torch/csrc/gather_reduce.cu",
                        "closerlook3d_tpu/ops/pallas/gather_reduce.py:978",
                        None),
    "gather_sub_minmax": ("closerlook3d_tpu_torch/csrc/gather_reduce.cu",
                          "closerlook3d_tpu/ops/pallas/gather_reduce.py:294",
                          None),
    "gather_sub_minmax_bwd": (
        "closerlook3d_tpu_torch/csrc/gather_reduce.cu",
        "closerlook3d_tpu/ops/pallas/gather_reduce.py:353", None),
    "neighborhood_sum": ("closerlook3d_tpu_torch/csrc/gather_reduce.cu",
                         "closerlook3d_tpu/ops/pallas/gather_reduce.py:145",
                         None),
    "neighborhood_sum_bwd": (
        "closerlook3d_tpu_torch/csrc/gather_reduce.cu",
        "closerlook3d_tpu/ops/pallas/gather_reduce.py:174", None),
    "pseudo_grid": ("closerlook3d_tpu_torch/csrc/pseudo_grid.cu",
                    "closerlook3d_tpu/ops/pallas/pseudo_grid.py:112", None),
    "pseudo_grid_bwd": ("closerlook3d_tpu_torch/csrc/pseudo_grid.cu",
                        "closerlook3d_tpu/ops/pallas/pseudo_grid.py:185",
                        None),
    # one kernel for the JAX package's k-NN (K12) and chunked 1-NN (K11)
    "knn": ("closerlook3d_tpu_torch/csrc/knn.cu",
            "closerlook3d_tpu/ops/pallas/neighbors.py:598",
            "closerlook3d_tpu/ops/pallas/neighbors.py:498"),
}


def home_kind(kernel: str) -> str:
    """The run that gives a kernel's launches and times: the segmentation
    serving runs for the k-NN, ``phase_k13_timing`` for K13 (which only
    the segmentation point-wise MLP's train step reaches), else the
    training config whose aggregation it is, else the xyz config."""
    if kernel == "knn":
        return "seg"
    if kernel in NSUM_KERNELS:
        return "nsum"
    return next((k for k in AGG_KERNELS
                 if kernel in agg_kernels(k, "train")
                 + agg_kernels(k, "eval_grad")), "xyz")


def knn_row(record) -> dict:
    """The kernels line's k-NN row: launches on both segmentation configs'
    checked requests (both routes) and on the S3DIS voting run (its
    sphere forwards and one projection a room), times per S3DIS request
    (whose four calls take both routes), ShapeNetPart's and the
    projection's beside them."""
    seg, voting = record["seg"], record["s3dis_voting"]
    launches = {route: sum(run["serving"]["launches"][route]
                           for run in seg.values())
                + voting["launches"][route] for route in ("knn1", "knn")}
    t = seg["s3dis"]["timing"]
    return {"launches": launches["knn1"] + launches["knn"],
            "max_abs_err": max(run["parity"]["knn"] for run in seg.values()),
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "all_pairs_ms": t["all_pairs_ms"],
            "bound_note": "bytes once; all_pairs_ms: 9 f32 operations per "
                          "(query, valid support) pair, a scan that prunes "
                          "nothing",
            # two calls, cdist then topk, plus the square and the bias
            "library_ms": t["library_ms"],
            "config": "s3dis (per request)",
            "launches_by_route": {"knn1 (K11 route)": launches["knn1"],
                                  "knn (K12 route)": launches["knn"]},
            "launches_per_request": {
                name: {r: run["serving"]["launches_per_request"][r]
                       for r in ("knn1", "knn")}
                for name, run in seg.items()},
            # the S3DIS voting run: its sphere forwards' upsample calls and
            # one projection to the full cloud a room
            "voting_launches": {r: voting["launches"][r]
                                for r in ("knn1", "knn")},
            "projection_per_room": [
                {k: room[k] for k in (
                    "full_points", "sub_points", "kept", "device_ms_stored",
                    "device_ms_morton", "device_ms_with_sort", "ms_stored",
                    "ms_morton", "wall_ms_stored", "wall_ms_morton",
                    "bound_ms", "bound_by", "all_pairs_ms")}
                for room in voting["rooms"]],
            "shapenetpart_per_request": {
                k: seg["shapenetpart"]["timing"][k]
                for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                          "all_pairs_ms", "library_ms")}}


def nsum_row(record, name: str) -> dict:
    """The kernels line's row of K13 forward (``neighborhood_sum``) or
    backward: times from ``phase_k13_timing``, launches and errors from
    the config runs (``with_config_runs``)."""
    run = record["configs"][SEG_TRAIN_FILES["shapenetpart_pwmlp"]]
    t = record["k13_timing"][name]
    return {"launches": 0, "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            # ms and library_ms: CUDA events over eager launches, as every
            # row; device_ms and library_device_ms: the profiler's device
            # time, read in turns; launch_floor_ms: an empty kernel's
            "stream_ms": t["stream_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "launch_floor_ms": t["launch_floor_ms"],
            "library_note": "one torch.bmm of the [B, Nq, Ns] multi-hot "
                            "count matrix (its transpose backward), the "
                            "TPU kernel's formulation; building the "
                            "matrix is left out of the time",
            "config": "config:shapenetpart/pointwisemlp_dp_fi_df_fc1_max "
                      "(per step)",
            "launches_per_step": run["launches_per_step"][name]}


def bq_row(record) -> dict:
    """The ball query's keys beyond every row's: device time per step of
    the ModelNet40 xyz config (whose events times, bound and launches the
    row carries), of S3DIS and per flagship request, from
    ``phase_bq_timing``, beside ``all_pairs_ms``, the bound of a scan that
    prunes nothing."""
    t = record["bq_timing"]
    keys = ("device_ms", "stream_ms", "bound_ms", "bound_by", "all_pairs_ms")
    return {"device_ms": t["xyz"]["device_ms"],
            "all_pairs_ms": t["xyz"]["all_pairs_ms"],
            "s3dis_per_step": {k: t["s3dis"][k] for k in keys},
            "flagship_per_request": {k: t["flagship"][k] for k in keys},
            "bound_note": "bytes once, or 8 f32 operations per in-radius "
                          "(query, valid support) pair; all_pairs_ms: 8 "
                          "per (valid query, valid support) pair"}


def with_config_runs(row, record) -> dict:
    """The row with the launches of the config runs' main paths (bf16
    steps, eval step, ``PARTNET_FULL``'s requests) added to its count and
    kept beside it, by config, and its max abs err over the config runs'
    parity checks too."""
    name = row["name"]
    keys = ("knn1", "knn") if name == "knn" else (name,)
    runs = record["configs"]
    by_config = {c: sum(run["launches"][k] for k in keys)
                 for c, run in runs.items()}
    row["launches"] += sum(by_config.values())
    row["config_runs_launches"] = by_config
    row["max_abs_err"] = max([row["max_abs_err"]]
                             + [run["parity"][name] for run in runs.values()
                                if name in run["parity"]])
    return row


def main() -> int:
    t_start = time.perf_counter()
    record = {"device": phase_device()}
    seconds = record["phase_seconds"] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    record["build"] = timed("build", phase_build)
    wrappers = kernel_wrappers()
    record["k13_timing"] = timed("k13_timing", phase_k13_timing)
    record["bq_timing"] = timed("bq_timing", phase_bq_timing)
    record["device_timing"] = timed("device_timing", phase_device_timing)

    t0 = time.perf_counter()
    cfg = flagship_config()
    record["parity"] = phase_kernel_parity(cfg)
    weights = seeded_weights(cfg, torch.Generator().manual_seed(SEED))
    serving = phase_serving(cfg, weights, wrappers)
    record["serving_launches"] = serving["launches"]
    record["forward_parity"] = phase_forward_parity(
        cfg, weights, serving["batches"][1])
    record["timing"] = phase_timing(cfg, serving)
    seconds["serving"] = time.perf_counter() - t0

    record["train"] = {}
    for kind in TRAIN_KINDS:
        t0 = time.perf_counter()
        tcfg = train_config(kind)
        run = {"parity": phase_train_kernel_parity(tcfg, kind),
               "step_parity": phase_train_step_parity(tcfg, wrappers, kind)}
        # where the eval-mode forward runs kernels of its own, their
        # backward runs in the gradient of an eval-mode forward
        own_eval = set(agg_kernels(kind, "forward")) - set(
            agg_kernels(kind, "train"))
        if own_eval:
            run["eval_grad"] = phase_eval_grad_parity(tcfg, wrappers, kind)
        training = phase_training(tcfg, wrappers, kind)
        run["training"] = {k: v for k, v in training.items()
                           if k not in ("state", "step", "batch",
                                        "predictor")}
        run["timing"] = phase_train_timing(tcfg, training, kind,
                                           record["device_timing"][kind])
        # launches on the config's main-path runs: the bf16 train steps,
        # the eval step, the checked Predictor request and, where it ran,
        # the eval-mode gradient
        runs = [training["launches"], training["eval_launches"],
                training["request_launches"]]
        if "eval_grad" in run:
            runs.append(run["eval_grad"]["launches"])
        run["launches"] = {k: sum(r[k] for r in runs) for k in wrappers}
        record["train"][kind] = run
        del training
        seconds[f"train:{kind}"] = time.perf_counter() - t0
    record["seg"] = {name: timed(f"seg:{name}", run_segmentation, name,
                                 wrappers,
                                 record["device_timing"][f"knn:{name}"])
                     for name in SEG_NAMES}
    record["configs"] = {name: timed(f"config:{name}", run_config, name,
                                     wrappers)
                         for name in CONFIG_RUNS}
    record["device_sort"] = timed("device_sort", phase_device_sort, wrappers)
    record["native"] = timed("native", phase_native)
    record["s3dis_voting"] = timed("s3dis_voting", phase_s3dis_voting,
                                   wrappers)
    record["engine"] = timed("engine", phase_engine, wrappers)
    record["export"] = timed("export", phase_export, wrappers)
    record["data_parallel"] = timed("data_parallel", phase_data_parallel,
                                    wrappers)
    record["hooks"] = timed("hooks", phase_hooks, wrappers)
    record["seconds"] = time.perf_counter() - t_start

    kernels_line = {"kernels": []}
    for name, (src, rep, also) in REPLACES.items():
        kind = home_kind(name)
        if kind == "seg":
            row = {"name": name, "route": "cuda", "source": src,
                   "replaces": rep, "also_replaces": also, **knn_row(record)}
        elif kind == "nsum":
            row = {"name": name, "route": "cuda", "source": src,
                   "replaces": rep, **nsum_row(record, name)}
        if kind in ("seg", "nsum"):
            kernels_line["kernels"].append(with_config_runs(row, record))
            continue
        run = record["train"][kind]
        t = run["timing"]["per_kernel"][name]
        # measured against the plain versions at every shape the kernel
        # was checked at (the flagship's and the training config's)
        err = max(e for e in (record["parity"].get(name),
                              run["parity"][name]) if e is not None)
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               # the config's main-path runs, counted from 0 before each
               # step or request
               "launches": run["launches"][name],
               "max_abs_err": err,
               "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               # no single PyTorch call computes these masked, padded
               # neighborhood functions
               "library_ms": None,
               # ms: CUDA events over eager launches (the host's launch
               # path in); device_ms: the profiler's device time, per step
               "device_ms": t["device_ms"],
               "device_ops_per_call": t["device_ops_per_call"],
               "config": kind,
               "launches_per_step": launches_per(kind, "train")[name],
               "launches_per_forward": launches_per(kind, "forward")[name],
               "serving_launches": serving["launches"][name]}
        if also:
            row["also_replaces"] = also
        if name == "ball_query":
            row.update(bq_row(record))
        kernels_line["kernels"].append(with_config_runs(row, record))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    log("done", f"all phases passed in {record['seconds']:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(gpu_line(), flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
