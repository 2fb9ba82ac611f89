"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes that one forward or train step of the configuration needs, from
its shapes and the batch's own neighbourhoods.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
A least time is the larger of the bytes read and written once over the
HBM rate and the operations over the peak of the precision they are
computed in. Counts follow the work a layer needs, not the kernels that
do it:

  * a dense matmul: 2 rows in out operations forward; a train step adds
    the weight's gradient and, where the input carries a gradient, the
    input's (the stem's raw points carry none);
  * an aggregation call, per valid neighbour slot: PosPool xyz 6 + 2C
    operations forward and as many backward (the offset's 3 subtractions
    and 3 divisions, a multiply-add a channel); the point-wise MLP's
    neighbourhood reduction 4 a channel in training (a max, a min and
    two sums for the BatchNorm statistics), 8 backward, 3 in eval (a
    subtraction and two compares); the strided shortcut's max 1 a channel
    forward and 2 backward. The point-wise MLP's FC is counted as its
    exact factorization, per-point projections: the least work for the
    same function;
  * the ball query: 8 operations per in-radius pair (all pairs within the
    radius, not only those kept); FPS: 9 per (pick, valid point); the
    1-NN: its bytes.
"""

from __future__ import annotations

from typing import List

import torch

from .reference import geometry

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12,
              "fp16": 989e12, "fp8": 1979e12}
IDX_MASK_BYTES = 5  # an int32 index and a bool mask a slot
XYZ_BYTES = 12


def least_s(nbytes: float, flops: float, precision: str = "f32") -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[precision])


@torch.no_grad()
def census(cfg: dict, batch: dict) -> dict:
    """What the counts need of one batch: points per stage, valid slots
    per neighbour list, in-radius pairs per ball query (call order),
    valid points per cloud per stage (FPS)."""
    xyz = torch.as_tensor(batch["xyz"])
    mask = torch.as_tensor(batch["mask"])
    dev = torch.device("cuda") if torch.cuda.is_available() else xyz.device
    geo = geometry.compute(cfg, xyz.to(dev), mask.to(dev), count_pairs=True)
    nst = len(cfg["nsamples"])
    out = {"pairs": list(geo["pairs"]),
           "points": [int(geo[f"mask_{s}"].numel()) for s in range(nst)],
           "valid_per_cloud": [geo[f"mask_{s}"].sum(1).tolist()
                               for s in range(nst)],
           "slots": {}}
    for key in ["0"] + [f"{p}{s}" for s in range(1, nst) for p in ("s", "")]:
        nm = geo[f"nmask_{key}"]
        out["slots"][key] = (int(nm.sum()), int(nm.shape[-1]))
    return out


def _dt(cfg: dict) -> int:
    return 2 if cfg["precision"] == "bf16" else 4


def _agg_calls(cfg: dict, c: dict) -> List[dict]:
    """One forward's aggregation and strided-max calls: kind, neighbour
    list, query and support rows, channels, valid slots, K."""
    plan = geometry.stage_plan(cfg)
    w, ratio = plan["widths"], cfg["bottleneck_ratio"]
    n = c["points"]
    calls = []

    def add(kind, key, nq, ns, ch):
        slots, k = c["slots"][key]
        calls.append({"kind": kind, "key": key, "nq": nq, "ns": ns,
                      "c": ch, "slots": slots, "k": k})

    agg = cfg["local_aggregation_type"]
    add(agg, "0", n[0], n[0], w[0] // 2)
    add(agg, "0", n[0], n[0], w[0] // ratio)
    for s in range(1, len(w)):
        add(agg, f"s{s}", n[s], n[s - 1], w[s] // ratio)
        add("max", f"s{s}", n[s], n[s - 1], w[s - 1])
        for _ in range(cfg["depth"]):
            add(agg, f"{s}", n[s], n[s], w[s] // ratio)
    return calls


def _matmuls(cfg: dict, c: dict) -> List[tuple]:
    """(rows, in, out, input carries a gradient) of every matmul of one
    forward."""
    plan = geometry.stage_plan(cfg)
    w, ratio, n = plan["widths"], cfg["bottleneck_ratio"], c["points"]
    if cfg["input_features"] != "xyz":
        raise ValueError("counts the xyz input features only")
    mm = [(n[0], 3, w[0] // 2, False)]

    def block(nq, ns, cin, cout):
        mid = cout // ratio
        mm.extend([(ns, cin, mid, True), (nq, mid, cout, True)])
        if cin != cout:
            mm.append((nq, cin, cout, True))

    block(n[0], n[0], w[0] // 2, w[0])
    for s in range(1, len(w)):
        block(n[s], n[s - 1], w[s - 1], w[s])
        for _ in range(cfg["depth"]):
            block(n[s], n[s], w[s], w[s])
    if cfg["local_aggregation_type"] == "pointwisemlp":
        for call in _agg_calls(cfg, c):
            if call["kind"] != "max":
                ch = call["c"]
                # G: [dp | f | f] -> ch on supports; D: [dp | f_0] on queries
                mm.extend([(call["ns"], 3, ch, False),
                           (call["ns"], 2 * ch, ch, True),
                           (call["nq"], 3, ch, False),
                           (call["nq"], ch, ch, True)])
    width = w[-1]
    for s in range(len(w) - 2, -1, -1):
        mm.append((n[s], width + w[s], w[s], True))
        width = w[s]
    mm.append((n[0], w[0], w[0], True))
    mm.append((n[0], w[0], sum(cfg["num_parts"]), True))
    return mm


_SLOT_OPS = {  # per valid slot and channel: (forward, backward)
    "pointwisemlp": (4, 8), "max": (1, 2)}
_EVAL_SLOT_OPS = {"pointwisemlp": 3, "max": 1}


def _slot_ops(call: dict, train: bool, backward: bool) -> float:
    if call["kind"] == "pospool":
        return call["slots"] * (6 + 2 * call["c"])
    if not train:
        return call["slots"] * call["c"] * _EVAL_SLOT_OPS[call["kind"]]
    return call["slots"] * call["c"] * _SLOT_OPS[call["kind"]][int(backward)]


def model_flops(cfg: dict, c: dict, train: bool) -> float:
    """Operations of one train step (forward and backward) or one eval
    forward: dense matmuls and the aggregation layer's per-slot work."""
    total = 0.0
    for rows, cin, cout, grad in _matmuls(cfg, c):
        fwd = 2.0 * rows * cin * cout
        total += fwd * ((3 if grad else 2) if train else 1)
    for call in _agg_calls(cfg, c):
        total += _slot_ops(call, train, False)
        if train:
            total += _slot_ops(call, train, True)
    return total


def _agg_bytes(call: dict, dt: int, train: bool, backward: bool) -> float:
    nq, ns, ch, k = call["nq"], call["ns"], call["c"], call["k"]
    slots = nq * k * IDX_MASK_BYTES
    kind = call["kind"]
    if kind == "pospool":
        return ns * ch * dt + nq * ch * dt + slots + (nq + ns) * XYZ_BYTES
    if kind == "max":
        if backward:  # features, output and its cotangent in; dfeatures out
            return 2 * ns * ch * dt + 2 * nq * ch * dt + slots
        return ns * ch * dt + nq * ch * dt + slots
    if not train:  # G and D in; f32 max and min out
        return ns * ch * dt + nq * ch * dt + slots + 2 * nq * ch * 4
    if backward:  # G, four f32 cotangents, f32 max and min in; dG, dG^2 out
        return 3 * ns * ch * dt + 6 * nq * ch * 4 + slots
    return 2 * ns * ch * dt + 4 * nq * ch * 4 + slots  # G, G^2 in; 4 f32 out


def aggregation_least_s(cfg: dict, c: dict, train: bool) -> float:
    """Least seconds of one step's (or forward's) aggregation calls, each
    call bounded alone, summed."""
    dt, total = _dt(cfg), 0.0
    for call in _agg_calls(cfg, c):
        for bwd in ((False, True) if train else (False,)):
            total += least_s(_agg_bytes(call, dt, train, bwd),
                             _slot_ops(call, train, bwd))
    return total


def geometry_least_s(cfg: dict, c: dict) -> float:
    """Least seconds of one forward's ball queries, FPS and 1-NN."""
    plan = geometry.stage_plan(cfg)
    n, total = c["points"], 0.0
    keys = ["0"] + [f"{p}{s}" for s in range(1, len(n)) for p in ("s", "")]
    for key, pairs in zip(keys, c["pairs"]):
        s = int(key.lstrip("s"))
        nq = n[s]
        ns = n[s - 1] if key.startswith("s") else n[s]
        k = c["slots"][key][1]
        total += least_s((nq + ns) * (XYZ_BYTES + 1) + nq * k * IDX_MASK_BYTES,
                         8.0 * pairs)
    for s in range(1, len(n)):
        pick = plan["npoints"][s]
        ops = 9.0 * pick * sum(c["valid_per_cloud"][s - 1])
        total += least_s(n[s - 1] * (XYZ_BYTES + 1) + n[s] * 5, ops)
        # the 1-NN from stage s - 1 onto stage s
        total += least_s((n[s - 1] + n[s]) * XYZ_BYTES + n[s] + n[s - 1] * 8,
                         0.0)
    return total
