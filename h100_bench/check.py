"""The comparison that decides ``correct``: the numbers compared with the
plain reference, and each against its limit (``limits/<workload>.json``).

Training (the first steps of set-up, through the window's own call and
feed; the reference follows them from the same weights and batches):

  * ``loss_gap``: the largest |loss - reference loss| / |reference loss|
    over the steps;
  * per leaf, the gap between the norm of the program's first gradient
    (worked out from the optimizer's momentum after one step: momentum -
    weight decay x the initial weight, for decayed leaves) and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's: ``grad_gap`` the worst leaf's, ``grad_gap_median``
    the median leaf's;
  * the same for the parameters' change after the steps,
    ``change_gap`` and ``change_gap_median``, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's
    (leaves whose gradient is nought to rounding move by round-off
    alone).

A cell's limits file names the numbers it compares; the worst leaf's are
printed beside them. On the card the worst leaf is a small BatchNorm
leaf: its gradient a cancelling sum over every point that bf16 rounding
dominates, its change a float32 step or two of a weight near 1, so the
median leaf's are compared (PERF.md gives both readings).

Serving: ``logits_gap``, over the sampled requests and their clouds, the
largest ||logits - reference logits|| / ||reference logits|| of one
cloud.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               names: Sequence[str]) -> Dict[str, float]:
    floor = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
            for n in names}


def train_numbers(init: Tensors, bufs1: Tensors, params: Tensors,
                  losses: Sequence[float], ref: dict, weight_decay: float,
                  look: dict = None) -> Dict[str, float]:
    """``init``: the weights both sides started from; ``bufs1``: the
    program's momentum after its first step (a missing leaf never moved);
    ``params``: its parameters after the last checked step; ``losses``:
    its losses; ``ref``: ``reference.model.train_steps``'s result. A dict
    passed as ``look`` receives the per-leaf readings."""
    names = list(ref["first_grads"])
    g_ref = {n: _norm(ref["first_grads"][n]) for n in names}
    g_prog = {}
    for n in names:
        buf = bufs1.get(n)
        if buf is None:
            g_prog[n] = 0.0
            continue
        g = buf.float() - weight_decay * init[n] if buf.ndim >= 2 else buf
        g_prog[n] = _norm(g)
    floor = statistics.median(g_ref.values())
    moving = [n for n in names if g_ref[n] >= 1e-3 * floor]
    d_ref = {n: _norm(ref["params"][n] - init[n]) for n in moving}
    d_prog = {n: _norm(params[n].float() - init[n]) for n in moving}
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(losses,
                                                       ref["losses"]))
    grad = _leaf_gaps(g_prog, g_ref, names)
    change = _leaf_gaps(d_prog, d_ref, moving)
    if look is not None:
        look.update({"losses": list(losses), "ref_losses": ref["losses"],
                     "grad": {n: (grad[n], g_prog[n], g_ref[n])
                              for n in names},
                     "change": {n: (change[n], d_prog[n], d_ref[n],
                                    _norm(init[n]) / init[n].numel() ** 0.5,
                                    init[n].numel()) for n in moving}})
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap_median": statistics.median(change.values())}


def serve_numbers(prog: Sequence[torch.Tensor],
                  ref: Sequence[torch.Tensor]) -> Dict[str, float]:
    worst = 0.0
    for p, r in zip(prog, ref):
        diff = torch.linalg.vector_norm((p.float() - r.float()).flatten(1),
                                        dim=1)
        scale = torch.linalg.vector_norm(r.float().flatten(1), dim=1)
        worst = max(worst, float((diff / scale).max()))
    return {"logits_gap": worst}


def judge(numbers: Dict[str, float], limits: dict
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(every number within its limit, [(name, number, limit)]). A
    number that is not finite fails."""
    rows = [(name, float(numbers[name]), float(limits[name]["limit"]))
            for name in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
