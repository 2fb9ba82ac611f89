"""Weights from the seed, made on the device in one draw, in float32 (the
type the program keeps its parameters in).

Flax's default initialisation, which the configuration's framework
uses: every 2-D weight lecun-normal (std 1 / sqrt(fan_in)), every bias
0, BatchNorm scales 1 and offsets 0, running means 0 and variances 1.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .traffic import generator


def make(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for (name, shape) pairs as a ``state_dict`` names
    them."""
    mats = [(n, s) for n, s in shapes if len(s) == 2]
    flat = torch.randn((sum(a * b for _, (a, b) in mats),),
                       generator=generator(seed, device), device=device)
    out, at = {}, 0
    for n, (rows, fan_in) in mats:
        size = rows * fan_in
        out[n] = (flat[at:at + size].view(rows, fan_in)
                  / fan_in ** 0.5).contiguous()
        at += size
    for n, s in shapes:
        if len(s) == 2:
            continue
        if len(s) != 1:
            raise ValueError(f"{n}: no initialisation for shape {s}")
        ones = n.endswith("running_var") or (n.endswith(".weight"))
        out[n] = (torch.ones if ones else torch.zeros)(
            s, dtype=torch.float32, device=device)
    return out
