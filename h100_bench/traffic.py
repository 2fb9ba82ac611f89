"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a seed give a pool of batches, made on the device in a few large
calls.

Clouds are surface samples of eight parametric shapes (sphere, cube,
cylinder, cone, torus, pyramid, capsule, helix: the families of the
port's synthetic datasets, rewritten here to draw on the device), with
Gaussian noise, centred and scaled into the unit sphere as PartNet's
files are, then augmented as the mix says (rotation about z, a scale per
axis, clipped jitter). Each cloud's category is uniform over the
configuration's categories; its labels are height bands over its
category's parts. Each cloud is then Morton-sorted, as the port's loader
sorts a batch when ``spatial_sort`` is "host". The same seed gives the
same pool on one device.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

SHAPES = ("sphere", "cube", "cylinder", "cone", "torus", "pyramid",
          "capsule", "helix")
MORTON_BITS = 10


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def _unit(v):
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-9)


def _shapes(g, c: int, n: int, device) -> Dict[str, torch.Tensor]:
    """Every family's [c, n, 3] sample from one set of draws."""
    def u(lo=0.0, hi=1.0, *shape):
        return lo + (hi - lo) * torch.rand((c, n, *shape), generator=g,
                                           device=device)

    two_pi = 2 * math.pi
    out = {"sphere": _unit(torch.randn((c, n, 3), generator=g,
                                       device=device))}
    face = torch.randint(0, 6, (c, n), generator=g, device=device)
    uv = u(-1.0, 1.0, 2)
    axis, sign = face // 2, (face % 2).float() * 2 - 1
    cube = torch.empty((c, n, 3), device=device)
    for a, (o1, o2) in enumerate(((1, 2), (0, 2), (0, 1))):
        on = axis == a
        cube[..., a] = torch.where(on, sign, cube[..., a])
        cube[..., o1] = torch.where(on, uv[..., 0], cube[..., o1])
        cube[..., o2] = torch.where(on, uv[..., 1], cube[..., o2])
    out["cube"] = cube
    a = u(0.0, two_pi)
    out["cylinder"] = torch.stack([a.cos(), a.sin(), u(-1.0, 1.0)], -1)
    t, a = u().sqrt(), u(0.0, two_pi)
    cone = torch.stack([t * a.cos(), t * a.sin(), 1 - 2 * t], -1)
    out["cone"] = cone
    uu, vv = u(0.0, two_pi), u(0.0, two_pi)
    ring = 0.7 + 0.3 * vv.cos()
    out["torus"] = torch.stack([ring * uu.cos(), ring * uu.sin(),
                                0.3 * vv.sin()], -1)
    ang = torch.atan2(cone[..., 1], cone[..., 0])
    k = torch.round(ang / (math.pi / 2)) * (math.pi / 2)
    r = torch.hypot(cone[..., 0], cone[..., 1]) / torch.clamp(
        torch.cos(ang - k), min=0.5)
    out["pyramid"] = torch.stack([r * ang.cos(), r * ang.sin(),
                                  cone[..., 2]], -1)
    cap = out["sphere"].clone()
    cap[..., 2] += torch.sign(cap[..., 2]) * 0.8
    out["capsule"] = cap
    t = u(0.0, 4 * math.pi)
    jit = _unit(torch.randn((c, n, 3), generator=g, device=device))
    out["helix"] = torch.stack([0.8 * t.cos(), 0.8 * t.sin(),
                                t / two_pi - 1], -1) + 0.08 * jit
    return out


def _rotation_z(g, c: int, device) -> torch.Tensor:
    a = torch.rand((c,), generator=g, device=device) * 2 * math.pi
    cs, sn = a.cos(), a.sin()
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([cs, -sn, z], -1),
                        torch.stack([sn, cs, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _spread(x: torch.Tensor) -> torch.Tensor:
    """Low 10 bits of int32 x spread three apart (Morton interleave)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_order(xyz: torch.Tensor) -> torch.Tensor:
    """[C, N] int64 permutation sorting each cloud along the Z-order curve
    of its bounding box quantized to 10 bits an axis (stable)."""
    mins = xyz.amin(dim=1, keepdim=True)
    ext = (xyz.amax(dim=1, keepdim=True) - mins).amax(
        dim=-1, keepdim=True).clamp_min(1e-9)
    cells = ((xyz - mins) * (torch.full_like(ext, 2 ** MORTON_BITS - 1)
                             / ext)).clamp(0, 2 ** MORTON_BITS - 1).to(
                                 torch.int32)
    keys = (_spread(cells[..., 0]) | (_spread(cells[..., 1]) << 1)
            | (_spread(cells[..., 2]) << 2))
    return torch.argsort(keys, dim=-1, stable=True)


def clouds(mix: dict, num_parts: List[int], seed: int, device) -> dict:
    """Every cloud of the pool at once: xyz [C, N, 3] f32, labels [C, N]
    int32, category [C] int32, C = pool x clouds."""
    g = generator(seed, device)
    c, n = mix["pool"] * mix["clouds"], mix["points"]
    fams = _shapes(g, c, n, device)
    pick = torch.randint(0, len(SHAPES), (c,), generator=g, device=device)
    xyz = torch.zeros((c, n, 3), device=device)
    for i, name in enumerate(SHAPES):
        xyz = torch.where((pick == i)[:, None, None], fams[name], xyz)
    del fams
    xyz = xyz + mix["shape_noise"] * torch.randn(xyz.shape, generator=g,
                                                 device=device)
    xyz = xyz - xyz.mean(dim=1, keepdim=True)
    xyz = xyz / torch.linalg.norm(xyz, dim=-1).amax(dim=1)[:, None, None]
    if mix["rotation"] == "z":
        xyz = xyz @ _rotation_z(g, c, device).transpose(1, 2)
    elif mix["rotation"] != "none":
        raise ValueError(f"unknown rotation {mix['rotation']!r}")
    lo, hi = mix["scale"]
    xyz = xyz * (lo + (hi - lo) * torch.rand((c, 1, 3), generator=g,
                                             device=device))
    if mix["jitter"] > 0:
        clip = mix["jitter_clip"]
        xyz = xyz + torch.clamp(mix["jitter"] * torch.randn(
            xyz.shape, generator=g, device=device), -clip, clip)
    parts = torch.tensor(num_parts, device=device)
    starts = torch.cumsum(parts, 0) - parts
    cat = torch.randint(0, len(num_parts), (c,), generator=g, device=device)
    z = xyz[..., 2]
    zmin, zmax = z.amin(1, keepdim=True), z.amax(1, keepdim=True)
    count = parts[cat][:, None]
    band = ((z - zmin) / (zmax - zmin + 1e-9) * count).long()
    labels = starts[cat][:, None] + torch.minimum(band, count - 1)
    order = morton_order(xyz)
    xyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    labels = torch.gather(labels, 1, order)
    return {"xyz": xyz.float().contiguous(),
            "labels": labels.to(torch.int32),
            "category": cat.to(torch.int32)}


def pool(mix: dict, cfg: dict, seed: int, device) -> List[dict]:
    """``mix["pool"]`` batches of ``mix["clouds"]`` clouds: dicts of
    xyz, mask, features, labels, category, on ``device`` (numpy arrays
    where ``mix["host"]``, as a client holds a request)."""
    if mix["points"] != cfg["num_points"]:
        raise ValueError(f"mix has {mix['points']} points a cloud, the "
                         f"configuration {cfg['num_points']}")
    if cfg["input_features"] != "xyz":
        raise ValueError("the generator makes the xyz input features only")
    allc = clouds(mix, cfg["num_parts"], seed, device)
    b = mix["clouds"]
    out = []
    for i in range(mix["pool"]):
        rows = slice(i * b, (i + 1) * b)
        xyz = allc["xyz"][rows]
        batch = {"xyz": xyz,
                 "mask": torch.ones(xyz.shape[:2], dtype=torch.bool,
                                    device=device),
                 "features": xyz,
                 "labels": allc["labels"][rows],
                 "category": allc["category"][rows]}
        if mix.get("host"):
            batch = {k: np.ascontiguousarray(v.cpu().numpy())
                     for k, v in batch.items()}
        out.append(batch)
    return out
