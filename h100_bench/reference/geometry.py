"""Plain PyTorch geometry of the CloserLook3D backbone: furthest point
sampling, the masked ordered ball query and the masked 1-NN.

Semantics (written from the paper's method and the port's documented
contracts, with no code of the port imported):

  * distances are sum_d (q_d - s_d)^2 over d = 0, 1, 2, each product and
    sum rounded to f32 in that order (no fused multiply-add), so that an
    exact kernel gives the same neighbours bit for bit;
  * masked supports sit 1e10 further away;
  * the ball query takes the nsample nearest supports, ascending, lowest
    index first on ties; slots farther than the radius (d2 > f32(r)^2)
    or of a masked query are invalid and hold the nearest support's index;
  * FPS starts at each cloud's first valid point and picks the first
    index on ties.

Everything runs on the inputs' device in blocks of queries, so that a
stage of 32 x 10000 points never holds its whole distance matrix.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

BIG = 1e10
_INDEX_BITS = 21  # supports per cloud < 2^21
# query rows per block: B x rows x Ns int64 keys stay near 1 GiB
_BLOCK_ELEMS = 1 << 27


def r2(radius: float) -> float:
    return float(np.float32(radius) * np.float32(radius))


def dist2(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[B, Nq, 3], [B, Ns, 3] -> [B, Nq, Ns] f32."""
    d2 = None
    for d in range(3):
        diff = q[:, :, None, d] - s[:, None, :, d]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def smallest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of the last axis, ascending, lowest index first on
    ties: (values [.., k] f32, indices [.., k] int64). Non-negative f32
    keys order like their bit patterns, so (bits << 21) | index is a
    unique key whose order is the stable one. Missing slots (k > Ns)
    repeat the nearest index at distance BIG."""
    n = d2.shape[-1]
    if n >= 1 << _INDEX_BITS:
        raise ValueError(f"{n} supports: at most {(1 << _INDEX_BITS) - 1}")
    kk = min(k, n)
    keys = (d2.contiguous().view(torch.int32).to(torch.int64) << _INDEX_BITS
            ) | torch.arange(n, device=d2.device)
    top = torch.topk(keys, kk, dim=-1, largest=False, sorted=True).values
    idx = top & ((1 << _INDEX_BITS) - 1)
    vals = torch.gather(d2, -1, idx)
    if kk < k:
        pad = k - kk
        vals = torch.cat([vals, vals.new_full((*vals.shape[:-1], pad), BIG)],
                         -1)
        idx = torch.cat([idx, idx[..., :1].expand(*idx.shape[:-1], pad)], -1)
    return vals, idx


def _blocks(nq: int, b: int, ns: int):
    rows = max(1, _BLOCK_ELEMS // max(1, b * ns))
    return range(0, nq, rows), rows


def _bias(mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, 0.0, BIG).to(torch.float32)[:, None, :]


def ball_query(q, s, radius: float, nsample: int, qmask, smask,
               count_pairs: bool = False):
    """(idx [B,Nq,K] int64, valid [B,Nq,K] bool[, pairs]): ``pairs`` is
    the number of (valid query, valid support) pairs within the radius,
    all of them, not only the K kept."""
    starts, rows = _blocks(q.shape[1], q.shape[0], s.shape[1])
    bias, lim = _bias(smask), r2(radius)
    out_i, out_v, pairs = [], [], 0
    for i in starts:
        d2 = dist2(q[:, i:i + rows], s) + bias
        if count_pairs:
            inside = (d2 <= lim) & qmask[:, i:i + rows, None]
            pairs += int(inside.sum())
        vals, idx = smallest(d2, nsample)
        valid = vals <= lim
        out_i.append(torch.where(valid, idx, idx[..., :1]))
        out_v.append(valid)
    idx = torch.cat(out_i, 1)
    valid = torch.cat(out_v, 1) & qmask[..., None]
    return (idx, valid, pairs) if count_pairs else (idx, valid)


def nearest(q, s, smask) -> torch.Tensor:
    """Index [B, Nq] int64 of each query's nearest valid support."""
    starts, rows = _blocks(q.shape[1], q.shape[0], s.shape[1])
    bias = _bias(smask)
    return torch.cat([smallest(dist2(q[:, i:i + rows], s) + bias, 1)[1][..., 0]
                      for i in starts], 1)


def furthest_point_sample(xyz, npoint: int, mask
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx [B, npoint] int64, sample_mask [B, npoint] bool)."""
    b, n, _ = xyz.shape
    mindist = torch.where(mask, 1e10, -1.0).to(torch.float32)
    cur = torch.argmax(mask.to(torch.int32), dim=1)
    out = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        out[:, i] = cur
        sel = torch.gather(xyz, 1, cur[:, None, None].expand(b, 1, 3))
        diff = xyz - sel
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        mindist = torch.minimum(mindist, d)
        cur = torch.argmax(mindist, dim=1)
    slot = torch.arange(npoint, device=xyz.device)[None, :]
    return out, slot < mask.sum(dim=1)[:, None]


def stage_plan(cfg: dict) -> Dict[str, list]:
    nstage = len(cfg["nsamples"])
    npoints = list(cfg["npoints"]) or [
        max(cfg["num_points"] // 4 ** s, 1) for s in range(nstage)]
    return {"npoints": npoints,
            "radii": [cfg["radius"] * 2 ** s for s in range(nstage)],
            "nsamples": list(cfg["nsamples"]),
            "widths": [cfg["width"] * 2 ** s for s in range(nstage)]}


def compute(cfg: dict, xyz: torch.Tensor, mask: torch.Tensor,
            count_pairs: bool = False) -> Dict[str, object]:
    """Every stage's points, masks, neighbours (``idx_<s>``/``nmask_<s>``;
    strided ``idx_s<s>``/``nmask_s<s>`` from stage s-1 into s) and 1-NN
    upsample indices ``up_<s>``, for FPS sampling. With ``count_pairs``,
    ``pairs`` lists the in-radius pair count of each ball query in call
    order (idx_0, then per stage sidx_s, idx_s)."""
    if cfg["sampling"] != "fps":
        raise ValueError("the reference samples by FPS only")
    plan = stage_plan(cfg)
    radii, ns = plan["radii"], plan["nsamples"]
    x = xyz.float()
    g: Dict[str, object] = {"xyz_0": x, "mask_0": mask}
    pairs = []

    def bq(key, q, s, r, k, qm, sm):
        res = ball_query(q, s, r, k, qm, sm, count_pairs)
        g[f"idx_{key}"], g[f"nmask_{key}"] = res[0], res[1]
        if count_pairs:
            pairs.append(res[2])

    bq("0", x, x, radii[0], ns[0], mask, mask)
    px, pm = x, mask
    for s in range(1, len(ns)):
        fidx, fm = furthest_point_sample(px, plan["npoints"][s], pm)
        nx = torch.gather(px, 1, fidx[..., None].expand(-1, -1, 3))
        bq(f"s{s}", nx, px, radii[s - 1] * 2.0, ns[s - 1], fm, pm)
        bq(f"{s}", nx, nx, radii[s], ns[s], fm, fm)
        g[f"xyz_{s}"], g[f"mask_{s}"] = nx, fm
        px, pm = nx, fm
    for s in range(len(ns) - 1):
        g[f"up_{s}"] = nearest(g[f"xyz_{s}"], g[f"xyz_{s + 1}"],
                               g[f"mask_{s + 1}"])
    if count_pairs:
        g["pairs"] = pairs
    return g
