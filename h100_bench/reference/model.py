"""Plain PyTorch reference of the CloserLook3D part-segmentation network,
its multi-shape loss and its SGD update, in float32.

Written from the paper (Liu et al., "A Closer Look at Local Aggregation
Operators in Point Cloud Analysis", ECCV 2020) and the configuration
file; it imports nothing of the program under test. Weights are a dict
of tensors named as the program's ``state_dict`` names them (the
checkpoint format both sides read), made by the benchmark from the seed.

Network: stem ConvBN -> local aggregation -> bottleneck at full
resolution, then per stage a strided bottleneck (FPS 4x down, the
shortcut a masked neighbourhood max) and ``depth`` bottlenecks; a U-Net
decoder by 1-NN upsampling and skip concatenation; ConvBN, dropout and a
float32 Linear to the logits of every category's parts. Aggregations:

  * PosPool xyz, avg: channel third d of f_j scaled by dp_ij[d],
    dp = (p_j - p_i) / r, averaged over the valid neighbours;
  * point-wise MLP (one FC on [dp | f_j | f_j - f_i], masked BatchNorm,
    ReLU, max over the valid neighbours), computed through the exact
    identity FC(x_ij) = G_j - D_i with per-point projections, so that a
    32 x 10000 step fits the card; f_i is the feature of slot 0.

``rd`` marks where the configuration's compute dtype rounds a value: the
inputs, weights and outputs of each ConvBN's matmul, BatchNorm outputs,
aggregation outputs, the residual sum and the dropout. The reference
passes ``None`` (float32 throughout); the control passes a rounding to a
lower precision, applied to values going forward and to gradients
coming back.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import geometry

EPS = 1e-5
NEG = -1e9
Params = Dict[str, torch.Tensor]
Round = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _r(rd: Round, x: torch.Tensor) -> torch.Tensor:
    return x if rd is None else rd(x)


def _batch_norm(p: Params, name: str, x, train: bool):
    if train:
        rows = tuple(range(x.ndim - 1))
        mean = x.mean(dim=rows)
        var = torch.clamp((x * x).mean(dim=rows) - mean * mean, min=0.0)
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    return (x - mean) * (torch.rsqrt(var + EPS) * p[name + ".weight"]) \
        + p[name + ".bias"]


def conv_bn(p: Params, name: str, x, train: bool, rd: Round,
            relu: bool = True):
    y = _r(rd, _r(rd, x) @ _r(rd, p[name + ".linear.weight"]).t())
    y = _r(rd, _batch_norm(p, name + ".bn", y, train))
    return F.relu(y) if relu else y


def group(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, Ns, C] by [B, Nq, K] -> [B, Nq, K, C]."""
    b, nq, k = idx.shape
    flat = idx.reshape(b, nq * k, 1).expand(b, nq * k, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(b, nq, k, x.shape[-1])


def _masked_max(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    out = v.masked_fill(~m[..., None], float("-inf")).amax(dim=-2)
    return torch.where(m.any(-1, keepdim=True), out, torch.zeros_like(out))


def _offsets(q, s, idx, radius):
    r = torch.full((), radius, dtype=torch.float32, device=q.device)
    return (group(s, idx) - q[:, :, None, :]) / r


def pospool_xyz_avg(q, s, f, idx, m, radius):
    g = f.shape[-1] // 3
    fj = group(f, idx)
    dp = _offsets(q, s, idx, radius)
    enc = torch.cat([fj[..., :g] * dp[..., 0:1],
                     fj[..., g:2 * g] * dp[..., 1:2],
                     fj[..., 2 * g:] * dp[..., 2:3]], dim=-1)
    total = (enc * m[..., None].to(enc.dtype)).sum(dim=-2)
    return total / torch.clamp(m.sum(-1, keepdim=True).to(enc.dtype), min=1.0)


def pointwise_mlp_max(p: Params, name: str, q, s, f, idx, m, radius,
                      train: bool, rd: Round):
    """One FC on [dp | f_j | f_j - f_i], masked BatchNorm, ReLU, masked
    max: FC = G[j] - D[i], G = (s/r) W_dp + f W_fi + f W_df, D = (q/r) W_dp
    + f_i W_df."""
    w = p[name + ".pw_linears.0.weight"].t()
    c = f.shape[-1]
    r = torch.full((), radius, dtype=torch.float32, device=q.device)
    wdp, wfi, wdf = w[:3], w[3:3 + c], w[3 + c:]
    f0 = torch.gather(f, 1, idx[:, :, 0:1].expand(-1, -1, c))

    def dot(x, ws):
        return _r(rd, x.to(ws.dtype)) @ _r(rd, ws)

    gproj = _r(rd, dot(s / r, wdp) + dot(f, wfi) + dot(f, wdf))
    dproj = dot(q / r, wdp) + dot(f0, wdf)
    if not train:
        dproj = _r(rd, dproj)
    h = group(gproj, idx) - dproj[:, :, None, :]
    bn = name + ".pw_bns.0"
    if train:
        mm = m[..., None].to(h.dtype)
        cnt = torch.clamp(mm.sum(), min=1.0)
        mean = (h * mm).sum(dim=(0, 1, 2)) / cnt
        var = (mm * (h - mean) ** 2).sum(dim=(0, 1, 2)) / cnt
    else:
        mean, var = p[bn + ".running_mean"], p[bn + ".running_var"]
    scale = p[bn + ".weight"] * torch.rsqrt(var + EPS)
    y = F.relu(h * scale + (p[bn + ".bias"] - mean * scale))
    return _masked_max(y, m)


def aggregate(p: Params, name: str, cfg: dict, q, s, f, idx, m, radius,
              train: bool, rd: Round):
    kind = cfg["local_aggregation_type"]
    if kind == "pospool":
        pp = cfg["pospool"]
        if (pp["position_embedding"], pp["reduction"]) != ("xyz", "avg"):
            raise ValueError(f"reference has no PosPool {pp}")
        out = pospool_xyz_avg(q, s, f, idx, m, radius)
    elif kind == "pointwisemlp":
        pw = cfg["pointwisemlp"]
        if (pw["feature_type"], pw["num_mlps"], pw["reduction"]) != (
                "dp_fi_df", 1, "max"):
            raise ValueError(f"reference has no point-wise MLP {pw}")
        keys = [name + k for k in (".pw_linears.0.weight",
                                   ".pw_bns.0.weight", ".pw_bns.0.bias",
                                   ".pw_bns.0.running_mean",
                                   ".pw_bns.0.running_var")]

        def fn(f, *leaves):
            return pointwise_mlp_max(dict(zip(keys, leaves)), name, q, s, f,
                                     idx, m, radius, train, rd)

        leaves = [p[k] for k in keys]
        if train and torch.is_grad_enabled():
            # [B, Nq, K, C] slots are recomputed in the backward, not kept:
            # a 32 x 10000 step would otherwise not fit the card
            out = checkpoint(fn, f, *leaves, use_reentrant=False)
        else:
            out = fn(f, *leaves)
    else:
        raise ValueError(f"reference has no aggregation {kind!r}")
    return _r(rd, out)


def bottleneck(p: Params, name: str, cfg: dict, qx, qm, sx, sm, f, idx, nm,
               radius, strided: bool, train: bool, rd: Round):
    x = conv_bn(p, name + ".reduce", f, train, rd)
    x = aggregate(p, name + ".agg", cfg, qx, sx, x, idx, nm, radius, train,
                  rd)
    x = conv_bn(p, name + ".expand", x, train, rd, relu=False)
    sc = _masked_max(group(f, idx), nm) if strided else f
    if name + ".shortcut.linear.weight" in p:
        sc = conv_bn(p, name + ".shortcut", sc, train, rd, relu=False)
    out = F.relu(_r(rd, x + sc))
    return out * qm[..., None].to(out.dtype)


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The (seed, step) stream of the configuration's dropout: a
    generator on ``device`` seeded from numpy's SeedSequence([seed,
    step])."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) & (2 ** 63 - 1))


def forward(p: Params, cfg: dict, xyz, mask, features, geo, train: bool,
            rd: Round = None, dropout_gen: Optional[torch.Generator] = None):
    """Logits [B, N, sum(num_parts)] f32."""
    plan = geometry.stage_plan(cfg)
    radii = plan["radii"]
    depth = cfg["depth"]
    x, m = geo["xyz_0"], geo["mask_0"]
    feats = conv_bn(p, "backbone.stem", features, train, rd)
    feats = aggregate(p, "backbone.stem_agg", cfg, x, x, feats, geo["idx_0"],
                      geo["nmask_0"], radii[0], train, rd)
    feats = bottleneck(p, "backbone.blocks.0", cfg, x, m, x, m, feats,
                       geo["idx_0"], geo["nmask_0"], radii[0], False, train,
                       rd)
    stages = [(x, m, feats)]
    blk = 1
    for s in range(1, len(plan["nsamples"])):
        nx, nm = geo[f"xyz_{s}"], geo[f"mask_{s}"]
        feats = bottleneck(p, f"backbone.blocks.{blk}", cfg, nx, nm, x, m,
                           feats, geo[f"idx_s{s}"], geo[f"nmask_s{s}"],
                           radii[s - 1] * 2.0, True, train, rd)
        blk += 1
        x, m = nx, nm
        for _ in range(depth):
            feats = bottleneck(p, f"backbone.blocks.{blk}", cfg, x, m, x, m,
                               feats, geo[f"idx_{s}"], geo[f"nmask_{s}"],
                               radii[s], False, train, rd)
            blk += 1
        stages.append((x, m, feats))
    y = stages[-1][2]
    for j, s in enumerate(range(len(stages) - 2, -1, -1)):
        up = torch.gather(y, 1, geo[f"up_{s}"][..., None].expand(
            -1, -1, y.shape[-1]))
        y = conv_bn(p, f"head.decoder.convs.{j}",
                    torch.cat([up, stages[s][2]], dim=-1), train, rd)
        y = y * stages[s][1][..., None].to(y.dtype)
    y = conv_bn(p, "head.conv", y, train, rd)
    if train and cfg["dropout_rate"] > 0:
        keep = 1.0 - cfg["dropout_rate"]
        draw = torch.rand(y.shape, generator=dropout_gen, device=y.device)
        y = torch.where(draw < keep, _r(rd, y / keep), torch.zeros_like(y))
    w = p["head.fc.weight"]
    return y.to(w.dtype) @ w.t() + p["head.fc.bias"]


def part_table(num_parts: Sequence[int], device):
    starts = np.concatenate([[0], np.cumsum(num_parts)[:-1]])
    return torch.tensor(np.stack([starts, num_parts], 1), device=device)


def multi_shape_loss(logits, labels, category, mask,
                     num_parts: Sequence[int], smoothing: float):
    """Part CE over each cloud's category slice, label smoothing spread
    over the slice, averaged over the valid points."""
    ptotal = logits.shape[-1]
    table = part_table(num_parts, logits.device)
    start = table[category.long(), 0][:, None]
    count = table[category.long(), 1][:, None]
    ids = torch.arange(ptotal, device=logits.device)[None, :]
    in_slice = ((ids >= start) & (ids < start + count))[:, None, :]
    logp = F.log_softmax(torch.where(in_slice, logits, NEG), dim=-1)
    target = F.one_hot(labels.long(), ptotal).float()
    if smoothing > 0:
        target = (target * (1 - smoothing) + smoothing * in_slice.float()
                  / count[:, :, None].float())
    ce = -(target * logp).sum(-1)
    w = mask.float()
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def learning_rate(cfg: dict, count: int) -> float:
    """Linear warmup from 1% of the base rate, then cosine, by step."""
    spe = cfg["steps_per_epoch"]
    base = cfg["base_learning_rate"]
    warm = int(cfg["warmup_epoch"] * spe)
    total = max(int(cfg["epochs"] * spe), warm + 1)
    if cfg["lr_scheduler"] != "cosine":
        raise ValueError("reference has the cosine schedule only")
    if count < warm:
        frac = 1 - min(max(count, 0), warm) / warm
        return (base * 0.01 - base) * frac + base
    decay = max(total - warm, 1)
    c = min(count - warm, decay)
    return base * 0.5 * (1 + math.cos(math.pi * c / decay))


def trainable(names: Sequence[str]) -> List[str]:
    return [n for n in names if not n.endswith(("running_mean",
                                                "running_var"))]


def train_steps(weights: Params, cfg: dict, batches: Sequence[dict],
                dropout_seed: int, rd: Round = None) -> dict:
    """SGD steps from ``weights`` on ``batches`` (one step each): the
    losses, each leaf's first gradient, and the parameters after the
    last step. Momentum without Nesterov; weight decay added to the
    gradient of leaves with two or more dimensions."""
    names = trainable(list(weights))
    params = {n: weights[n].detach().clone() for n in names}
    fixed = {n: t for n, t in weights.items() if n not in params}
    bufs: Dict[str, torch.Tensor] = {}
    losses, first_grads = [], None
    wd, mom = cfg["weight_decay"], cfg["momentum"]
    if cfg.get("grad_clip", 0.0) > 0:
        raise ValueError("reference has no gradient clipping")
    for step, b in enumerate(batches):
        with torch.no_grad():
            geo = geometry.compute(cfg, b["xyz"], b["mask"])
        for t in params.values():
            t.requires_grad_(True)
        gen = dropout_generator(dropout_seed, step, b["xyz"].device)
        logits = forward({**fixed, **params}, cfg, b["xyz"], b["mask"],
                         b["features"], geo, True, rd, gen)
        loss = multi_shape_loss(logits, b["labels"], b["category"],
                                b["mask"], cfg["num_parts"],
                                cfg["label_smoothing"])
        grads = torch.autograd.grad(loss, list(params.values()))
        del logits, geo
        losses.append(float(loss.detach()))
        lr = learning_rate(cfg, step)
        with torch.no_grad():
            if first_grads is None:
                first_grads = {n: g.clone() for n, g in zip(params, grads)}
            for (n, t), g in zip(params.items(), grads):
                d = g + wd * t if t.ndim >= 2 else g
                bufs[n] = d.clone() if n not in bufs else bufs[n] * mom + d
                params[n] = (t - lr * bufs[n]).detach()
        del grads
    return {"losses": losses, "first_grads": first_grads,
            "params": {n: t.detach() for n, t in params.items()}}


@torch.no_grad()
def serve_logits(weights: Params, cfg: dict, xyz, mask, features,
                 rd: Round = None) -> torch.Tensor:
    geo = geometry.compute(cfg, xyz, mask)
    return forward(weights, cfg, xyz, mask, features, geo, False, rd)
