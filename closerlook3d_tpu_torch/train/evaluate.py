"""Task evaluators (``closerlook3d_tpu/train/evaluate.py``): ModelNet40
accuracy and ShapeNetPart / PartNet part mIoU over whole shapes, with
optional vote averaging, and S3DIS sliding-sphere voting.

S3DIS: spheres around low-potential centers are drawn until every
sub-cloud point has gathered ``num_votes`` worth of potential; each
sphere batch's softmax scores add up per sub-point; the sub-cloud
predictions then go to the full cloud through each full point's nearest
sub-point, and the confusion matrices give the IoUs. The per-sphere
forward is whatever ``eval_logits_fn`` runs (``Predictor`` or an eval
step); the vote bookkeeping is host numpy. The projection to the full
cloud runs the port's own ``knn`` on the device of the model's
parameters (``project_to_full``): the pruned 1-NN kernel on the card
(K11's route, one launch a room), ``knn_plain`` in query chunks on the
CPU. Ties go to the lowest sub-point index; the JAX package's kd-tree
breaks them as it happens to.

Across processes (``parallel/collectives.py``): classification sums its
counts, part segmentation concatenates its shape IoUs and sums its
confusions, each rank having evaluated its shard of the batches; S3DIS
voting gives the rooms out round-robin, votes and projects only its own
rooms, keeps its rounds in lockstep with every rank's, and sums the
confusions.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from closerlook3d_tpu_torch.data import transforms as T
from closerlook3d_tpu_torch.data.loader import build_features
from closerlook3d_tpu_torch.data.spatial_host import morton_sort_batch
from closerlook3d_tpu_torch.ops.neighbors import knn, query_chunk
from closerlook3d_tpu_torch.ops.spatial import apply_permutation, morton_sort
from closerlook3d_tpu_torch.parallel.collectives import (
    all_processes_concat, all_processes_min, all_processes_sum, world)
from closerlook3d_tpu_torch.train.metrics import (
    iou_from_confusion, miou_from_shape_ious, partnet_miou,
    shapenetpart_shape_iou)

def _fetch_local(x) -> np.ndarray:
    """Host copy of ``eval_logits_fn``'s result, a tensor on any device
    or an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def model_device(state) -> torch.device:
    """The device of ``state.model``'s parameters (a ``TrainState`` or a
    ``Predictor``); the CPU where there is none (oracle tests)."""
    model = getattr(state, "model", None)
    param = next(model.parameters(), None) if model is not None else None
    return param.device if param is not None else torch.device("cpu")


def _shape_votes(cfg) -> int:
    """Vote count for shape-task eval (cls/partseg); 1 = single clean
    pass, unless ``cfg.vote_eval``."""
    if not getattr(cfg, "vote_eval", False):
        return 1
    return max(int(cfg.num_votes), 1)


def vote_augment(batch, cfg, rng, vote: int):
    """Per-vote augmented copy of an eval batch (vote 0 = clean pass).

    As the train-time augmentation: per-cloud random rotation
    (cfg.augment_rotation) and anisotropic scale, no jitter; normals
    rotate with the cloud and features are rebuilt.
    """
    if vote == 0:
        return batch
    out = dict(batch)
    xyz = batch["xyz"]
    normals = batch.get("normals")
    new_xyz = np.empty_like(xyz)
    new_nrm = np.empty_like(normals) if normals is not None else None
    for b in range(xyz.shape[0]):
        rot = T.rotation_matrix(cfg.augment_rotation, rng)
        p, n = T.rotate(xyz[b], rot,
                        None if normals is None else normals[b])
        scale = rng.uniform(cfg.augment_scale_min, cfg.augment_scale_max,
                            size=(3,)).astype(np.float32)
        new_xyz[b] = p * scale
        if new_nrm is not None:
            new_nrm[b] = n
    out["xyz"] = new_xyz.astype(np.float32)
    if new_nrm is not None:
        out["normals"] = new_nrm
    out["features"] = build_features(out, cfg.input_features)
    return out


def evaluate_classification(cfg, state, eval_logits_fn, batch_iter):
    """ModelNet40-style accuracy; optional vote averaging (cfg.vote_eval).
    eval_logits_fn(state, batch) -> [B, num_classes] logits."""
    votes = _shape_votes(cfg)
    rng = np.random.default_rng(cfg.rng_seed)
    correct = total = 0
    for batch in batch_iter:
        keep = ~batch["batch_pad"]
        prob = None
        for v in range(votes):
            vb = vote_augment(batch, cfg, rng, v)
            db = {k: vb[k] for k in ("xyz", "mask", "features")}
            p = _softmax(_fetch_local(eval_logits_fn(state, db)))
            prob = p if prob is None else prob + p
        pred = prob.argmax(-1)
        correct += int((pred[keep] == batch["label"][keep]).sum())
        total += int(keep.sum())
    correct, total = all_processes_sum((correct, total))
    return {"accuracy": correct / max(total, 1), "num_votes": votes}


def project_to_full(sub_xyz: np.ndarray, full_xyz: np.ndarray, device
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Each full-cloud point's nearest sub-cloud point: (idx [Nf] int64
    into ``sub_xyz``, d2 [Nf] f32), by ``ops/neighbors.py::knn`` with k = 1
    on ``device``: on the card one launch of the pruned 1-NN over the
    whole room (from 1024 sub-points), on the CPU ``knn_plain`` in query
    chunks. Distances are the kernel's f32 sums.

    The sub-cloud goes to the search Morton-sorted on ``device``
    (``ops/spatial.py::morton_sort``, the keys of ``data/spatial_host.py``
    to the bit) and the indices come back through the permutation there:
    ``grid_subsample_np`` stores voxels in scan-line order, whose tiles of
    consecutive supports are thin lines that prune worse. Of equidistant
    sub-points the lowest index in the sorted order wins, which may be
    another of the tied points than the lowest index of ``sub_xyz``."""
    q = torch.as_tensor(np.ascontiguousarray(full_xyz, dtype=np.float32),
                        device=device)[None]
    s = torch.as_tensor(np.ascontiguousarray(sub_xyz, dtype=np.float32),
                        device=device)[None]
    perm, _ = morton_sort(s)
    idx, d2 = knn(q, apply_permutation(s, perm), 1,
                  chunk_size=query_chunk(q.shape[1]))
    idx = torch.gather(perm, 1, idx[..., 0].long())
    return idx[0].cpu().numpy().astype(np.int64), d2[0, :, 0].cpu().numpy()


def evaluate_s3dis_voting(cfg, dataset, state, eval_logits_fn,
                          logger=None):
    """The S3DIS voting protocol on ``dataset`` (``data/s3dis.py::S3DIS``,
    its test split). eval_logits_fn(state, batch) -> [B, N, C] logits, a
    tensor on any device or an array; the projection to the full clouds
    runs on the device of the state's model (``model_device``). Returns
    mIoU, OA and per-class IoU on the full clouds, the sub-cloud mIoU and
    OA, and the number of sphere batches (summed over processes).

    Across processes, rank r owns rooms r, r + P, ...: the potentials of
    the others are pinned to +inf, so that ``pick_center`` never draws
    there. Every rank runs the same number of rounds, until the smallest
    potential of every rank's rooms reaches ``num_votes`` (a rank whose
    rooms are covered votes on; a rank with no room sends +inf), and
    projects and counts its own rooms alone."""
    device = model_device(state)
    nroom = len(dataset.xyz)
    ranks, rank = world()
    owned = list(range(rank, nroom, ranks))
    scores = [np.zeros((len(x), dataset.num_classes), np.float32)
              for x in dataset.xyz]
    counts = [np.zeros(len(x), np.float32) for x in dataset.xyz]
    # fresh potentials for a deterministic covering
    pots = [np.random.default_rng(7 + i).random(len(x)).astype(np.float32)
            * 1e-3 for i, x in enumerate(dataset.xyz)]
    for r in range(nroom):
        if r not in owned:
            pots[r][:] = np.inf
    dataset.potentials = pots

    bs = cfg.batch_size
    vote_round = 0
    while True:
        local_min = (min(pots[r].min() for r in owned) if owned
                     else float("inf"))
        if all_processes_min(local_min) >= cfg.num_votes:
            break
        samples = []
        rooms = []
        for _ in range(bs):
            room_idx, center, idx = dataset.pick_center()
            samples.append(dataset.extract_sphere(room_idx, center, idx,
                                                  train=False))
            rooms.append(room_idx)
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        batch["features"] = build_features(batch, cfg.input_features)
        if getattr(cfg, "spatial_sort", "host") == "host":
            batch = morton_sort_batch(batch)  # permutes point_idx/mask too
        device_batch = {k: batch[k] for k in
                        ("xyz", "mask", "features", "labels")}
        prob = _softmax(_fetch_local(eval_logits_fn(state, device_batch)))
        for b, room_idx in enumerate(rooms):
            # a sphere's valid points are distinct sub-points (its ball
            # query strided or padded by sample_or_pad), so an indexed add
            # adds what np.add.at would, in a tenth of the time
            v = batch["mask"][b]
            pidx = batch["point_idx"][b][v]
            scores[room_idx][pidx] += prob[b][v]
            counts[room_idx][pidx] += 1.0
        vote_round += 1
        if logger and vote_round % 50 == 0:
            logger.info("s3dis eval: %d sphere batches, min potential %.2f",
                        vote_round, local_min)

    conf = np.zeros((dataset.num_classes, dataset.num_classes), np.float64)
    sub_conf = np.zeros_like(conf)
    for r in owned:
        seen = counts[r] > 0
        sub_pred = scores[r].argmax(1)
        lab = dataset.labels[r]
        np.add.at(sub_conf, (lab[seen], sub_pred[seen]), 1)
        full_xyz, full_labels = dataset.full_cloud(r)
        nn, _ = project_to_full(dataset.xyz[r], full_xyz, device)
        np.add.at(conf, (full_labels, sub_pred[nn]), 1)
    conf, sub_conf, vote_round = all_processes_sum(
        (conf, sub_conf, vote_round))
    iou, miou, oa = iou_from_confusion(conf)
    _, sub_miou, sub_oa = iou_from_confusion(sub_conf)
    return {"miou": miou, "oa": oa, "iou_per_class": iou.tolist(),
            "subcloud_miou": sub_miou, "subcloud_oa": sub_oa,
            "sphere_batches": vote_round}


def evaluate_partseg(cfg, dataset, state, eval_logits_fn, batch_iter):
    """ShapeNetPart / PartNet whole-shape evaluation (argmax over each
    shape's category slice, valid points); optional vote averaging over
    augmented passes (cfg.vote_eval). eval_logits_fn(state, batch) ->
    [B, N, sum(num_parts)] logits."""
    preds: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    cats: List[int] = []
    num_parts = list(cfg.num_parts)
    starts = np.concatenate([[0], np.cumsum(num_parts)[:-1]]).astype(int)
    votes = _shape_votes(cfg)
    rng = np.random.default_rng(cfg.rng_seed)
    for batch in batch_iter:
        prob = None
        for v in range(votes):
            vb = vote_augment(batch, cfg, rng, v)
            db = {k: vb[k] for k in ("xyz", "mask", "features", "labels",
                                     "category")}
            p = _softmax(_fetch_local(eval_logits_fn(state, db)))
            prob = p if prob is None else prob + p
        keep = ~batch["batch_pad"]
        for b in range(prob.shape[0]):
            if not keep[b]:
                continue
            cat = int(batch["category"][b])
            s, n = starts[cat], num_parts[cat]
            pred = prob[b][:, s:s + n].argmax(-1) + s
            m = batch["mask"][b]
            preds.append(pred[m])
            labels.append(batch["labels"][b][m])
            cats.append(cat)
    shape_ious = np.array([
        shapenetpart_shape_iou(p, lab, c, num_parts)
        for p, lab, c in zip(preds, labels, cats)], np.float64)
    # per-category confusions for the PartNet protocol
    confs = []
    for c in range(len(num_parts)):
        s, n = starts[c], num_parts[c]
        cc = np.zeros((n, n), np.float64)
        for p, lab, cat in zip(preds, labels, cats):
            if cat == c:
                np.add.at(cc, (lab - s, p - s), 1)
        confs.append(cc)
    shape_ious = all_processes_concat(shape_ious)
    cats = all_processes_concat(np.asarray(cats, np.int64)).tolist()
    confs = all_processes_sum(confs)
    ins_miou, cls_miou = miou_from_shape_ious(shape_ious, cats,
                                              len(num_parts))
    per_cat = []
    for cc in confs:
        if cc.sum() == 0:
            per_cat.append(None)  # category absent from this split
        else:
            _, m, _ = iou_from_confusion(cc)
            per_cat.append(round(float(m), 4))
    return {"ins_miou": ins_miou, "cls_miou": cls_miou,
            "category_miou": partnet_miou(confs),
            "per_category_miou": per_cat}


def _softmax(x):
    x = x - x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)
