"""S3DIS scene segmentation (6 areas, 13 classes), numpy on the host
(``closerlook3d_tpu/data/s3dis.py``).

Rooms are grid-subsampled (0.04 m) when prepared and cached as one npz a
room under ``<data_root>/s3dis_processed_<cell>/``: the sub-cloud
(``sub_xyz``, ``sub_rgb``, ``sub_labels``) and the full cloud
(``full_xyz``, ``full_labels``). Training samples spheres of radius
``in_radius`` around low-potential centers, padded and masked to
``num_points``; evaluation covers each room with spheres and votes
(``train/evaluate.py``). Prep reads the raw
``Stanford3dDataset_v1.2_Aligned_Version`` tree
(``Area_*/room/Annotations/*.txt``).

Where the JAX package may use its optional C++ module (``native/``), the
port takes the fallbacks that package takes without it: numpy for the
grid subsampling and scipy's ``cKDTree`` for the sphere queries, imported
where the dataset is built, so importing this module needs no scipy.
Same draws, same query order, so a seed gives the same spheres in both
packages.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from closerlook3d_tpu_torch.data import transforms as T

CLASS_NAMES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
]
NUM_CLASSES = 13
_NAME_TO_ID = {n: i for i, n in enumerate(CLASS_NAMES)}
_NAME_TO_ID["stairs"] = _NAME_TO_ID["clutter"]  # reference folds stairs in


def grid_subsample_np(points: np.ndarray, cell: float,
                      features: Optional[np.ndarray] = None,
                      labels: Optional[np.ndarray] = None):
    """CPU voxel-barycenter subsampling (labels by majority vote).

    The JAX package's numpy path: voxels keyed z, then y, then x (scan-
    line order), averaged in f64 and rounded to f32 once.
    """
    mins = points.min(0)
    cells = np.floor((points - mins) / cell).astype(np.int64)
    key = (cells[:, 2] * (2**20) + cells[:, 1]) * (2**20) + cells[:, 0]
    order = np.argsort(key)
    ks = key[order]
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    counts = np.diff(np.concatenate([starts, [len(ks)]]))
    seg = np.repeat(np.arange(len(starts)), counts)
    out_pts = np.zeros((len(starts), 3), np.float64)
    np.add.at(out_pts, seg, points[order])
    out_pts = (out_pts / counts[:, None]).astype(np.float32)
    out_feats = None
    if features is not None:
        out_feats = np.zeros((len(starts), features.shape[1]), np.float64)
        np.add.at(out_feats, seg, features[order])
        out_feats = (out_feats / counts[:, None]).astype(np.float32)
    out_labels = None
    if labels is not None:
        # majority vote per voxel
        nclass = int(labels.max()) + 1
        hist = np.zeros((len(starts), nclass), np.int32)
        np.add.at(hist, (seg, labels[order]), 1)
        out_labels = hist.argmax(1).astype(np.int32)
    return out_pts, out_feats, out_labels


def _parse_raw_room(room_dir: str):
    """(xyz f32, rgb f32 in [0, 1], labels int32) of a raw room's
    annotation files; unknown names and stairs count as clutter."""
    pts, cols, labs = [], [], []
    ann = os.path.join(room_dir, "Annotations", "*.txt")
    for fn in sorted(glob.glob(ann)):
        name = os.path.basename(fn).split("_")[0]
        cls = _NAME_TO_ID.get(name, _NAME_TO_ID["clutter"])
        data = np.loadtxt(fn)
        pts.append(data[:, :3].astype(np.float32))
        cols.append(data[:, 3:6].astype(np.float32) / 255.0)
        labs.append(np.full(len(data), cls, np.int32))
    return np.concatenate(pts), np.concatenate(cols), np.concatenate(labs)


def prepare_rooms(data_root: str, cell: float = 0.04) -> str:
    """Process raw S3DIS into per-room npz caches; returns the cache dir."""
    out_dir = os.path.join(data_root, f"s3dis_processed_{cell:g}")
    os.makedirs(out_dir, exist_ok=True)
    raw = os.path.join(data_root, "Stanford3dDataset_v1.2_Aligned_Version")
    rooms = sorted(glob.glob(os.path.join(raw, "Area_*", "*")))
    rooms = [r for r in rooms if os.path.isdir(r)]
    if not rooms:
        raise FileNotFoundError(f"no raw S3DIS rooms under {raw}")
    for room_dir in rooms:
        area = os.path.basename(os.path.dirname(room_dir))
        room = os.path.basename(room_dir)
        out = os.path.join(out_dir, f"{area}__{room}.npz")
        if os.path.exists(out):
            continue
        xyz, rgb, lab = _parse_raw_room(room_dir)
        sxyz, srgb, slab = grid_subsample_np(xyz, cell, rgb, lab)
        np.savez_compressed(
            out, sub_xyz=sxyz, sub_rgb=srgb, sub_labels=slab,
            full_xyz=xyz, full_labels=lab)
    return out_dir


class S3DIS:
    """Sphere-sampling dataset over processed rooms.

    Training length is ``num_steps * batch_size`` spheres per pseudo-epoch
    (the reference's fixed-steps protocol). Centers are picked by minimum
    potential: each draw adds a distance-tapered potential to the points
    it covers, driving uniform coverage.
    """

    num_classes = NUM_CLASSES

    def __init__(self, cfg, split: str = "train"):
        self.cfg = cfg
        self.split = split
        self.num_points = cfg.num_points
        self.in_radius = cfg.in_radius
        cache = os.path.join(
            cfg.data_root, f"s3dis_processed_{cfg.first_subsampling_dl:g}")
        if not os.path.isdir(cache):
            cache = prepare_rooms(cfg.data_root, cfg.first_subsampling_dl)
        files = sorted(glob.glob(os.path.join(cache, "*.npz")))
        test_area = f"Area_{cfg.s3dis_test_area}"
        if split == "train":
            files = [f for f in files
                     if not os.path.basename(f).startswith(test_area)]
        else:
            files = [f for f in files
                     if os.path.basename(f).startswith(test_area)]
        if not files:
            raise FileNotFoundError(f"no processed S3DIS rooms in {cache}")
        self.room_names: List[str] = []
        self.xyz: List[np.ndarray] = []
        self.rgb: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []
        self.trees = []
        self.files = files
        from scipy.spatial import cKDTree

        for f in files:
            with np.load(f) as z:
                self.room_names.append(os.path.basename(f)[:-4])
                self.xyz.append(z["sub_xyz"])
                self.rgb.append(z["sub_rgb"])
                self.labels.append(z["sub_labels"])
            self.trees.append(cKDTree(self.xyz[-1]))
        counts = np.array([len(x) for x in self.xyz], np.float64)
        self.room_probs = counts / counts.sum()
        self.potentials = [np.random.default_rng(cfg.rng_seed + i)
                           .random(len(x)).astype(np.float32) * 1e-3
                           for i, x in enumerate(self.xyz)]
        self._rng = np.random.default_rng(cfg.rng_seed + 17)

    def full_cloud(self, room_idx: int):
        with np.load(self.files[room_idx]) as z:
            return z["full_xyz"], z["full_labels"]

    def __len__(self):
        """Spheres a pseudo-epoch: ``num_steps * batch_size`` in training;
        else four per sphere's worth of each room's sub-points (at least
        one sphere's worth a room). The JAX package's test split names an
        undefined ``r`` here (ROADMAP C10)."""
        if self.split == "train":
            return self.cfg.num_steps * self.cfg.batch_size
        return 4 * sum(max(len(r) // self.num_points, 1) for r in self.xyz)

    def pick_center(self, room_idx: Optional[int] = None):
        """Minimum-potential center pick; updates potentials (KPConv style)."""
        if room_idx is None:
            mins = [p.min() for p in self.potentials]
            room_idx = int(np.argmin(mins))
        pot = self.potentials[room_idx]
        ci = int(np.argmin(pot))
        center = self.xyz[room_idx][ci]
        idx = self.trees[room_idx].query_ball_point(center, self.in_radius)
        idx = np.asarray(idx, dtype=np.int64)
        d = np.linalg.norm(self.xyz[room_idx][idx] - center, axis=1)
        pot[idx] += np.square(1.0 - d / self.in_radius).astype(np.float32)
        return room_idx, center, idx

    def extract_sphere(self, room_idx: int, center: np.ndarray,
                       idx: np.ndarray, train: bool):
        xyz = self.xyz[room_idx][idx]
        rgb = self.rgb[room_idx][idx]
        labels = self.labels[room_idx][idx]
        rng = self._rng if train else None
        (xyz, rgb, labels, sub_idx), mask = T.sample_or_pad(
            [xyz, rgb, labels, idx], self.num_points, rng)
        height = xyz[:, 2:3].copy()
        rel = xyz - center  # recentre; height feature keeps absolute z
        if train:
            rot = T.rotation_matrix(self.cfg.augment_rotation, rng)
            rel, _ = T.rotate(rel, rot)
            rel = T.scale_and_jitter(
                rel, rng, self.cfg.augment_scale_min,
                self.cfg.augment_scale_max,
                noise=self.cfg.augment_noise)
            rgb = T.color_drop(rgb, rng, self.cfg.color_drop)
        return {
            "xyz": rel.astype(np.float32),
            "rgb": rgb.astype(np.float32),
            "height": height.astype(np.float32),
            "mask": mask,
            "labels": labels.astype(np.int32),
            "point_idx": sub_idx.astype(np.int64),  # into the room sub-cloud
            "room_idx": np.int64(room_idx),
        }

    def __getitem__(self, i: int):
        room_idx, center, idx = self.pick_center()
        return self.extract_sphere(room_idx, center, idx,
                                   train=self.split == "train")
