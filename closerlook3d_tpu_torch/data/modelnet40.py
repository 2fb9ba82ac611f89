"""ModelNet40 classification (``closerlook3d_tpu/data/modelnet40.py``).

Reads the ``modelnet40_normal_resampled`` distribution: one txt file of
points with normals a shape (``x,y,z,nx,ny,nz``), the official train and
test lists, the class from the shape id. Samples ``num_points`` a cloud
(a seeded random subset in training, a fixed stride in test) and
augments training clouds by rotation, scale and jitter. The first read of
a shape caches it as ``.npy`` beside its txt file.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from closerlook3d_tpu_torch.data import transforms as T

_CLASSES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant",
    "radio", "range_hood", "sink", "sofa", "stairs", "stool", "table",
    "tent", "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]


class ModelNet40:
    num_classes = 40

    def __init__(self, cfg, split: str = "train"):
        self.cfg = cfg
        self.split = split
        self.num_points = cfg.num_points
        root = os.path.join(cfg.data_root, "modelnet40_normal_resampled")
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"ModelNet40 not found at {root}; expected the "
                "'modelnet40_normal_resampled' distribution")
        self.root = root
        listfile = os.path.join(
            root, f"modelnet40_{'train' if split == 'train' else 'test'}.txt")
        with open(listfile) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self.label_by_id = {
            sid: _CLASSES.index("_".join(sid.split("_")[:-1]))
            for sid in self.ids
        }

    def __len__(self):
        return len(self.ids)

    def _load(self, sid: str) -> np.ndarray:
        cls = "_".join(sid.split("_")[:-1])
        npy = os.path.join(self.root, cls, sid + ".npy")
        if os.path.exists(npy):
            return np.load(npy)
        txt = os.path.join(self.root, cls, sid + ".txt")
        pts = np.loadtxt(txt, delimiter=",").astype(np.float32)
        try:
            np.save(npy, pts)
        except OSError:
            pass  # read-only data dir: skip the cache
        return pts

    def __getitem__(self, i: int):
        sid = self.ids[i]
        raw = self._load(sid)  # [10000, 6] xyz + normals
        rng = (np.random.default_rng((self.cfg.rng_seed * 1000003 + i) ^
                                     os.getpid())
               if self.split == "train" else None)
        (pts6,), mask = T.sample_or_pad([raw], self.num_points, rng)
        xyz, normals = pts6[:, :3], pts6[:, 3:6]
        if self.split == "train":
            rot = T.rotation_matrix(self.cfg.augment_rotation, rng)
            xyz, normals = T.rotate(xyz, rot, normals)
            xyz = T.scale_and_jitter(
                xyz, rng, self.cfg.augment_scale_min,
                self.cfg.augment_scale_max,
                symmetries=list(self.cfg.augment_symmetries),
                noise=self.cfg.augment_noise, shift=self.cfg.augment_shift)
        return {
            "xyz": xyz.astype(np.float32),
            "normals": normals.astype(np.float32),
            "mask": mask,
            "label": np.int32(self.label_by_id[sid]),
        }
