"""ShapeNetPart part segmentation, 16 categories and 50 parts
(``closerlook3d_tpu/data/shapenetpart.py``).

The 16 categories of the official benchmark in its order, with their part
counts (``NUM_PARTS``, summing to 50); global part ids are the cumulative
offsets of this order. The part-segmentation head takes its width from
``NUM_PARTS`` when a config names the dataset without ``num_parts``.
``ShapeNetPart`` reads the
``shapenetcore_partanno_segmentation_benchmark_v0_normal`` distribution:
one txt file a shape (``x y z nx ny nz part``, global part ids), the
category from its synset directory, the official json split lists. The
first read of a shape caches it as ``.npy`` beside its txt file.
"""

from __future__ import annotations

import json
import os

import numpy as np

from closerlook3d_tpu_torch.data import transforms as T

# (category name, synset id, number of parts) — official benchmark order;
# global part ids are the cumulative offsets of this order.
CATEGORIES = [
    ("Airplane", "02691156", 4), ("Bag", "02773838", 2),
    ("Cap", "02954340", 2), ("Car", "02958343", 4),
    ("Chair", "03001627", 4), ("Earphone", "03261776", 3),
    ("Guitar", "03467517", 3), ("Knife", "03624134", 2),
    ("Lamp", "03636649", 4), ("Laptop", "03642806", 2),
    ("Motorbike", "03790512", 6), ("Mug", "03797390", 2),
    ("Pistol", "03948459", 3), ("Rocket", "04099429", 3),
    ("Skateboard", "04225987", 3), ("Table", "04379243", 3),
]
NUM_PARTS = [c[2] for c in CATEGORIES]  # sums to 50
_SYNSET_TO_CAT = {c[1]: i for i, c in enumerate(CATEGORIES)}


class ShapeNetPart:
    num_parts = NUM_PARTS

    def __init__(self, cfg, split: str = "train"):
        self.cfg = cfg
        self.split = split
        self.num_points = cfg.num_points
        root = os.path.join(
            cfg.data_root,
            "shapenetcore_partanno_segmentation_benchmark_v0_normal")
        if not os.path.isdir(root):
            raise FileNotFoundError(f"ShapeNetPart not found at {root}")
        self.root = root
        split_names = {"train": ["train", "val"], "trainval": ["train", "val"],
                       "test": ["test"], "val": ["val"]}[split]
        self.files = []
        for s in split_names:
            jf = os.path.join(root, "train_test_split",
                              f"shuffled_{s}_file_list.json")
            with open(jf) as f:
                for token in json.load(f):
                    # token like 'shape_data/02691156/xxxx'
                    _, synset, sid = token.split("/")
                    self.files.append((synset, sid))

    def __len__(self):
        return len(self.files)

    def _load(self, synset: str, sid: str) -> np.ndarray:
        npy = os.path.join(self.root, synset, sid + ".npy")
        if os.path.exists(npy):
            return np.load(npy)
        data = np.loadtxt(
            os.path.join(self.root, synset, sid + ".txt")).astype(np.float32)
        try:
            np.save(npy, data)
        except OSError:
            pass
        return data

    def __getitem__(self, i: int):
        synset, sid = self.files[i]
        cat = _SYNSET_TO_CAT[synset]
        data = self._load(synset, sid)  # [N, 7]
        rng = (np.random.default_rng(self.cfg.rng_seed * 999983 + i)
               if self.split in ("train", "trainval") else None)
        (data,), mask = T.sample_or_pad([data], self.num_points, rng)
        xyz, normals = data[:, :3], data[:, 3:6]
        labels = data[:, 6].astype(np.int32)  # global part ids
        if self.split in ("train", "trainval"):
            rot = T.rotation_matrix(self.cfg.augment_rotation, rng)
            xyz, normals = T.rotate(xyz, rot, normals)
            xyz = T.scale_and_jitter(
                xyz, rng, self.cfg.augment_scale_min,
                self.cfg.augment_scale_max,
                symmetries=list(self.cfg.augment_symmetries),
                noise=self.cfg.augment_noise)
        return {
            "xyz": xyz.astype(np.float32),
            "normals": normals.astype(np.float32),
            "mask": mask,
            "labels": labels,
            "category": np.int32(cat),
        }
