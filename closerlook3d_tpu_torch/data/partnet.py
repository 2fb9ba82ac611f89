"""PartNet part segmentation (``closerlook3d_tpu/data/partnet.py``).

Reads the ``sem_seg_h5`` release: one directory a (category, level),
such as ``Chair-3/``, of h5 files holding ``data [S, 10000, 3]`` and
``label_seg [S, 10000]``. Categories of one level train jointly with a
head each (the multi-part model); labels are offset to global part ids
in the order the categories are found. ``h5py`` is imported where the
dataset is built, so importing this module needs none.
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from closerlook3d_tpu_torch.data import transforms as T


def _h5():
    import h5py
    return h5py


class PartNet:
    def __init__(self, cfg, split: str = "train", level: int = 3):
        self.cfg = cfg
        self.split = split
        self.num_points = cfg.num_points
        root = os.path.join(cfg.data_root, "sem_seg_h5")
        if not os.path.isdir(root):
            raise FileNotFoundError(f"PartNet sem_seg_h5 not found at {root}")
        self.root = root
        cat_dirs = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
            and d.endswith(f"-{level}"))
        if not cat_dirs:
            raise FileNotFoundError(f"no level-{level} categories in {root}")
        self.categories = cat_dirs
        h5py = _h5()
        self.index: List[Tuple[int, str, int]] = []  # (cat, file, row)
        self.num_parts: List[int] = []
        for ci, cat in enumerate(cat_dirs):
            nmax = 0
            for fn in sorted(glob.glob(
                    os.path.join(root, cat, f"{split}-*.h5"))):
                with h5py.File(fn, "r") as f:
                    rows = f["data"].shape[0]
                    nmax = max(nmax, int(np.max(f["label_seg"][:])) + 1)
                self.index.extend((ci, fn, r) for r in range(rows))
            self.num_parts.append(nmax)
        self._starts = np.concatenate(
            [[0], np.cumsum(self.num_parts)[:-1]]).astype(np.int32)
        self._cache = {}

    def __len__(self):
        return len(self.index)

    def _file(self, fn):
        if fn not in self._cache:
            self._cache[fn] = _h5().File(fn, "r")
        return self._cache[fn]

    def __getitem__(self, i: int):
        cat, fn, row = self.index[i]
        f = self._file(fn)
        xyz = np.asarray(f["data"][row], dtype=np.float32)
        labels = np.asarray(f["label_seg"][row], dtype=np.int32)
        labels = labels + self._starts[cat]
        rng = (np.random.default_rng(self.cfg.rng_seed * 999979 + i)
               if self.split == "train" else None)
        (xyz, labels), mask = T.sample_or_pad([xyz, labels],
                                              self.num_points, rng)
        if self.split == "train":
            rot = T.rotation_matrix(self.cfg.augment_rotation, rng)
            xyz, _ = T.rotate(xyz, rot)
            xyz = T.scale_and_jitter(
                xyz, rng, self.cfg.augment_scale_min,
                self.cfg.augment_scale_max,
                noise=self.cfg.augment_noise)
        return {
            "xyz": xyz.astype(np.float32),
            "mask": mask,
            "labels": labels.astype(np.int32),
            "category": np.int32(cat),
        }
