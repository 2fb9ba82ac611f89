"""Procedural point-cloud datasets (no files needed).

A copy of ``closerlook3d_tpu/data/synthetic.py``'s
``SyntheticClassification``, ``SyntheticPartSegmentation`` and
``SyntheticSceneSegmentation``: same generators, same per-sample
seeding, so a seed gives the same arrays in both packages. Used by
``chip_smoke.py`` for clouds with real local structure (ball-query
neighborhoods, FPS picks and voxel grids of a uniform cube would not
exercise the kernels the way shapes and rooms do).
"""

from __future__ import annotations

import numpy as np


def _unit(v):
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9)


def _sphere(rng, n):
    p = _unit(rng.normal(size=(n, 3)))
    return p, p.copy()


def _cube(rng, n):
    face = rng.integers(0, 6, size=n)
    uv = rng.uniform(-1, 1, size=(n, 2))
    p = np.zeros((n, 3), np.float32)
    nrm = np.zeros((n, 3), np.float32)
    axis, sign = face // 2, (face % 2) * 2 - 1
    for i in range(n):
        a = axis[i]
        others = [j for j in range(3) if j != a]
        p[i, a] = sign[i]
        p[i, others[0]], p[i, others[1]] = uv[i]
        nrm[i, a] = sign[i]
    return p, nrm


def _cylinder(rng, n):
    a = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-1, 1, n)
    p = np.stack([np.cos(a), np.sin(a), z], 1)
    nrm = np.stack([np.cos(a), np.sin(a), np.zeros_like(a)], 1)
    return p, nrm


def _cone(rng, n):
    t = np.sqrt(rng.uniform(0, 1, n))  # area-uniform along the slant
    a = rng.uniform(0, 2 * np.pi, n)
    r = t
    p = np.stack([r * np.cos(a), r * np.sin(a), 1 - 2 * t], 1)
    nrm = _unit(np.stack([np.cos(a), np.sin(a), 0.5 * np.ones_like(a)], 1))
    return p, nrm


def _torus(rng, n, rmaj=0.7, rmin=0.3):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    cu, su, cv, sv = np.cos(u), np.sin(u), np.cos(v), np.sin(v)
    p = np.stack([(rmaj + rmin * cv) * cu, (rmaj + rmin * cv) * su,
                  rmin * sv], 1)
    nrm = np.stack([cv * cu, cv * su, sv], 1)
    return p, nrm


def _pyramid(rng, n):
    p, nrm = _cone(rng, n)
    a = np.arctan2(p[:, 1], p[:, 0])
    k = np.round(a / (np.pi / 2)) * (np.pi / 2)  # square the cross-section
    r = np.hypot(p[:, 0], p[:, 1]) / np.maximum(np.cos(a - k), 0.5)
    p = np.stack([r * np.cos(a), r * np.sin(a), p[:, 2]], 1)
    return p, nrm


def _capsule(rng, n):
    p, nrm = _sphere(rng, n)
    p[:, 2] += np.sign(p[:, 2]) * 0.8
    return p, nrm


def _helix(rng, n):
    t = rng.uniform(0, 4 * np.pi, n)
    jitterdir = _unit(rng.normal(size=(n, 3)))
    p = np.stack([0.8 * np.cos(t), 0.8 * np.sin(t), t / (2 * np.pi) - 1], 1)
    p += 0.08 * jitterdir
    return p, jitterdir


_GENERATORS = [_sphere, _cube, _cylinder, _cone, _torus, _pyramid,
               _capsule, _helix]


class SyntheticClassification:
    """len/__getitem__ dataset of parametric shapes; label = family."""

    def __init__(self, num_samples: int, num_points: int,
                 num_classes: int = 8, noise: float = 0.01,
                 seed: int = 0, augment: bool = False):
        if num_classes > len(_GENERATORS):
            raise ValueError(f"at most {len(_GENERATORS)} shape families")
        self.num_samples = num_samples
        self.num_points = num_points
        self.num_classes = num_classes
        self.noise = noise
        self.seed = seed
        self.augment = augment

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self.seed * 100003 + i)
        label = i % self.num_classes
        pts, nrm = _GENERATORS[label](rng, self.num_points)
        pts = pts + rng.normal(0, self.noise, pts.shape)
        if self.augment:
            a = rng.uniform(0, 2 * np.pi)
            c, s = np.cos(a), np.sin(a)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            pts = pts @ rot.T
            nrm = nrm @ rot.T
            pts = pts * rng.uniform(0.9, 1.1, size=(3,))
        return {
            "xyz": pts.astype(np.float32),
            "normals": nrm.astype(np.float32),
            "mask": np.ones(self.num_points, bool),
            "label": np.int32(label),
        }


class SyntheticPartSegmentation:
    """Two-category part segmentation: parts are geometric halves and
    bands (category 0: sphere top/bottom, global parts 0-1; category 1:
    cylinder in three bands, parts 2-4). ``label_noise`` flips each
    point's label, with that probability, to a uniformly random other
    part of its category."""

    num_parts = (2, 3)

    def __init__(self, num_samples: int, num_points: int, seed: int = 0,
                 label_noise: float = 0.0):
        self.num_samples = num_samples
        self.num_points = num_points
        self.seed = seed
        self.label_noise = label_noise

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self.seed * 99991 + i)
        cat = i % 2
        if cat == 0:
            pts, nrm = _sphere(rng, self.num_points)
            labels = (pts[:, 2] > 0).astype(np.int32)
        else:
            pts, nrm = _cylinder(rng, self.num_points)
            band = np.digitize(pts[:, 2], [-0.33, 0.33])
            labels = 2 + band.astype(np.int32)
        if self.label_noise > 0.0:
            lo, k = (0, 2) if cat == 0 else (2, 3)
            flip = rng.random(self.num_points) < self.label_noise
            shift = rng.integers(1, k, size=self.num_points)
            labels = np.where(flip, lo + (labels - lo + shift) % k,
                              labels).astype(np.int32)
        return {
            "xyz": pts.astype(np.float32),
            "normals": nrm.astype(np.float32),
            "mask": np.ones(self.num_points, bool),
            "labels": labels,
            "category": np.int32(cat),
        }


class SyntheticSceneSegmentation:
    """Toy rooms: a 4 m x 4 m floor plus a sphere, a box and a pillar, with
    per-point class labels and colors."""

    num_classes = 4  # floor, sphere-object, box-object, pillar

    def __init__(self, num_samples: int, num_points: int, seed: int = 0):
        self.num_samples = num_samples
        self.num_points = num_points
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self.seed * 7919 + i)
        n = self.num_points
        counts = [n // 2, n // 6, n // 6, n - n // 2 - 2 * (n // 6)]
        pts, labels, colors = [], [], []
        f = np.stack([rng.uniform(-2, 2, counts[0]),
                      rng.uniform(-2, 2, counts[0]),
                      rng.normal(0, 0.01, counts[0])], 1)
        pts.append(f)
        labels.append(np.zeros(counts[0], np.int32))
        colors.append(np.tile([0.5, 0.4, 0.3], (counts[0], 1)))
        c = rng.uniform(-1.5, 1.5, 2)
        s, _ = _sphere(rng, counts[1])
        pts.append(s * 0.3 + np.array([c[0], c[1], 0.3]))
        labels.append(np.ones(counts[1], np.int32))
        colors.append(np.tile([0.8, 0.1, 0.1], (counts[1], 1)))
        c = rng.uniform(-1.5, 1.5, 2)
        b, _ = _cube(rng, counts[2])
        pts.append(b * 0.25 + np.array([c[0], c[1], 0.25]))
        labels.append(np.full(counts[2], 2, np.int32))
        colors.append(np.tile([0.1, 0.7, 0.2], (counts[2], 1)))
        c = rng.uniform(-1.5, 1.5, 2)
        p, _ = _cylinder(rng, counts[3])
        pts.append(p * np.array([0.15, 0.15, 1.0])
                   + np.array([c[0], c[1], 1.0]))
        labels.append(np.full(counts[3], 3, np.int32))
        colors.append(np.tile([0.2, 0.2, 0.8], (counts[3], 1)))
        return {
            "xyz": np.concatenate(pts).astype(np.float32),
            "rgb": np.concatenate(colors).astype(np.float32),
            "mask": np.ones(n, bool),
            "labels": np.concatenate(labels),
        }
