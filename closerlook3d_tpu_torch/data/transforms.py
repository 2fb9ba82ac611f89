"""Host-side numpy augmentations (``closerlook3d_tpu/data/transforms.py``).

A copy, so the port never imports the JAX package: random rotation
(z-axis, full SO(3) or small euler angles), anisotropic scale with mirror
symmetries, jitter noise, a translation shift, color drop, and
``sample_or_pad`` to a fixed point count. Same arithmetic and the same
draws from the generator, so a seed gives the same arrays in both
packages.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def rotation_matrix(mode: str, rng: np.random.Generator,
                    x_range: float = 0.0, y_range: float = 0.0,
                    z_range: float = 0.0) -> np.ndarray:
    """3x3 rotation. mode: none|z|so3|perturb (small euler angles)."""
    if mode == "none":
        return np.eye(3, dtype=np.float32)
    if mode == "z":
        a = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
    if mode == "so3":
        # uniform over SO(3) via QR of a gaussian matrix
        m = rng.normal(size=(3, 3))
        q, r = np.linalg.qr(m)
        q *= np.sign(np.diag(r))[None, :]
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        return q.astype(np.float32)
    if mode == "perturb":
        ax = rng.uniform(-x_range, x_range)
        ay = rng.uniform(-y_range, y_range)
        az = rng.uniform(-z_range, z_range)
        rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                       [0, np.sin(ax), np.cos(ax)]])
        ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                       [-np.sin(ay), 0, np.cos(ay)]])
        rz = np.array([[np.cos(az), -np.sin(az), 0],
                       [np.sin(az), np.cos(az), 0], [0, 0, 1]])
        return (rz @ ry @ rx).astype(np.float32)
    raise ValueError(mode)


def rotate(points: np.ndarray, rot: np.ndarray,
           normals: Optional[np.ndarray] = None):
    out = points @ rot.T
    if normals is not None:
        return out, normals @ rot.T
    return out, None


def scale_and_jitter(points: np.ndarray, rng: np.random.Generator,
                     scale_min: float = 0.8, scale_max: float = 1.2,
                     symmetries: Sequence[bool] = (),
                     noise: float = 0.001, noise_clip: float = 0.05,
                     shift: float = 0.0) -> np.ndarray:
    scale = rng.uniform(scale_min, scale_max, size=(3,)).astype(np.float32)
    for axis, sym in enumerate(symmetries):
        if sym and rng.random() < 0.5:
            scale[axis] = -scale[axis]
    out = points * scale
    if noise > 0:
        out = out + np.clip(rng.normal(0, noise, size=out.shape),
                            -noise_clip, noise_clip).astype(np.float32)
    if shift > 0:
        out = out + rng.uniform(-shift, shift, size=(3,)).astype(np.float32)
    return out.astype(np.float32)


def color_drop(colors: np.ndarray, rng: np.random.Generator,
               p: float = 0.2) -> np.ndarray:
    """Zero all colors with probability p (whole-cloud, like the reference)."""
    if rng.random() < p:
        return np.zeros_like(colors)
    return colors


def sample_or_pad(arrays: Sequence[np.ndarray], num_points: int,
                  rng: Optional[np.random.Generator]):
    """Fix the point count of parallel per-point arrays.

    Subsample (random if rng given, deterministic stride otherwise) when
    too many; pad **by duplicating existing points** when too few (the
    reference's convention — keeps BN statistics sane). Returns
    (fixed arrays, mask [num_points]).
    """
    n = arrays[0].shape[0]
    if n >= num_points:
        if rng is not None:
            sel = rng.choice(n, num_points, replace=False)
        else:
            sel = np.linspace(0, n - 1, num_points).astype(np.int64)
        mask = np.ones(num_points, dtype=bool)
    else:
        reps = (rng.integers(0, n, size=num_points - n) if rng is not None
                else np.arange(num_points - n) % n)
        sel = np.concatenate([np.arange(n), reps])
        mask = np.zeros(num_points, dtype=bool)
        mask[:n] = True
    return [a[sel] for a in arrays], mask
