"""Dataset factory (``closerlook3d_tpu/data/build.py``): ``cfg.datasets``
-> a dataset, with the config fix-ups the model builders read
(``num_classes``, ``num_parts``, ``task``). Each dataset module is
imported when its name is asked for.
"""

from __future__ import annotations


def build_dataset(cfg, split: str):
    """The dataset ``cfg.datasets`` names, for ``split``; sets the config's
    task and its class or part counts as the dataset has them."""
    name = cfg.datasets
    if name == "modelnet40":
        from closerlook3d_tpu_torch.data.modelnet40 import ModelNet40
        cfg.num_classes = 40
        cfg.task = "classification"
        return ModelNet40(cfg, split)
    if name == "shapenetpart":
        from closerlook3d_tpu_torch.data.shapenetpart import (
            NUM_PARTS, ShapeNetPart)
        cfg.num_parts = list(NUM_PARTS)
        cfg.task = "part_segmentation"
        return ShapeNetPart(cfg, split)
    if name == "partnet":
        from closerlook3d_tpu_torch.data.partnet import PartNet
        ds = PartNet(cfg, split, level=cfg.partnet_level)
        cfg.num_parts = list(ds.num_parts)
        cfg.task = "part_segmentation"
        return ds
    if name == "s3dis":
        from closerlook3d_tpu_torch.data.s3dis import S3DIS
        cfg.num_classes = 13
        cfg.task = "scene_segmentation"
        return S3DIS(cfg, split)
    if name == "synthetic":
        from closerlook3d_tpu_torch.data.synthetic import (
            SyntheticClassification)
        cfg.task = "classification"
        cfg.num_classes = min(cfg.num_classes, 8)
        n = int(getattr(cfg, "synthetic_train_size", 512)
                if split == "train"
                else getattr(cfg, "synthetic_val_size", 128))
        return SyntheticClassification(
            n, cfg.num_points, cfg.num_classes,
            noise=float(getattr(cfg, "synthetic_noise", 0.01)),
            seed=cfg.rng_seed + (0 if split == "train" else 1),
            augment=split == "train")
    if name == "synthetic_partseg":
        from closerlook3d_tpu_torch.data.synthetic import (
            SyntheticPartSegmentation)
        ds = SyntheticPartSegmentation(
            256 if split == "train" else 64, cfg.num_points,
            seed=cfg.rng_seed + (0 if split == "train" else 1),
            label_noise=float(getattr(cfg, "synthetic_label_noise", 0.0)))
        cfg.num_parts = list(ds.num_parts)
        cfg.task = "part_segmentation"
        return ds
    if name == "synthetic_scene":
        from closerlook3d_tpu_torch.data.synthetic import (
            SyntheticSceneSegmentation)
        ds = SyntheticSceneSegmentation(
            256 if split == "train" else 64, cfg.num_points,
            seed=cfg.rng_seed + (0 if split == "train" else 1))
        cfg.num_classes = ds.num_classes
        cfg.task = "scene_segmentation"
        return ds
    raise ValueError(f"unknown dataset: {name}")
