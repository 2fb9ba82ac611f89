"""Experiment config: the JAX package's key schema, without ml_collections.

Same keys and default values as ``closerlook3d_tpu/utils/config.py`` so
the same YAML experiment files name the same experiments. The config is a
small attribute dict (``Config``) so the package needs neither
``ml_collections`` nor, unless a YAML path is given, ``yaml``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional


class Config(dict):
    """dict with attribute access; nested dicts become ``Config`` too."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        self[key] = value

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, Config) else copy.deepcopy(v)
                for k, v in self.items()}


def default_config() -> Config:
    """Framework defaults (the JAX package's ``default_config``)."""
    c = Config()

    # ---- data ----------------------------------------------------------
    c.datasets = "modelnet40"
    c.data_root = "data"
    c.num_points = 1024
    c.num_classes = 40
    c.num_parts = []
    c.input_features_dim = 3
    c.input_features = "xyz"
    c.synthetic_noise = 0.01
    c.synthetic_label_noise = 0.0
    c.synthetic_train_size = 512
    c.synthetic_val_size = 128
    c.batch_size = 32
    c.num_workers = 0
    c.task = "classification"

    c.in_radius = 2.0
    c.first_subsampling_dl = 0.04
    c.num_steps = 2000
    c.num_votes = 20
    c.vote_eval = False
    c.s3dis_test_area = 5
    c.partnet_level = 3

    c.augment_rotation = "z"
    c.augment_scale_min = 0.8
    c.augment_scale_max = 1.2
    c.augment_symmetries = []
    c.augment_noise = 0.001
    c.augment_shift = 0.0
    c.color_drop = 0.2
    c.x_angle_range = 0.0
    c.y_angle_range = 0.0
    c.z_angle_range = 0.0

    # ---- backbone ------------------------------------------------------
    c.backbone = "resnet"
    c.width = 144
    c.depth = 2
    c.bottleneck_ratio = 2
    c.radius = 0.05
    c.sampleDl = 0.02
    c.nsamples = [26, 31, 38, 41, 39]
    c.npoints = []
    c.sampling = "fps"
    c.dropout_rate = 0.5
    c.cls_head_dims = [512, 256]

    # ---- local aggregation ---------------------------------------------
    c.local_aggregation_type = "pospool"
    c.pospool = Config(position_embedding="xyz", reduction="avg",
                       output_conv=False)
    c.pointwisemlp = Config(feature_type="dp_fi_df", num_mlps=1,
                            reduction="max")
    c.pseudo_grid = Config(fixed_kernel_points="center",
                           KP_influence="linear", KP_extent=1.0,
                           num_kernel_points=15, convolution_mode="sum",
                           output_conv=False)
    c.adaptive_weight = Config(local_input_feature="dp", reduction="avg",
                               shared_channels=1, fc_num=1,
                               weight_softmax=False, output_conv=False)

    # ---- training ------------------------------------------------------
    c.epochs = 600
    c.start_epoch = 1
    c.optimizer = "sgd"
    c.base_learning_rate = 0.01
    c.lr_scheduler = "cosine"
    c.warmup_epoch = 5
    c.lr_decay_steps = 20
    c.lr_decay_rate = 0.7
    c.lr_milestones = []
    c.weight_decay = 0.001
    c.momentum = 0.9
    c.grad_clip = 0.0
    c.label_smoothing = 0.2
    c.batchnorm_momentum = 0.9

    # ---- runtime ---------------------------------------------------------
    c.precision = "bf16"  # bf16|f32 activation/compute dtype
    # Accepted for schema compatibility and ignored: the port picks kernel
    # or plain version by the tensor's device alone (ops/dispatch.py).
    c.use_pallas = "auto"
    # host|never|auto|always: "host", the data pipeline Morton-sorts
    # batches; "always" (and "auto" above 2048 points) sorts in the model,
    # on the device (models/build.py)
    c.spatial_sort = "host"
    c.donate_state = True
    c.data_parallel = -1
    c.model_parallel = 1
    c.rng_seed = 0
    c.log_interval = 50
    c.profile_steps = 0
    c.precompute_geometry = False
    c.val_interval = 1
    c.save_interval = 10
    c.keep_checkpoints = 3

    return c


def _merge(dst: Config, src: Dict[str, Any], path: str = "") -> None:
    for k, v in src.items():
        if k not in dst:
            raise KeyError(f"unknown config key: {path}{k}")
        if isinstance(v, dict):
            _merge(dst[k], v, path=f"{path}{k}.")
        elif (isinstance(v, (int, float)) and isinstance(dst[k], (int, float))
              and type(v) is not type(dst[k])):
            dst[k] = type(dst[k])(v)  # int->float style coercions from YAML
        else:
            dst[k] = v


def load_config(
    path: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> Config:
    """Defaults, then a YAML experiment file, then dotted-path overrides."""
    cfg = default_config()
    if path is not None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        _merge(cfg, data)
    if overrides:
        for key, value in overrides.items():
            node = cfg
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown override key: {key}")
            node[parts[-1]] = value
    return cfg


def stage_plan(cfg: Config) -> Dict[str, list]:
    """Per-stage (npoints, radii, nsamples, widths, cells) plan.

    Stage s has N/4^s points, width w*2^s channels and radius r*2^s.
    """
    nstage = len(cfg.nsamples)
    if list(cfg.npoints):
        npoints = list(cfg.npoints)
    else:
        npoints = [max(cfg.num_points // (4**s), 1) for s in range(nstage)]
    return {
        "npoints": npoints,
        "radii": [cfg.radius * (2**s) for s in range(nstage)],
        "nsamples": list(cfg.nsamples),
        "widths": [cfg.width * (2**s) for s in range(nstage)],
        "cells": [cfg.sampleDl * (2**s) for s in range(nstage)],
    }
