"""Experiment config: the JAX package's key schema, without ml_collections.

Same keys and default values as ``closerlook3d_tpu/utils/config.py`` so
the same YAML experiment files name the same experiments. The config is a
small attribute dict (``Config``) so the package needs no
``ml_collections``, and the experiment files are read by ``read_yaml``, a
reader of the YAML subset that ``configs/`` uses, so it needs no PyYAML
either: each scalar is typed as PyYAML's ``safe_load`` types it (YAML 1.1:
``1e-4`` is a string, ``1.0e-4`` a float, ``yes`` is True), and a construct
outside the subset raises instead of being misread.
"""

from __future__ import annotations

import copy
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple


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
        _merge(cfg, read_yaml(path) or {})
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


def parse_overrides(tokens: Sequence[str]) -> Dict[str, Any]:
    """Dotted ``key=value`` tokens -> {key: value}, each value typed as
    ``yaml.safe_load`` types it (ints, floats, bools, null, flow lists),
    as the JAX package's ``cli/train.py::parse_overrides`` does."""
    out = {}
    for tok in tokens:
        if "=" not in tok:
            raise SystemExit(f"override must be key=value, got: {tok}")
        k, v = tok.split("=", 1)
        out[k] = loads_yaml(v)
    return out


# ---- a YAML reader for the subset that configs/ uses ---------------------
#
# Block mappings and block sequences by indentation, flow sequences
# ([1, [2, 3]], []), plain, single- and double-quoted scalars (no escapes)
# and # comments. Anchors, aliases, tags, flow mappings, block scalars,
# multi-line scalars, complex keys, documents markers and timestamps raise.

class YAMLSubsetError(ValueError):
    """Text outside the YAML subset that ``read_yaml`` reads."""


# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOLS = {w: v for v, words in ((True, "yes true on"), (False, "no false off"))
          for w0 in words.split()
          for w in (w0, w0.capitalize(), w0.upper())}
_NULLS = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
# dates and timestamps (PyYAML makes datetime objects of them), merge
# keys and the value key: not in the subset
_UNSUPPORTED = re.compile(r"^(?:[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<|=)")
_INDICATORS = tuple("[]{},#&*!|>'\"%@`")


def _sexagesimal(value: str, num):
    total = 0
    for part in value.split(":"):
        total = total * 60 + num(part)
    return total


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    value = value.lstrip("+-")
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    value = value.lstrip("+-")
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _plain(text: str, flow: bool = False):
    """A plain scalar, typed as ``yaml.safe_load`` types it."""
    if (text.startswith(_INDICATORS) or text[:2] in ("- ", "? ", ": ")
            or text in ("-", "?", ":") or ": " in text or text.endswith(":")
            or (flow and any(c in text for c in ",[]{}"))):
        raise YAMLSubsetError(f"not a plain scalar: {text!r}")
    if _UNSUPPORTED.match(text):
        raise YAMLSubsetError(f"timestamp or special key: {text!r}")
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    return text


def _quoted_end(text: str, i: int) -> int:
    """Index just past the quoted scalar that starts at ``text[i]``."""
    q = text[i]
    j = i + 1
    while j < len(text):
        if text[j] == q:
            if q == "'" and text[j + 1:j + 2] == "'":
                j += 2
                continue
            return j + 1
        if q == '"' and text[j] == "\\":
            raise YAMLSubsetError(f"escape in a quoted scalar: {text!r}")
        j += 1
    raise YAMLSubsetError(f"unterminated quoted scalar: {text!r}")


def _quoted(text: str) -> str:
    body = text[1:-1]
    return body.replace("''", "'") if text[0] == "'" else body


def _strip_comment(line: str) -> str:
    """The line without its # comment (a # at the start or after a blank,
    outside quotes)."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[,:-"):
            i = _quoted_end(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _flow_item(text: str, i: int) -> Tuple[Any, int]:
    """(value, index after it) of the flow node starting at text[i]."""
    if text[i] == "[":
        items: List[Any] = []
        i += 1
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i >= len(text):
                raise YAMLSubsetError(f"unterminated flow sequence: {text!r}")
            if text[i] == "]":
                return items, i + 1
            item, i = _flow_item(text, i)
            items.append(item)
            while i < len(text) and text[i] == " ":
                i += 1
            if text[i:i + 1] == ",":
                i += 1
            elif text[i:i + 1] != "]":
                raise YAMLSubsetError(f"bad flow sequence: {text!r}")
    if text[i] in "'\"":
        end = _quoted_end(text, i)
        return _quoted(text[i:end]), end
    end = i
    while end < len(text) and text[end] not in ",]":
        end += 1
    item = text[i:end].strip()
    if not item:
        raise YAMLSubsetError(f"empty flow sequence item: {text!r}")
    return _plain(item, flow=True), end


def _value(text: str):
    """An inline node: a flow sequence, a quoted or a plain scalar."""
    if text.startswith(("[", "'", '"')):
        value, end = _flow_item(text, 0)
        if text[end:].strip():
            raise YAMLSubsetError(f"text after a node: {text!r}")
        return value
    return _plain(text)


def _split_key(content: str) -> Optional[Tuple[Any, str]]:
    """(key, value text) of a block mapping entry, or None."""
    if content.startswith(("'", '"')):
        end = _quoted_end(content, 0)
        rest = content[end:]
        if rest == ":" or rest.startswith(": "):
            return _quoted(content[:end]), rest[1:].strip()
        return None
    for i, c in enumerate(content):
        if c == ":" and (i + 1 == len(content) or content[i + 1] == " "):
            key = content[:i].rstrip()
            if key.startswith(("[", "{", "? ")) or key == "?":
                raise YAMLSubsetError(f"complex key: {content!r}")
            return _plain(key), content[i + 1:].strip()
    return None


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        if raw.startswith(("---", "...", "%")):
            raise YAMLSubsetError(f"document marker or directive: {raw!r}")
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise YAMLSubsetError(f"tab in indentation: {raw!r}")
        content = _strip_comment(body)
        if content:
            out.append((len(raw) - len(body), content))
    return out


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _node(lines, i: int, indent: int) -> Tuple[Any, int]:
    """(node, next line) of the block node whose lines start at
    ``lines[i]``, indented by ``indent``."""
    content = lines[i][1]
    if _is_item(content):
        return _sequence(lines, i, indent)
    if _split_key(content) is not None:
        return _mapping(lines, i, indent)
    value = _value(content)
    if i + 1 < len(lines) and lines[i + 1][0] >= indent:
        raise YAMLSubsetError(f"multi-line scalar at: {content!r}")
    return value, i + 1


def _sequence(lines, i: int, indent: int) -> Tuple[list, int]:
    items = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        text = lines[i][1][1:].strip()
        if not text or _is_item(text) or _split_key(text) is not None:
            raise YAMLSubsetError(f"nested node in a block sequence item: "
                                  f"{lines[i][1]!r}")
        items.append(_value(text))
        i += 1
        if i < len(lines) and lines[i][0] > indent:
            raise YAMLSubsetError(f"multi-line sequence item: "
                                  f"{lines[i][1]!r}")
    return items, i


def _mapping(lines, i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        entry = _split_key(lines[i][1])
        if entry is None:
            raise YAMLSubsetError(f"expected 'key: value': {lines[i][1]!r}")
        key, text = entry
        i += 1
        if text:
            out[key] = _value(text)
            if i < len(lines) and lines[i][0] > indent:
                raise YAMLSubsetError(f"multi-line value of {key!r}")
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _node(lines, i, lines[i][0])
        elif (i < len(lines) and lines[i][0] == indent
              and _is_item(lines[i][1])):
            out[key], i = _sequence(lines, i, indent)
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise YAMLSubsetError(f"bad indentation: {lines[i][1]!r}")
    return out, i


def loads_yaml(text: str):
    """``yaml.safe_load(text)`` for the subset above; raises
    ``YAMLSubsetError`` on anything outside it."""
    lines = _lines(text)
    if not lines:
        return None
    node, i = _node(lines, 0, lines[0][0])
    if i < len(lines):
        raise YAMLSubsetError(f"unexpected line: {lines[i][1]!r}")
    return node


def read_yaml(path: str):
    """The YAML file at ``path``, as ``yaml.safe_load`` reads it (within
    the subset above)."""
    with open(path) as f:
        return loads_yaml(f.read())


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
