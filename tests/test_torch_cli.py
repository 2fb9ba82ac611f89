"""The port's command-line entry points and config reading on the CPU.

Ports of ``tests/test_cli.py`` (train, then evaluate, argv in and metrics
out, with ``--device cpu``) and of ``tests/test_datasets.py``'s two
``check_data`` tests, on the fixture trees that file writes. The port
reads the YAML configs without PyYAML: ``read_yaml`` must equal
``yaml.safe_load`` on every file under ``configs/`` and on a table of
YAML 1.1 scalars, and raise on what lies outside its subset;
``parse_overrides`` must equal the JAX package's on a table of tokens.
Without a card, the entry points raise unless the CPU is asked for.
cli.export's artifact of a checkpoint trained by cli.train serves the
logits of the model cli.evaluate restores.
"""

import glob
import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

from closerlook3d_tpu.cli.train import parse_overrides as jparse_overrides
from closerlook3d_tpu.utils.config import load_config as jload_config
from closerlook3d_tpu_torch.cli.evaluate import main as eval_main
from closerlook3d_tpu_torch.cli.train import main as train_main
from closerlook3d_tpu_torch.data.check import check_data
from closerlook3d_tpu_torch.data.s3dis import prepare_rooms
from closerlook3d_tpu_torch.train.loop import Trainer
from closerlook3d_tpu_torch.utils.config import (
    YAMLSubsetError, load_config, loads_yaml, parse_overrides, read_yaml)
from tests.test_cli import OVERRIDES
from tests.test_datasets import (
    _write_modelnet40, _write_partnet, _write_s3dis_raw, _write_shapenetpart)
from test_torch_ops import _one_aten_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                           recursive=True))


# ---- tests/test_cli.py ------------------------------------------------------

def test_cli_train_then_evaluate(tmp_path, capsys):
    log_dir = str(tmp_path / "run")
    train_main(["--log_dir", log_dir, "--device", "cpu"] + OVERRIDES)
    assert os.path.isdir(os.path.join(log_dir, "ckpt"))

    eval_main(["--log_dir", str(tmp_path / "eval"), "--device", "cpu",
               "--load_path", os.path.join(log_dir, "ckpt")] + OVERRIDES)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    results = json.loads(out)
    # 2 epochs on an easy 4-class task: clearly above the 0.25 chance
    assert results["accuracy"] > 0.5, results

    with pytest.raises(SystemExit, match="no checkpoint"):
        eval_main(["--device", "cpu", "--log_dir", str(tmp_path / "e2"),
                   "--load_path", str(tmp_path / "empty")] + OVERRIDES)


def test_cli_override_parsing():
    out = parse_overrides(["epochs=3", "nsamples=[8, 8]",
                           "pospool.reduction=max", "use_pallas=never"])
    assert out == {"epochs": 3, "nsamples": [8, 8],
                   "pospool.reduction": "max", "use_pallas": "never"}
    with pytest.raises(SystemExit, match="key=value"):
        parse_overrides(["epochs"])


def test_entry_points_need_the_card_or_the_cpu_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    cfg = load_config(overrides=parse_overrides(OVERRIDES))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, str(tmp_path / "t"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--log_dir", str(tmp_path / "run")] + OVERRIDES)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_main(["--log_dir", str(tmp_path / "e"),
                   "--load_path", str(tmp_path / "run")] + OVERRIDES)
    # nothing was built or written before the refusal
    assert not os.path.exists(tmp_path / "run")


def test_cli_export_serves_the_restored_model(tmp_path, capsys):
    """cli.train on the CPU, then cli.export of its checkpoint: the loaded
    artifact's logits equal to the bit those of the model that cli.evaluate
    restores from the same checkpoint."""
    from closerlook3d_tpu_torch.cli.export import main as export_main
    from closerlook3d_tpu_torch.data.build import build_dataset
    from closerlook3d_tpu_torch.data.loader import BatchIterator
    from closerlook3d_tpu_torch.models.build import build_model_and_loss
    from closerlook3d_tpu_torch.serving import load_forward
    from closerlook3d_tpu_torch.train.checkpoints import CheckpointManager
    from closerlook3d_tpu_torch.train.schedules import make_optimizer
    from closerlook3d_tpu_torch.train.state import create_train_state
    from closerlook3d_tpu_torch.train.step import eval_logits

    log_dir = str(tmp_path / "run")
    ckpt = os.path.join(log_dir, "ckpt")
    out = str(tmp_path / "artifact")
    train_main(["--log_dir", log_dir, "--device", "cpu"] + OVERRIDES)
    export_main(["--load_path", ckpt, "--out", out, "--device", "cpu"]
                + OVERRIDES)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    cfg = load_config(overrides=parse_overrides(OVERRIDES))
    model, _ = build_model_and_loss(cfg)
    state = create_train_state(model, make_optimizer(cfg, 1)[0], "cpu")
    state, _, step = CheckpointManager(ckpt).restore(state)
    assert line == f"exported checkpoint @ step {step} -> {out}"
    predictor, meta = load_forward(out, device="cpu")
    assert meta["platforms"] == ["cpu"]
    assert (meta["batch_size"], meta["num_points"]) == (8, 64)
    it = BatchIterator(build_dataset(cfg, "test"), cfg.batch_size,
                       shuffle=False, feature_spec=cfg.input_features,
                       drop_last=False, spatial_sort=True)
    batch = next(iter(it))
    got = predictor(batch["xyz"], batch["mask"], batch["features"])
    np.testing.assert_array_equal(got.numpy(),
                                  eval_logits(state, batch).numpy())


def test_cli_export_needs_the_card_or_the_cpu_asked_for(tmp_path):
    from closerlook3d_tpu_torch.cli.export import main as export_main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_main(["--load_path", str(tmp_path / "ckpt"), "--out",
                     str(tmp_path / "artifact")] + OVERRIDES)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_main(["--load_path", str(tmp_path / "ckpt"), "--out",
                     str(tmp_path / "artifact"), "--device", "cuda"]
                    + OVERRIDES)
    assert not os.path.exists(tmp_path / "artifact")


# ---- parse_overrides and read_yaml against the JAX package and PyYAML -------

TOKENS = [
    "epochs=3", "nsamples=[8, 8]", "npoints=[]", "pospool.reduction=max",
    "use_pallas=never", "base_learning_rate=0.05", "weight_decay=1e-4",
    "weight_decay=1.0e-4", "lr=1E+3", "x=.5", "x=-2", "x=+7", "x=010",
    "x=0x1F", "x=1_000", "x=1:30", "precision=f32", "donate_state=false",
    "vote_eval=True", "flag=yes", "flag=Off", "x=null", "x=~", "x=",
    "x=.inf", "x=-.Inf", "name='quoted # text'", 'name="double"',
    "input_features=ones,rgb,height", "dims=[32, 16]", "l=[a, 'b c', 2.5]",
    "nested=[[1, 2], [3]]", "x=a=b", "path=/data/x.txt", "x=it's",
]


@pytest.mark.parametrize("token", TOKENS)
def test_parse_overrides_matches_jax(token):
    ours, ref = parse_overrides([token]), jparse_overrides([token])
    assert repr(ours) == repr(ref)


def test_parse_overrides_nan_matches_jax():
    ours = parse_overrides(["x=.NaN"])["x"]
    assert math.isnan(ours) and math.isnan(jparse_overrides(["x=.NaN"])["x"])


@pytest.mark.parametrize(
    "path", CONFIGS, ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_read_yaml_equals_safe_load(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert repr(read_yaml(path)) == repr(ref)
    # and the config built from it equals the JAX package's
    assert load_config(path).to_dict() == jload_config(path).to_dict()


def test_configs_are_all_read():
    assert len(CONFIGS) == 21


YAML_TEXTS = [
    "a: 1\nb:\n  c: [1, 2]\n  d: x  # comment\ne:\n- 1\n- 2.5\n",
    "# only a comment\n", "", "a:\n  - x\n  - 'y'\n", "a: 'it''s'\n",
    "a: http://host:80/x\n", "- 1\n- two\n", "a: b c  d\n", "a:\nb: 2\n",
    "1: one\nyes: y\n", "a: [1, 2,]\n", "a: 5e3\nb: 5.0e+3\nc: 1.\n",
]


@pytest.mark.parametrize("text", YAML_TEXTS)
def test_loads_yaml_equals_safe_load(text):
    assert repr(loads_yaml(text)) == repr(yaml.safe_load(text))


OUTSIDE = [
    "a: &x 1\n", "a: *x\n", "a: !!int 1\n", "a: {b: 1}\n", "a: |\n  x\n",
    "a: >\n  x\n", "---\na: 1\n", "a: 2001-12-14\n", "<<: {}\n",
    "a: b: c\n", "a:\n  - b: 1\n", "a:\n  -\n    - 1\n", "a: x\n  y\n",
    "\ta: 1\n", 'a: "x\\n"\n', "? a\n: b\n", "a: [1,,2]\n", "a: [1\n",
    "a: 'x\n", "a: %x\n", "a: @x\n", "a:\n    b: 1\n  c: 2\n", "[a: 1]\n",
]


@pytest.mark.parametrize("text", OUTSIDE)
def test_loads_yaml_raises_outside_its_subset(text):
    with pytest.raises(YAMLSubsetError):
        loads_yaml(text)


# ---- tests/test_datasets.py's check_data tests --------------------------------

def test_check_data_reports(tmp_path):
    """--check_data: good fixtures pass; broken trees fail with
    actionable messages."""
    cfg = load_config()
    cfg.data_root = str(tmp_path / "nothing_here")

    # synthetic: always fine, nothing on disk
    cfg.datasets = "synthetic"
    assert not check_data(cfg).has_errors

    # missing roots: every real dataset errors with the expected path
    for name in ("modelnet40", "shapenetpart", "partnet", "s3dis"):
        cfg.datasets = name
        rep = check_data(cfg)
        assert rep.has_errors
        assert str(cfg.data_root) in rep.render()

    # good fixtures: warnings (tiny split sizes) but no errors
    root = tmp_path / "good"
    _write_modelnet40(str(root))
    _write_shapenetpart(str(root))
    _write_partnet(str(root), 3, ["Chair"], [4])
    _write_s3dis_raw(str(root), np.random.default_rng(5))
    cfg.data_root = str(root)
    for name in ("modelnet40", "shapenetpart", "partnet", "s3dis"):
        cfg.datasets = name
        rep = check_data(cfg)
        assert not rep.has_errors, (name, rep.render())

    # S3DIS processed cache is checked in preference to the raw tree
    prepare_rooms(str(root), cell=0.08)
    cfg.first_subsampling_dl = 0.08
    cfg.datasets = "s3dis"
    rep = check_data(cfg)
    assert not rep.has_errors and "processed cache" in rep.render()
    # wrong test area → error naming the config knob
    cfg.s3dis_test_area = 4
    rep = check_data(cfg)
    assert rep.has_errors and "s3dis_test_area" in rep.render()
    cfg.s3dis_test_area = 5

    # a listed-but-missing shape file is an error that names the file
    base = os.path.join(root, "modelnet40_normal_resampled", "airplane",
                        "airplane_0001")
    for ext in (".txt", ".npy"):
        if os.path.exists(base + ext):
            os.remove(base + ext)
    cfg.datasets = "modelnet40"
    rep = check_data(cfg)
    assert rep.has_errors and "airplane_0001" in rep.render()

    # corrupt split json → parse error, not a crash
    jf = os.path.join(
        root, "shapenetcore_partanno_segmentation_benchmark_v0_normal",
        "train_test_split", "shuffled_train_file_list.json")
    with open(jf, "w") as f:
        f.write("{not json")
    cfg.datasets = "shapenetpart"
    rep = check_data(cfg)
    assert rep.has_errors and "unparseable" in rep.render()


def test_check_data_cli(tmp_path):
    """`--check_data` exits 0 on a valid tree, 1 on errors."""
    root = tmp_path / "d"
    _write_modelnet40(str(root))
    with pytest.raises(SystemExit) as e:
        train_main(["--check_data", f"data_root={root}",
                    "datasets=modelnet40"])
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        train_main(["--check_data", f"data_root={tmp_path}/absent",
                    "datasets=modelnet40"])
    assert e.value.code == 1
