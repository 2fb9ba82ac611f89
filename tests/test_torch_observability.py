"""The port's logging and profiling on the CPU (ports of
``tests/test_observability.py``'s tests of the JAX package's
``utils/{tb,profiling}.py`` and the ``Trainer``'s scalar stream).

``ScalarWriter`` writes the JAX package's ``scalars.jsonl`` record, field
for field; the ``Trainer`` writes it on ``configs/synthetic/smoke_cls.yaml``
(read without PyYAML); ``timeit`` and ``cost_analysis`` return the JAX
helpers' keys; ``trace`` writes a Chrome trace, also through the
``Trainer``'s ``profile_steps``; the logger writes the JAX format to
``log.txt``.
"""

import json
import logging
import os

import numpy as np
import torch

from closerlook3d_tpu.utils.tb import ScalarWriter as JScalarWriter
from closerlook3d_tpu_torch.train.loop import Trainer
from closerlook3d_tpu_torch.utils.config import load_config
from closerlook3d_tpu_torch.utils.logger import setup_logger
from closerlook3d_tpu_torch.utils.profiling import (
    cost_analysis, timeit, trace)
from closerlook3d_tpu_torch.utils.tb import ScalarWriter
from test_torch_ops import _one_aten_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f.read().splitlines()]


def _write(writer_cls, logdir):
    w = writer_cls(str(logdir))
    w.scalars({"loss": 1.5, "acc": np.float32(0.5)}, step=10,
              prefix="train/")
    w.scalar("val/miou", 0.25, step=np.int64(20))
    w.close()
    w.scalar("val/after_close", 1.0, step=21)  # dropped, no error
    return _records(os.path.join(str(logdir), "scalars.jsonl"))


def test_scalar_writer_jsonl_matches_jax(tmp_path):
    ours, ref = _write(ScalarWriter, tmp_path / "port"), \
        _write(JScalarWriter, tmp_path / "jax")
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref]
    for a, b in zip(ours, ref):
        assert sorted(a) == ["step", "tag", "ts", "value"]
        for k in ("tag", "value", "step"):
            assert a[k] == b[k] and type(a[k]) is type(b[k]), (k, a, b)
        assert isinstance(a["ts"], float)
    assert [r["tag"] for r in ours] == ["train/loss", "train/acc",
                                       "val/miou"]
    ScalarWriter(None).scalar("x", 1.0, 0)  # no logdir: writes nothing


def test_trainer_writes_scalars(tmp_path):
    """Smoke-train one epoch and check scalars.jsonl appears."""
    cfg = load_config(os.path.join(REPO, "configs/synthetic/smoke_cls.yaml"))
    cfg.epochs = 1
    cfg.log_interval = 2
    # the file's widths and points; fewer clouds than its 512 + 128 (the
    # port's plain CPU step at 16 x 1024 points takes ~2.5 s)
    cfg.synthetic_train_size = 80
    cfg.synthetic_val_size = 32
    trainer = Trainer(cfg, str(tmp_path), device="cpu")
    trainer.fit()
    assert os.path.exists(tmp_path / "scalars.jsonl")
    lines = _records(tmp_path / "scalars.jsonl")
    tags = {ln["tag"] for ln in lines}
    assert "train/loss" in tags and "val/acc" in tags
    # every log_interval steps and at the epoch's end: 80 / 16 = 5 steps
    steps = [ln["step"] for ln in lines if ln["tag"] == "train/loss"]
    assert steps == [2, 4, 5]
    assert all(np.isfinite(ln["value"]) for ln in lines)


def test_timeit_and_cost_analysis():
    def f(x):
        return (x @ x).sum()

    x = torch.ones((64, 64))
    stats = timeit(f, x, iters=3, warmup=1)
    assert sorted(stats) == ["best_ms", "iters", "mean_ms"]
    assert stats["mean_ms"] > 0 and stats["best_ms"] <= stats["mean_ms"]
    assert stats["iters"] == 3
    costs = cost_analysis(f, x)
    assert costs == {"flops": 2 * 64 ** 3}


def test_trace_writes_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(32, 32) @ torch.ones(32, 32)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trainer_profile_steps(tmp_path):
    from tests.test_torch_engine import tiny_cfg

    cfg = tiny_cfg(epochs=1, profile_steps=2, synthetic_train_size=32,
                   val_interval=10**9, log_interval=10**9)
    t = Trainer(cfg, str(tmp_path), device="cpu")
    t.fit()
    assert os.path.exists(tmp_path / "profile" / "trace.json")
    # the profiled steps train too, as in the JAX package
    assert t.state.step == 4 + 2


def test_logger_writes_log_txt(tmp_path):
    logger = setup_logger(str(tmp_path / "a"), name="cl3d_test_logger")
    logger.info("first %d", 1)
    logger = setup_logger(str(tmp_path / "b"), name="cl3d_test_logger")
    logger.info("second")
    for h in logger.handlers:
        h.flush()
    a = (tmp_path / "a" / "log.txt").read_text()
    b = (tmp_path / "b" / "log.txt").read_text()
    assert "INFO first 1" in a and "second" not in a
    assert "INFO second" in b and b.startswith("[")
    assert sum(isinstance(h, logging.FileHandler)
               for h in logger.handlers) == 1
