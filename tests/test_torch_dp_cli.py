"""The train and evaluate CLIs under torchrun, 2 gloo ranks on the CPU.

``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
closerlook3d_tpu_torch.cli.train --device cpu`` on the tiny config of
``tests/test_cli.py`` (a rendezvous on a free localhost port): 2 epochs,
then a resume to a third, then ``cli.evaluate`` under torchrun. One rank
writes the checkpoints and the scalars, both ranks resume from the same
step and end at the same one with the same best value, and the evaluator
prints the accuracy over both ranks' shards once. Each launch is bounded
by its own time limit; past it the test fails and the job is killed.

The ranks share one output pipe. Each CLI writes its JSON line in one
write: ``print`` writes the text and its newline in two where Python's
output is unbuffered (``PYTHONUNBUFFERED``), and rank 0's log line once
landed between rank 1's JSON and its newline.
"""

import io
import json
import os
import subprocess
import sys

import pytest

from tests.test_cli import OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ["synthetic_train_size=64", "synthetic_val_size=24",
         "val_interval=1", "keep_checkpoints=2"]


def _torchrun(module, args, timeout=150):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", module, "--device", "cpu", *args]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        pytest.fail(f"{module} under torchrun still running after "
                    f"{timeout} s; killed:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-4000:]
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith("{")]


def test_torchrun_train_resume_evaluate(tmp_path):
    run = str(tmp_path / "run")
    first = _torchrun("closerlook3d_tpu_torch.cli.train",
                      ["--log_dir", run] + OVERRIDES + SIZES)
    # 64 clouds over 2 ranks of 8: 4 steps an epoch
    assert sorted(r["rank"] for r in first) == [0, 1]
    assert {(r["world_size"], r["resumed_step"], r["step"])
            for r in first} == {(2, None, 8)}
    assert len({r["best"] for r in first}) == 1
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == [
        "ckpt_4.pt", "ckpt_8.pt"]

    again = _torchrun("closerlook3d_tpu_torch.cli.train",
                      ["--log_dir", run] + OVERRIDES + SIZES + ["epochs=3"])
    assert {(r["resumed_step"], r["step"]) for r in again} == {(8, 12)}
    assert sorted(r["rank"] for r in again) == [0, 1]
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == [
        "ckpt_12.pt", "ckpt_8.pt"]
    rows = [json.loads(ln)
            for ln in open(os.path.join(run, "scalars.jsonl"))]
    keys = [(r["tag"], r["step"]) for r in rows]
    assert len(keys) == len(set(keys)), "two writers"
    assert {r["step"] for r in rows if r["tag"] == "val/acc"} == {4, 8, 12}

    results = _torchrun("closerlook3d_tpu_torch.cli.evaluate",
                        ["--log_dir", str(tmp_path / "eval"), "--load_path",
                         os.path.join(run, "ckpt")] + OVERRIDES + SIZES)
    assert len(results) == 1  # rank 0 prints
    assert 0.0 <= results[0]["accuracy"] <= 1.0
    assert results[0]["num_votes"] == 1


class _Writes(io.StringIO):
    """A text stream that records each write."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def write(self, text):
        self.calls.append(text)
        return super().write(text)


def test_json_line_is_one_write():
    from closerlook3d_tpu_torch.utils.logger import print_json_line

    out = _Writes()
    print_json_line({"accuracy": 0.5, "num_votes": 1}, out)
    assert out.calls == ['{"accuracy": 0.5, "num_votes": 1}\n']


def test_train_cli_writes_its_json_line_whole(monkeypatch, tmp_path):
    """``cli.train``'s last line, with the Trainer replaced by a stub, goes
    out in one write."""
    from closerlook3d_tpu_torch.cli import train
    from closerlook3d_tpu_torch.train import loop

    class _Trainer:
        resumed_step = None

        def __init__(self, cfg, workdir, load_path=None, device=None):
            self.state = type("State", (), {"step": 8})()

        def fit(self):
            return 0.25

    monkeypatch.setattr(loop, "Trainer", _Trainer)
    out = _Writes()
    monkeypatch.setattr(sys, "stdout", out)
    assert train.main(["--device", "cpu", "--log_dir",
                       str(tmp_path)]) == 0.25
    lines = [c for c in out.calls if c.startswith("{")]
    assert [json.loads(c) for c in lines] == [
        {"rank": 0, "world_size": 1, "resumed_step": None, "step": 8,
         "best": 0.25}]
    assert all(c.endswith("\n") for c in lines)
