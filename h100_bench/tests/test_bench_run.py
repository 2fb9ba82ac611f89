"""``run.py`` refuses to measure where it cannot: no card, or a checkout
without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from h100_bench import spec

RUN = os.path.join(spec.HERE, "run.py")
ARGS = ["--workload", "partnet-xyz.serve", "--seed", str(2 ** 31 + 9),
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, os.path.join(cwd, "h100_bench",
                                                        "run.py"), *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    assert "memory_peak_bytes" not in proc.stdout


def test_without_a_card_it_fails_and_reports_nothing():
    proc = _run(spec.ROOT)
    _no_result(proc)
    assert "CUDA device" in proc.stderr


def test_with_only_the_benchmark_it_fails(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("_out", "_cache",
                                                  "__pycache__"))
    _no_result(_run(str(tmp_path)))
