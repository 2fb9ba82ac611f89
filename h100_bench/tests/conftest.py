"""Tests of the benchmark: ``python3 -m pytest h100_bench/tests`` from the
checkout's root. Tests marked ``cuda`` need a card and skip without one;
on a card, ``python3 -m pytest h100_bench/tests -m cuda`` runs them."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where this machine has no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def small(cell, precision="f32", clouds=8, points=512):
    """The cell at a size a CPU test holds: every key of the
    configuration as published but the points, the stage sizes, the
    neighbourhood sizes and the width; the traffic cut to match."""
    c = cell.config["config"]
    c.update({"num_points": points,
              "npoints": [points, points // 4, points // 16, points // 32,
                          points // 64],
              "nsamples": [8, 9, 10, 11, 4], "width": 12, "depth": 1,
              "num_parts": [3, 4, 2], "radius": 0.2,
              "precision": precision})
    cell.traffic.update({"clouds": clouds, "points": points, "pool": 4,
                         "trace_units": 2})
    if "check_from" in cell.traffic:
        cell.traffic["check_from"] = 4
    return cell
