"""The traffic generator: a pool is a function of the mix and the seed."""

import numpy as np
import pytest
import torch

from conftest import small
from h100_bench import spec, traffic

BENCH = spec.benchmark()


def _pool(cell, seed):
    return traffic.pool(cell.traffic, cell.ref_config(), seed, "cpu")


@pytest.mark.parametrize("cell", ["partnet-xyz.train", "partnet-xyz.serve"])
def test_same_seed_same_pool_other_seed_other_pool(cell):
    c = small(spec.Cell(BENCH, cell), clouds=3, points=256)
    a, b = _pool(c, 2 ** 31 + 77), _pool(c, 2 ** 31 + 77)
    other = _pool(c, 5)
    for x, y, z in zip(a, b, other):
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k
        assert not np.array_equal(np.asarray(x["xyz"]), np.asarray(z["xyz"]))


def test_batches_differ_and_take_the_loader_form():
    c = small(spec.Cell(BENCH, "partnet-xyz.train"), clouds=4, points=512)
    pool = _pool(c, 123)
    assert len(pool) == c.traffic["pool"]
    parts = c.config["config"]["num_parts"]
    starts = np.concatenate([[0], np.cumsum(parts)[:-1]])
    for i, b in enumerate(pool):
        assert b["xyz"].shape == (4, 512, 3) and b["xyz"].dtype == torch.float32
        assert torch.equal(b["features"], b["xyz"])
        assert b["mask"].all()
        cat = b["category"].long()
        lo = torch.as_tensor(starts)[cat][:, None]
        hi = lo + torch.as_tensor(parts)[cat][:, None]
        assert ((b["labels"] >= lo) & (b["labels"] < hi)).all()
        # scaled into the unit sphere, then by at most 1.2 and jitter
        assert float(b["xyz"].norm(dim=-1).max()) < 1.2 * 1.01 + 0.05
        if i:
            assert not torch.equal(b["xyz"], pool[0]["xyz"])


def test_clouds_come_morton_sorted():
    c = small(spec.Cell(BENCH, "partnet-xyz.train"), clouds=2, points=512)
    xyz = _pool(c, 9)[0]["xyz"]
    order = traffic.morton_order(xyz)
    assert torch.equal(order, torch.arange(512).expand(2, -1))


def test_host_requests_are_numpy():
    c = small(spec.Cell(BENCH, "partnet-pwmlp.serve"), clouds=2, points=256)
    b = _pool(c, 1)[0]
    assert isinstance(b["xyz"], np.ndarray) and b["xyz"].dtype == np.float32
    assert b["mask"].dtype == np.bool_
