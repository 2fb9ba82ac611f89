"""The plain reference against the program's plain path on the CPU, in
float32 at a small size: the same neighbours, logits, losses, first
gradients and updated parameters.

Tolerances are float32's: the two sides add in other orders; the
program forms the point-wise MLP's masked BatchNorm variance as
E[h^2] - mean^2, whose cancellation in float32 its gradients carry (1%);
and the parameters' change after three steps at the warmup's learning
rate is a few float32 steps of a weight near 1 (2%)."""

import pytest
import torch

from conftest import small
from h100_bench import core, spec, traffic
from h100_bench.reference import geometry

BENCH = spec.benchmark()
SEED = 2 ** 31 + 4242


def test_neighbours_samples_and_upsampling_are_the_programs():
    from closerlook3d_tpu_torch.models.backbone import compute_geometry

    cell = small(spec.Cell(BENCH, "partnet-xyz.train"), clouds=3, points=512)
    batch = traffic.pool(cell.traffic, cell.ref_config(), SEED, "cpu")[0]
    ref = geometry.compute(cell.ref_config(), batch["xyz"], batch["mask"])
    prog = compute_geometry(core.program_config(cell), batch["xyz"],
                            batch["mask"], need_up=True)
    names = {"idx_s1": "sidx_1", "nmask_s1": "smask_1", "idx_s4": "sidx_4",
             "nmask_2": "nmask_2", "idx_0": "idx_0", "nmask_0": "nmask_0",
             "xyz_1": "xyz_1", "idx_2": "idx_2", "up_0": "up_0",
             "up_3": "up_3"}
    for key, theirs in names.items():
        assert torch.equal(ref[key].to(prog[theirs].dtype), prog[theirs]), key


@pytest.mark.parametrize("cell", ["partnet-xyz.train",
                                  "partnet-pwmlp.train"])
def test_train_steps_match_the_plain_path(cell):
    c = small(spec.Cell(BENCH, cell))
    loop = core.TrainLoop(c, SEED, "cpu")
    loop.setup()
    loop.free()
    got = loop.compare(loop.reference())
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-2
    assert got["change_gap"] < 0.02


@pytest.mark.parametrize("cell", ["partnet-xyz.serve",
                                  "partnet-pwmlp.serve"])
def test_served_logits_match_the_plain_path(cell):
    c = small(spec.Cell(BENCH, cell))
    loop = core.ServeLoop(c, SEED, "cpu")
    loop.setup()
    while len(loop.kept) < len(loop.picks):
        loop.unit()
    loop.free()
    assert loop.compare(loop.reference())["logits_gap"] < 1e-5
