"""On a card, at each cell's own size: the program's numbers hold their
limits, and the control's (the reference computed in float8 in the
program's place) and, for a train cell, the program stepping on half of
each batch break one. ``python3 -m pytest h100_bench/tests -m cuda``."""

import pytest

from h100_bench import calibrate, check, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_holds_and_control_breaks(card, cell):
    c = spec.Cell(BENCH, cell)
    r = calibrate.reading(c, 2 ** 31 + 2718, 4.0, control=True)
    assert check.judge(r["numbers"], c.limits)[0], r
    assert not check.judge(r["control"], c.limits)[0], r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith(".train")])
def test_half_batch_breaks(card, cell):
    c = spec.Cell(BENCH, cell)
    r = calibrate.reading(c, 2 ** 31 + 1618, 4.0, control=False, fault=True)
    assert not check.judge(r["numbers"], c.limits)[0], r
