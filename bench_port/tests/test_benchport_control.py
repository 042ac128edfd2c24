"""The control of each configuration, at its cell's own size, on the card:
the precision below the stated one must come out as not correct by the
configuration's limits (the readings tool's control, on one seed)."""

import pytest

from bench_port import readings
from bench_port.harness import cells, compare


@pytest.mark.card
@pytest.mark.parametrize("workload", ["vovnet_serve_b8", "dla34_serve_b8"])
def test_the_control_is_not_correct(card, workload):
    cell = cells.load_cell(workload)
    out = readings.control_reading(cell, 31, 1.0, card)
    assert not compare.within(out, cell.config["limits"])
