"""The control of ``correct`` on the card, at the tiny size: for each cell
the reference put in the program's place and run in TF32, the precision
below the configurations' float32, must fail one of the cell's limits,
while the program passes all of them. The readings at each cell's own
size come from ``python3 -m portbench.readings`` (PERF.md gives them).

Run on the card: ``python3 -m pytest portbench/tests/test_control.py -m cuda``."""

from __future__ import annotations

import pytest
import torch

from portbench.tests import helpers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("small-train-cached", "huge-serve", "small-gan"))
def test_tf32_control_fails_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control needs a card: TF32 exists only there")
    from portbench import readings

    r = readings.readings(cell, 4000000101, 0.5, device="cuda", files=helpers.files(cell))
    lim = r["limits"]
    assert all(v <= lim[k] for k, v in r["program"].items()), r
    assert any(v > lim[k] for k, v in r["control"].items()), r
