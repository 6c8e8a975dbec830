"""The check fails a broken timed path: each fault a cell can have
(``portbench/faults.py``) is planted in the program underneath a whole run
(on the CPU, the card look skipped), and ``correct`` comes out false. The
cells run on one chip, so no exchange between chips can be left out."""

from __future__ import annotations

import pytest

from portbench import faults
from portbench.tests import helpers

CASES = [("small-train-cached", "state_unchanged", "change_median"),
         ("small-train-cached", "half_batch", "loss1_gap"),
         ("small-train-cached", "half_batch", "grad_gap"),
         ("small-gan", "state_unchanged", "change_median"),
         ("small-gan", "gan_half_batch", "loss1_gap"),
         ("huge-serve", "rank_altered", "rank_slack"),
         ("huge-serve", "embedding_altered", "ent_gap")]


@pytest.mark.parametrize("cell,fault,number", CASES)
def test_fault_makes_the_run_incorrect(cell, fault, number):
    with faults.FAULTS[fault]():
        out = helpers.measure(cell)
    assert not out["correct"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], (number, c)


@pytest.mark.parametrize("cell,number", [("small-train-cached", "change_median"),
                                         ("small-gan", "change_median")])
def test_unchanged_state_reads_about_one(cell, number):
    with faults.state_unchanged():
        out = helpers.measure(cell)
    assert out["checks"][number]["value"] > 0.9
