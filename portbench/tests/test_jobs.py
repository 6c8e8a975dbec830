"""Each job module at a tiny size on the CPU (the plain attention) against
the reference: the run is correct, its numbers sit far inside their
limits, and its metrics are those of the cell."""

from __future__ import annotations

import pytest

from portbench.tests import helpers

CELLS = ("small-train-cached", "huge-serve", "small-gan")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_against_the_reference(cell):
    out = helpers.measure(cell, seed=2 ** 31 + 17)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] < c["limit"] / 10, (name, c)
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_layers(cell):
    out = helpers.measure(cell, seed=5, trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) <= {m["name"] for m in helpers.files(cell)[0]["per_layer"]}
    assert out["device"]["window_s"] > 0
    # the CPU has no device trace: no share of it is reported
    assert not any(k.startswith(("idle_share", "gemm_share", "attn_fwd_roofline"))
                   for k in out["metrics"])


def test_same_seed_same_inputs():
    a = helpers.measure("small-train-cached", seed=99)
    b = helpers.measure("small-train-cached", seed=99)
    assert a["notes"]["losses"] == b["notes"]["losses"]
