"""The GAN window on the CPU: whole log windows of ``loss_every`` epochs, a
host-clock reading at each block's end, the window's end at the first
block past its time, the two readings of the epoch time, and the host's
load in the run's notes."""

from __future__ import annotations

import statistics

import pytest

from portbench import harness, run
from portbench.jobs import gan
from portbench.tests import helpers


class _Run:
    def __init__(self, window):
        self.window = window


def test_epoch_time_reader_on_a_hand_made_window():
    blocks = [0.060, 0.062, 0.200, 0.061]            # one block held up by a stall
    w = harness.Window(units=200, seconds=50 * sum(blocks), unit_s=blocks, setup_s=1.0,
                       flops_per_unit=1.0)
    # the whole window's time over its epochs: the stall counts
    assert run.reader("gan_epoch_ms")(_Run(w)) == pytest.approx(1e3 * sum(blocks) / 4)


class _Loop:
    """What ``train_gan`` does with its batches: D_epoch then G_epoch draws
    an epoch, the log's sync after every ``loss_every`` epochs."""

    def __init__(self, loss_every, d_epoch=1, g_epoch=2):
        self.cfg = type("C", (), dict(loss_every=loss_every, D_epoch=d_epoch, G_epoch=g_epoch))
        self.events = []

    def _padded_gan_batch(self):
        self.events.append("batch")

    def train_gan(self, epochs):
        for epoch in range(epochs):
            for _ in range(self.cfg.D_epoch + self.cfg.G_epoch):
                self._padded_gan_batch()
            if (epoch + 1) % self.cfg.loss_every == 0:
                self.events.append("sync")


def test_blocks_are_stamped_just_after_each_log_sync():
    loop = _Loop(loss_every=3)
    gan.stamp_blocks(loop, 3, loop.events)          # each stamp lands among the events
    loop.train_gan(9)
    marks = [i for i, e in enumerate(loop.events) if isinstance(e, tuple)]
    assert len(marks) == 2
    for i in marks:
        assert loop.events[i - 1] == "sync" and loop.events[i + 1] == "batch"


def test_window_ends_at_the_first_block_past_its_time():
    loop, stamps = _Loop(loss_every=3), []
    gan.stamp_blocks(loop, 3, stamps, lambda now: len(stamps) == 2)
    with pytest.raises(gan._Stop):
        loop.train_gan(30)
    # two whole blocks and their syncs; no batch of the third is drawn
    assert len(stamps) == 2 and loop.events.count("sync") == 2
    assert loop.events[-1] == "sync" and loop.events.count("batch") == 2 * 3 * 3


@pytest.fixture(scope="module")
def tiny_gan():
    return helpers.measure("small-gan", seed=2 ** 31 + 29)


def test_tiny_run_holds_whole_blocks_to_its_time(tiny_gan):
    block = helpers.files("small-gan")[3]["zsl"]["loss_every"]
    notes, seconds = tiny_gan["notes"], 1.0
    blocks = [b * block for b in notes["unit_s"]]
    assert tiny_gan["attempted"] == block * len(blocks)
    # the window ends at the first block's end past its time, well before the
    # call's epoch count, which the median checked epoch sets
    assert sum(blocks[:-1]) < seconds <= sum(blocks)
    assert tiny_gan["attempted"] < 4 * seconds / (notes["checked_epoch_ms"] / 1e3)
    assert notes["epoch_ms_block_median"] == pytest.approx(
        statistics.median(notes["unit_s"]) * 1e3)
    assert tiny_gan["metrics"]["gan_epoch_ms"]["value"] == pytest.approx(
        1e3 * sum(blocks) / tiny_gan["attempted"])


def test_tiny_run_notes_the_host_load(tiny_gan):
    notes = tiny_gan["notes"]
    for key in ("cpu_over_wall", "nivcsw", "loadavg", "cpus", "torch_threads", "checked_epoch_ms", "epoch_ms_window",
                "epoch_ms_block_median", "block_cpu_over_wall"):
        assert key in notes, key
    assert notes["cpu_over_wall"] > 0 and notes["nivcsw"] >= 0 and len(notes["loadavg"]) == 2
    assert notes["cpus"] >= 1 and notes["torch_threads"] >= 1
    assert len(notes["block_cpu_over_wall"]) == len(notes["unit_s"])
    assert tiny_gan["correct"], tiny_gan["checks"]
