"""Runs of the benchmark's cells on the CPU at a tiny size: the tiny
configuration (M3AE's widths at depth 2, 32 px images, 40 entities), each
traffic mix cut to that size, the cell's own metrics and limits."""

from __future__ import annotations

import copy
import json
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

TINY = {
    "fusion-epoch-cached": dict(fusion=dict(batch_size=4, sample_size=2), profile_after=2,
                                profiled_steps=2),
    "serve-rounds": dict(entity_batch=16, relation_batch=4, query_chunk=8, profile_after=1,
                         reference_block=16),
    "gan-epochs": dict(zsl=dict(G_batch_size=8, loss_every=4), profile_after=2,
                       profiled_epochs=2),
}


def load(name: str) -> dict:
    with open(name) as f:
        return json.load(f)


def files(cell: str):
    """(manifest, entry, configuration, traffic, limits) of ``cell`` with
    the tiny configuration and the traffic cut to it."""
    from portbench import run

    manifest, entry, _, traffic, limits = run.cell_files(cell, ROOT)
    traffic = copy.deepcopy(traffic)
    for k, v in TINY[entry["traffic"]].items():
        if isinstance(v, dict):
            traffic[k].update(v)
        else:
            traffic[k] = v
    return manifest, entry, load(os.path.join(HERE, "tiny.json")), traffic, limits


def measure(cell: str, seed: int = 11, seconds: float = 1.0, trace: bool = False) -> dict:
    from portbench import run

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    return run.measure(cell, seed, seconds, trace, device="cpu", files=files(cell))
