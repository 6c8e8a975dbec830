"""Faults planted underneath a whole run, to see that ``correct`` comes out
false: the CPU tests plant each on its cell at the tiny size, and
``python3 -m portbench.readings --fault <name>`` reads one on the card at
the cell's own size. Each is a context manager that patches the program's
classes for the duration of the run and restores them after."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(owner, name: str, make):
    inner = getattr(owner, name)
    setattr(owner, name, make(inner))
    try:
        yield
    finally:
        setattr(owner, name, inner)


def state_unchanged():
    """Every Adam step leaves its parameters as they were."""
    return _patched(torch.optim.Adam, "step", lambda inner: lambda self, closure=None: None)


def half_batch():
    """The fusion step with the second half of its nodes and edges left out
    of every loss mean."""
    from mre_tpu_torch.train.fusion import FusionTrainer

    def make(inner):
        def prepare(self, graph_batch):
            batch = inner(self, graph_batch)
            for k in ("node_mask", "edge_mask"):
                m = batch[k].clone()
                m[len(m) // 2:] = False
                batch[k] = m
            return batch
        return prepare

    return _patched(FusionTrainer, "prepare_device_batch", make)


def gan_half_batch():
    """The critic's and the generator's means taken over the first half of
    each GAN batch only."""
    from mre_tpu_torch.zsl.module import ZSLModule

    def make(inner):
        def weights(self, mask, rows=None):
            mask = np.array(mask, copy=True)
            mask[len(mask) // 2:] = False
            return inner(self, mask, rows)
        return weights

    return _patched(ZSLModule, "_weights", make)


def rank_altered():
    """The first query's rank off by 3 where ``evaluate`` produces it."""
    from mre_tpu_torch.zsl.module import ZSLModule

    def make(inner):
        def evaluate(self, *a, **k):
            res = inner(self, *a, **k)
            res["ranks"] = res["ranks"].copy()
            res["ranks"][0] += 3
            return res
        return evaluate

    return _patched(ZSLModule, "evaluate", make)


def embedding_altered():
    """The first entity's embedding scaled by 1.01 where the sweep
    produces it."""
    from mre_tpu_torch.train.fusion import FusionTrainer

    def make(inner):
        def sweep(self, *a, **k):
            ent = inner(self, *a, **k).clone()
            ent[0] = ent[0] * 1.01
            return ent
        return sweep

    return _patched(FusionTrainer, "generate_ent_embeddings", make)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, gan_half_batch, rank_altered,
                                  embedding_altered)}
