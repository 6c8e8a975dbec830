"""Faults planted in the program's LFM2 encoder for the ``lfm2-serve``
cell, each a context manager as in ``faults.py``: the routing by softmax,
the selection without the expert bias, the weights from the biased scores,
and a convolution that sees the next position.

    python3 -m portbench.lfm2_faults --workload lfm2-serve --seeds <n> --fault <name>

reads one on the card at the cell's size through ``readings.py``, with
these faults beside ``faults.FAULTS``.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from portbench import faults, readings


def _route(make_scores, select_on_biased: bool = True, weigh_biased: bool = False):
    from mre_tpu_torch.models.lfm2 import SparseMoE

    def make(inner):
        def route(self, x):
            scores = make_scores(F.linear(x, self.gate.weight))
            biased = scores + self.expert_bias
            chosen = self.select(biased if select_on_biased else scores)
            w = (biased if weigh_biased else scores).gather(1, chosen)
            return chosen, w / w.sum(-1, keepdim=True)
        return route

    return faults._patched(SparseMoE, "route", make)


def softmax_routing():
    """Scores by softmax over the experts in place of the sigmoid."""
    return _route(lambda logits: torch.softmax(logits, -1))


def unbiased_selection():
    """The experts chosen by the scores without the expert bias."""
    return _route(torch.sigmoid, select_on_biased=False)


def biased_weights():
    """The chosen experts weighted by their biased scores."""
    return _route(torch.sigmoid, weigh_biased=True)


def noncausal_conv():
    """The short convolution's taps shifted one position on: each position
    reads the one after it in place of the one two back."""
    from mre_tpu_torch.models.lfm2 import ShortConv

    def make(inner):
        def forward(self, x):
            return inner(self, torch.cat([x[:, 1:], x[:, -1:]], 1))
        return forward

    return faults._patched(ShortConv, "forward", make)


FAULTS = {f.__name__: f for f in (softmax_routing, unbiased_selection, biased_weights,
                                  noncausal_conv)}


def main(argv=None) -> int:
    faults.FAULTS.update(FAULTS)
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
