"""Segment sums that give the same bits on every run.

``index_add_`` on a CUDA tensor adds with atomics, so the order of the
additions into one row, and the last bits of its sum, change from run to
run, and a training run amplifies them: two runs of one seed on a card
ended with different trained modules. JAX's ``segment_sum`` gives the same
bits on every run. On a CUDA tensor ``segment_sum`` therefore adds through
the accumulating ``index_put``, which sorts the rows by segment and sums
each segment in that fixed order; on the CPU ``index_add`` is already
sequential.
"""

from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, segments: torch.Tensor, n: int) -> torch.Tensor:
    """[n, ...]: row s sums the rows of ``values`` whose ``segments`` entry
    is s (int64 ids in [0, n)). Differentiable in ``values``."""
    out = values.new_zeros((n, *values.shape[1:]))
    if values.is_cuda:
        return out.index_put((segments,), values, accumulate=True)
    return out.index_add(0, segments, values)
