"""Model FLOPs of the traced part's completed units over its time at the type's
tensor-core peak, % (device trace, flops.py)."""

from portbench.layers import mfu


def read(run):
    return mfu(run)
