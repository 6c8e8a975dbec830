"""Model FLOPs of the traced round (flops_lfm2.serve_round) over its time at
the type's tensor-core peak, % (device trace)."""

from portbench.layers import mfu


def read(run):
    return mfu(run)
