"""Device time under the attention's autograd backward node over busy time, %
(device trace)."""

from portbench.layers import ATTENTION_BWD, inside_share


def read(run):
    return inside_share(run, ATTENTION_BWD)
