"""The attention forward's bound from its calls' shapes over the device time
launched inside its entry, % (device trace)."""

from portbench.layers import attention_roofline


def read(run):
    return attention_roofline(run)
