"""Device time launched inside the program's lfm2.moe spans (routing, the
experts, the combine) over busy time, % (device trace)."""

from portbench.layers import inside_share


def read(run):
    return inside_share(run, "lfm2.moe")
