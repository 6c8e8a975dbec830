"""Device time launched inside the program's zsl.generate span over busy time,
% (device trace)."""

from portbench.layers import GENERATE, inside_share


def read(run):
    return inside_share(run, GENERATE)
