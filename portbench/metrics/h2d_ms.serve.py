"""Device time of host-to-device copies per unit in the traced part, ms (device
trace)."""

from portbench.layers import h2d_ms


def read(run):
    return h2d_ms(run)
