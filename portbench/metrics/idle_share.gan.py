"""Share of the traced part with no device event, % (device trace)."""

from portbench.layers import idle_share


def read(run):
    return idle_share(run)
