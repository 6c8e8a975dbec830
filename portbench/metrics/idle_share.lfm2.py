"""Share of the traced serving round with no device event, % (device trace)."""

from portbench.layers import idle_share


def read(run):
    return idle_share(run)
