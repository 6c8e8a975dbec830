"""Host time of ZSLModule.evaluate per round, s (benchmark span)."""

from portbench.layers import span_mean


def read(run):
    return span_mean(run, 'evaluate')
