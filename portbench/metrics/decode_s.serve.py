"""Host time inside MultimodalStore.generate_batch per round, s (benchmark
span)."""

from portbench.layers import span_per_unit


def read(run):
    return span_per_unit(run, 'decode')
