"""Host time of prepare_device_batch in the producer thread per call, ms
(benchmark span)."""

from portbench.layers import span_mean


def read(run):
    return span_mean(run, 'host_batch', 1e3)
