"""GEMM kernels' device time over the union of device-busy time, % (device
trace)."""

from portbench.layers import gemm_share


def read(run):
    return gemm_share(run)
