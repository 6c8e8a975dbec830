"""Profiling hooks (port of mre_tpu/core/profiling.py).

``trace(log_dir)`` records a ``torch.profiler`` trace (CPU activity, and the
card's kernels and copies when CUDA is available) and writes it as a Chrome
trace (``trace_<pid>_<time>.pt.trace.json``) into ``log_dir``: open it in
Perfetto or ``chrome://tracing``, or in TensorBoard's profiler plugin.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


class StepTimer:
    """Wall-clock per-step timing; ``stop(result)`` first waits for the
    card(s) holding ``result`` (a tensor or a dict / list of them)."""

    def __init__(self):
        self._t0 = None
        self.last_ms = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            for dev in _cuda_devices(result, set()):
                torch.cuda.synchronize(dev)
        self.last_ms = (time.perf_counter() - self._t0) * 1e3
        return self.last_ms
