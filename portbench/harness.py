"""What every job shares: the run's context, the benchmark's own spans
around calls into the program's layers, the window's record, and the
comparison numbers with their limits.

A span records its host interval (``time.perf_counter``) and, when the run
is traced, a ``record_function`` annotation of the same name, so the
device trace can say which span the host was in during each idle gap.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import sys
import time

import numpy as np

from portbench import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "mre_tpu")   # top-level module names, compared whole


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


class Spans:
    """Host intervals by name; with ``annotate`` each is also a profiler
    annotation."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.intervals: dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        cm = contextlib.nullcontext()
        if self.annotate:
            import torch

            cm = torch.profiler.record_function(f"portbench.{name}")
        t0 = time.perf_counter()
        with cm:
            try:
                yield
            finally:
                self.intervals.setdefault(name, []).append((t0, time.perf_counter()))

    def wrap(self, owner, attr: str, name: str | None = None):
        """Replace ``owner.attr`` (a bound method) by itself inside a span."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with self.span(name or attr):
                return fn(*a, **k)

        setattr(owner, attr, wrapped)

    def durations(self, name: str) -> list:
        return [e - s for s, e in self.intervals.get(name, [])]


def capture(owner, attr: str, log: list, keep=lambda args, kwargs, out: out):
    """Wrap ``owner.attr`` so that each call appends ``keep(args, kwargs,
    result)`` to ``log``; returns a function that restores the original."""
    fn = getattr(owner, attr)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        log.append(keep(a, k, out))
        return out

    setattr(owner, attr, wrapped)
    return lambda: owner.__dict__.pop(attr, None)


@dataclasses.dataclass
class Context:
    """One run: the cell's configuration and traffic, the flags, the
    device, the spans and the profiled part of the window."""
    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    work_dir: str = ""
    reference: dict | None = None   # the float32 reference's outputs, once computed

    def __post_init__(self):
        self.spans = Spans(self.trace)
        self.profile = tracing.Profile(self.device) if self.trace else None

    def sync(self):
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()


@dataclasses.dataclass
class Window:
    """What a job's measured window hands back."""
    units: int                      # steps, rounds or epochs completed
    seconds: float                  # host time of the whole window
    unit_s: list                    # each unit's time, or each block's per unit (may be empty)
    setup_s: float
    flops_per_unit: float           # model FLOPs of one unit (flops.py)
    peak: int = 0                   # device memory peak before the check, bytes
    notes: dict = dataclasses.field(default_factory=dict)  # the job's notes on it (host_load)


def host_mark() -> tuple:
    """The host clock, this process's CPU time and involuntary context
    switches, and the load average, now."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), r.ru_utime + r.ru_stime, r.ru_nivcsw, os.getloadavg()[0]


def host_load(start: tuple, end: tuple) -> dict:
    """How busy the host was between two ``host_mark``s: the process's CPU
    time over the wall time (all its threads), its involuntary context
    switches, the one-minute load average at both ends, and the CPUs and
    torch threads the process may use. It describes the run; no metric
    reads it."""
    import torch

    wall = end[0] - start[0]
    return dict(cpu_over_wall=(end[1] - start[1]) / wall if wall > 0 else None,
                nivcsw=end[2] - start[2], loadavg=[start[3], end[3]],
                cpus=len(os.sched_getaffinity(0)), torch_threads=torch.get_num_threads())


def with_tf32(enabled: bool):
    """A context with float32 matrix products (and cuDNN) in TF32 or not."""
    import torch

    @contextlib.contextmanager
    def cm():
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    return cm()


def checks_from(numbers: dict, limits: dict) -> list:
    """(name, value, limit) of each compared number; a number without a
    limit is a fault of the benchmark, not of the run."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return [(k, float(numbers[k]), float(limits[k])) for k in numbers]


def correct(checks: list) -> bool:
    return all(np.isfinite(v) and v <= lim for _, v, lim in checks)


def work_dir() -> str:
    """A fresh directory under TMPDIR for the run's generated dataset."""
    import tempfile

    return tempfile.mkdtemp(prefix="portbench-")
