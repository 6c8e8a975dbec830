"""Profiling hooks (port of mre_tpu/core/profiling.py): the program's spans,
its counters, and the Chrome-trace exporter.

``span(name)`` marks a layer boundary, and ``spanned(name)`` puts one
around every call of the function it decorates; ``count(name, n)`` adds
to a counter. The program has five: ``h2d.bytes``, the bytes handed to
the host→device copies of ``FusionTrainer._put`` and ``ZSLModule._put``;
``zsl.generate.rows`` and ``zsl.generate.encoded``, the rows asked of
``FusionTrainer.generate`` and the distinct ones its text pass encoded;
``moe.routed`` and ``moe.max_expert_rows``, the LFM2 encoder's token-expert
assignments and its largest expert's rows, summed over its MoE layers'
calls (``models/lfm2.py``, beside its spans ``lfm2.conv``, ``lfm2.attn``,
``lfm2.moe`` ⊃ ``moe.route``, ``moe.experts``).

* Tracing is off by default. A span then costs one check and returns a
  shared no-op context: no clock is read and no ``record_function`` is
  entered.
* Between ``enable()`` and ``disable()`` (process-wide: every thread sees
  the same state) a span reads ``time.perf_counter_ns`` at its ends and
  adds its duration to an aggregate keyed by (name, enclosing span on the
  same thread or None, thread id): a count and a total in ns, constant in
  size. ``count`` adds to its counter. ``snapshot()`` copies both,
  ``reset()`` clears them.
* While tracing is on, or while a ``torch.profiler`` session records, a
  span also enters ``torch.profiler.record_function(name)``, so the spans
  of the thread the session profiles land in its trace on the trace's own
  clock. The profiler drops annotations from threads it does not profile
  unless the session profiles all threads, as ``trace`` does.

``trace(log_dir)`` records a ``torch.profiler`` trace (CPU activity on
every thread, and the card's kernels and copies when CUDA is available)
with tracing on, and writes it as a Chrome trace
(``trace_<pid>_<time>.pt.trace.json``) into ``log_dir``: open it in
Perfetto or ``chrome://tracing``, or in TensorBoard's profiler plugin.
Beside it, ``trace_<pid>_<time>.spans.json`` holds ``snapshot()`` of the
traced part: each span's count and host time per (name, enclosing span,
thread), and the counters.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_on = False
_lock = threading.Lock()
_spans: dict = {}        # (name, parent, thread id) → [count, total ns]
_counts: dict = {}       # name → total
_local = threading.local()
_OFF = contextlib.nullcontext()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    with _lock:
        _spans.clear()
        _counts.clear()


def snapshot() -> dict:
    """``{"spans": {(name, parent, thread id): (count, total ns)},
    "counts": {name: total}}``, a copy."""
    with _lock:
        return {"spans": {k: tuple(v) for k, v in _spans.items()}, "counts": dict(_counts)}


def count(name: str, n: int) -> None:
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


class _Span:
    __slots__ = ("name", "rf", "key", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = None
        if _on:
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            self.key = (self.name, stack[-1] if stack else None, threading.get_ident())
            stack.append(self.name)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.t0 is not None:
            ns = time.perf_counter_ns() - self.t0
            _local.stack.pop()
            with _lock:
                agg = _spans.get(self.key)
                if agg is None:
                    _spans[self.key] = [1, ns]
                else:
                    agg[0] += 1
                    agg[1] += ns
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's work (see the module's doc)."""
    if _on or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def spanned(name: str):
    """Decorator: ``span(name)`` around each call, checked per call."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _on or _autograd_profiler._is_profiler_enabled:
                with _Span(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


def _write_snapshot(path: str) -> None:
    snap = snapshot()
    spans = [{"name": name, "parent": parent, "thread": thread, "count": n, "total_ns": ns}
             for (name, parent, thread), (n, ns) in sorted(snap["spans"].items(), key=str)]
    with open(path, "w") as f:
        json.dump({"spans": spans, "counts": snap["counts"]}, f, indent=1)


@contextlib.contextmanager
def trace(log_dir: str):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    enable()
    try:
        with profile(activities=activities,
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            yield prof
    finally:
        disable()
    stem = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}")
    prof.export_chrome_trace(stem + ".pt.trace.json")
    _write_snapshot(stem + ".spans.json")
