"""The device trace of the profiled part of a window, reduced to what the
per-layer metrics read.

``torch.profiler`` (CUPTI) records the CPU ops, the benchmark's span
annotations and every device event (kernels, copies, sets). The reduction
reads the profiler's raw events in one pass:

* busy time is the UNION of the device events' intervals, so a copy that
  overlaps a kernel counts once (a sum of durations would count it twice);
* a device event belongs to the CPU op that launched it (correlation id),
  and so to every named op or span on that op's thread whose interval holds
  the launching op's start: the device time "inside" a span;
* idle gaps are the parts of the profiled window with no device event,
  each named by the innermost benchmark span the main thread was in at the
  gap's middle.

The arithmetic follows ``device_times`` of the repository's chip smoke
script, with the busy time taken as a union.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import re
import time

GEMM = re.compile(r"gemm|gemv|splitKreduce|nvjet", re.IGNORECASE)
HTOD = re.compile(r"Memcpy HtoD", re.IGNORECASE)
WINDOW = "portbench.profiled"
# the attention's autograd backward node, and the program's span around the generator
ATTENTION_BWD = "autograd::engine::evaluate_function: FusedAttentionBackward"
GENERATE = "zsl.generate"


def union_length(intervals) -> tuple[float, list]:
    """(total length, merged intervals) of (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


@dataclasses.dataclass
class Summary:
    window_s: float                       # host time of the profiled part
    busy_s: float                         # union of device intervals
    device_by_name: dict                  # kernel name → seconds (sum of durations)
    inside_s: dict                        # op or span name → device seconds launched inside it
    gaps: list                            # (span name, seconds) of each idle gap
    units: int = 0                        # units completed inside the profiled part

    def share(self, seconds: float) -> float:
        """Percent of the busy time."""
        return 100.0 * seconds / self.busy_s if self.busy_s > 0 else float("nan")

    def matching(self, rx) -> float:
        return sum(s for k, s in self.device_by_name.items() if rx.search(k))


def reduce_events(events, ops: tuple, window_s: float) -> Summary:
    """``events``: the profiler's ``kineto_results.events()``. ``ops``: the
    names whose inside device time is wanted."""
    from torch.autograd import DeviceType

    dev, launched, frontend = [], [], {}
    annotated: dict = {}
    spans = {op: {} for op in ops}
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            ns = e.duration_ns()
            if ns <= 0 or e.is_user_annotation() or name.startswith("Activity Buffer"):
                continue
            dev.append((e.start_ns(), e.start_ns() + ns, name))
            launched.append((e.linked_correlation_id(), ns))
        elif e.linked_correlation_id() == 0:
            frontend[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
            if name in spans:
                spans[name].setdefault(e.start_thread_id(), []).append((e.start_ns(), e.end_ns()))
            if name.startswith("portbench."):
                annotated.setdefault(name, []).append((e.start_ns(), e.end_ns(),
                                                        e.start_thread_id()))
    for per_thread in spans.values():
        for iv in per_thread.values():
            iv.sort()
    inside = dict.fromkeys(ops, 0)
    for corr, ns in launched:
        if corr not in frontend:
            continue
        thread, t = frontend[corr]
        for op, per_thread in spans.items():
            iv = per_thread.get(thread)
            if iv:
                i = bisect.bisect_right(iv, (t, math.inf)) - 1
                if i >= 0 and iv[i][1] >= t:
                    inside[op] += ns
    by_name: dict = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    busy_ns, merged = union_length([(s, e) for s, e, _ in dev])

    win = annotated.get(WINDOW)
    gaps = []
    if win:
        w0, w1, thread = win[0]
        host = [(s, e, n) for n, ivs in annotated.items() if n != WINDOW
                for s, e, t in ivs if t == thread]
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            mid = (a + b) / 2
            holding = [(e - s, n) for s, e, n in host if s <= mid <= e]
            label = min(holding)[1][len("portbench."):] if holding else "outside_spans"
            gaps.append((label, (b - a) / 1e9))
    return Summary(window_s=window_s, busy_s=busy_ns / 1e9,
                   device_by_name={k: v / 1e9 for k, v in by_name.items()},
                   inside_s={k: v / 1e9 for k, v in inside.items()}, gaps=gaps)


class Profile:
    """The profiled part of a window: ``start()`` and ``stop()`` may be
    called from a job's hooks; each waits for the device first, so the
    profiled part holds exactly the work launched inside it."""

    OPS = (ATTENTION_BWD, GENERATE, "portbench.attn_fwd")

    def __init__(self, device: str):
        self.device = device
        self.prof = None
        self.done = False
        self._t0 = None
        self._window = None
        self._raw = None
        self._summary: Summary | None = None

    def _sync(self):
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device != "cpu" else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, units: int):
        """Ends the profiled part; its events are reduced once read, after
        the window, so the reduction stalls no step of it."""
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self._raw = (self.prof.profiler.kineto_results, window_s, units)
        self.prof = None
        self.done = True

    @property
    def summary(self) -> Summary | None:
        if self._summary is None and self._raw is not None:
            results, window_s, units = self._raw
            self._summary = reduce_events(results.events(), self.OPS, window_s)
            self._summary.units = units
            self._raw = None
        return self._summary

    def breakdown(self) -> dict:
        s = self.summary
        ops = sorted(s.device_by_name.items(), key=lambda kv: -kv[1])[:10]
        idle: dict = {}
        for name, sec in s.gaps:
            idle[name] = idle.get(name, 0.0) + sec
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}
