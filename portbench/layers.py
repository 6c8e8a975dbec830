"""The arithmetic the metric readers share: each reader in ``metrics/``
applies one of these to a run, and returns None where the run has nothing
to read (no trace, no span, no attention call), so that the metric is
left out of the line rather than reported as 0."""

from __future__ import annotations

import statistics

from portbench import flops, trace

from portbench.trace import ATTENTION_BWD, GENERATE  # noqa: F401  (the readers import them here)


def span_mean(run, name: str, scale: float = 1.0):
    d = run.spans.durations(name)
    return statistics.fmean(d) * scale if d else None


def span_per_unit(run, name: str, scale: float = 1.0):
    d = run.spans.durations(name)
    return sum(d) / run.window.units * scale if d and run.window.units else None


def busy_share(run, seconds):
    s = run.summary
    if s is None or s.busy_s <= 0 or seconds is None:
        return None
    return s.share(seconds)


def gemm_share(run):
    return None if run.summary is None else busy_share(run, run.summary.matching(trace.GEMM))


def inside_share(run, op: str):
    s = run.summary
    if s is None or s.inside_s.get(op, 0.0) <= 0:
        return None
    return busy_share(run, s.inside_s[op])


def h2d_ms(run):
    s = run.summary
    if s is None or not s.units:
        return None
    t = s.matching(trace.HTOD)
    return t / s.units * 1e3 if t > 0 else None


def idle_share(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def attention_roofline(run):
    """Σ bound over Σ device time launched inside the attention entry, %."""
    from portbench.attention import SPAN

    s = run.summary
    if s is None or not run.attention_calls or s.inside_s.get(SPAN, 0.0) <= 0:
        return None
    bound = sum(flops.attention_bound_s(*c) for c in run.attention_calls)
    return 100.0 * bound / s.inside_s[SPAN]


def mfu(run):
    """Model FLOPs of the units completed in the traced part over its time
    at the configuration's type's peak, %."""
    s = run.summary
    if s is None or s.window_s <= 0 or not s.units:
        return None
    peak = flops.PEAK_FLOPS[run.ctx.config["dtype"]]
    return 100.0 * run.window.flops_per_unit * s.units / (s.window_s * peak)
