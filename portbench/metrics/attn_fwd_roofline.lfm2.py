"""The grouped causal attention's bound from its calls' shapes
(flops_lfm2.gqa_bound_s) over the device time launched inside the
benchmark's annotation of its entry, % (device trace)."""

from portbench.flops_lfm2 import gqa_bound_s
from portbench.jobs.serve_lfm2 import GQA_SPAN


def read(run):
    s, calls = run.summary, getattr(run.ctx, "gqa_calls", None)
    if s is None or not calls or s.inside_s.get(GQA_SPAN, 0.0) <= 0:
        return None
    return 100.0 * sum(gqa_bound_s(*c) for c in calls) / s.inside_s[GQA_SPAN]
