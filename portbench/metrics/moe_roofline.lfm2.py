"""The experts' FLOPs in the traced round, from shapes (every token's
num_experts_per_tok expert passes in every MoE layer, flops_lfm2.round_assignments
× flops_lfm2.expert_flops), at the type's tensor-core peak over the device time
launched inside the program's moe.experts spans, % (device trace)."""

from portbench.flops import PEAK_FLOPS
from portbench.flops_lfm2 import expert_flops, round_assignments


def read(run):
    s = run.summary
    if s is None:
        return None
    t = s.inside_s.get("moe.experts", 0.0)
    if t <= 0:
        return None
    cfg = run.ctx.config
    return 100.0 * round_assignments(cfg) * expert_flops(cfg) / PEAK_FLOPS[cfg["dtype"]] / t
