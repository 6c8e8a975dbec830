"""The attention forward's entry as the encoder and decoder call it
(``fused_attention`` in the program's ``models/transformer.py``), wrapped
in a traced run: each call inside the profiled part records its shape and
type, and runs inside the ``portbench.attn_fwd`` annotation, so the device
time of whatever runs beneath the entry, kernel or not, is the time
launched inside it."""

from __future__ import annotations

SPAN = "portbench.attn_fwd"


def install(ctx) -> list:
    """Wrap the entry for the rest of the process; returns the list that
    collects (batch, heads, tokens, head_dim, dtype, masked) per call made
    while the profile is active."""
    import torch

    from mre_tpu_torch.models import transformer

    inner = transformer.fused_attention
    calls: list = []

    def fused_attention(q, k, v, padding_mask, scale, impl="auto"):
        if ctx.profile is not None and ctx.profile.active:
            b, h, n, hd = q.shape
            calls.append((b, h, n, hd, str(q.dtype).replace("torch.", ""),
                          padding_mask is not None))
        with torch.profiler.record_function(SPAN):
            return inner(q, k, v, padding_mask, scale, impl)

    transformer.fused_attention = fused_attention
    return calls
