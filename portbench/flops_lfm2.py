"""Model FLOPs of the ``lfm2-8b-a1b`` configuration's serving round, and the
bounds its per-layer metrics divide by, from shapes alone; the terms
outside the encoder are ``flops.py``'s, with its conventions (2 per
multiply-add, elementwise work, norms, softmax and the routing's top-k not
counted, the same peaks).

Per token of one sequence of ``n``, an LFM2 layer counts its projections
(conv: W_in 3d wide and W_out; attention: q, k, v at ``num_key_value_heads``
and the output), its FFN (the dense SwiGLU's three matrices, or the router
and ``num_experts_per_tok`` experts' three), and attention's two products
over the causal triangle, n(n+1)/2 query-key pairs.
"""

from __future__ import annotations

from portbench import flops
from portbench.flops import BYTES, PEAK_BYTES, PEAK_FLOPS, linear


def expert_flops(cfg: dict) -> float:
    """One token's pass through one expert (its three matrices)."""
    return 3 * linear(1, cfg["hidden_size"], cfg["moe_intermediate_size"])


def round_assignments(cfg: dict) -> int:
    """The token-expert assignments of one serving round, from shapes: every
    token of the entity sweep (``n_ent`` × (1 + image + text tokens)), of the
    relation sweep and of each unseen relation's description pass (× (1 +
    description tokens)), as the model has the rows (not the rows that pad a
    sweep's last batch), ``num_experts_per_tok`` each in every MoE layer."""
    tokens = (cfg["n_ent"] * (1 + flops.image_tokens(cfg) + cfg["text_tokens"])
              + (cfg["n_rel"] + cfg["n_unseen"]) * (1 + cfg["description_tokens"]))
    moe_layers = len(cfg["layer_types"]) - cfg["num_dense_layers"]
    return tokens * cfg["num_experts_per_tok"] * moe_layers


def encoder(cfg: dict, rows: int, n: int) -> float:
    """The LFM2 stack over ``rows`` sequences of ``n`` tokens."""
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    t = rows * n
    total = 0.0
    for i, kind in enumerate(cfg["layer_types"]):
        if kind == "conv":
            total += linear(t, d, 3 * d) + linear(t, d, d)
        else:
            total += (linear(t, d, h * hd) + 2 * linear(t, d, hkv * hd) + linear(t, h * hd, d)
                      + 2 * 2.0 * rows * h * hd * n * (n + 1) / 2)
        if i < cfg["num_dense_layers"]:
            total += 3 * linear(t, d, cfg["intermediate_size"])
        else:
            total += linear(t, d, cfg["num_experts"]) + t * cfg["num_experts_per_tok"] * \
                expert_flops(cfg)
    return total


def serve_round(cfg: dict, n_queries: int, n_candidates: int) -> float:
    """``flops.serve_round`` with the LFM2 stack in place of M3AE's encoder:
    the entity sweep with its patch embedding, the RGCN, the relation sweep,
    each unseen relation's description pass and generator head, and the
    Extractor over every ranked pair; rows as the model has them."""
    L, T, D = flops.image_tokens(cfg), cfg["text_tokens"], cfg["description_tokens"]
    d, p3, g = cfg["hidden_size"], cfg["patch_size"] ** 2 * 3, cfg["gcn_dim"]
    head = dict(cfg, emb_dim=d)
    return (encoder(cfg, cfg["n_ent"], 1 + L + T) + linear(cfg["n_ent"] * L, p3, d)
            + flops.rgcn(cfg["n_ent"], d, g, cfg["num_bases"])
            + encoder(cfg, cfg["n_rel"], 1 + D)
            + cfg["n_unseen"] * (encoder(cfg, 1, 1 + D)
                                 + flops.generator_head(head, cfg["test_sample"]))
            + n_queries * n_candidates * 2 * linear(1, g, 2 * g))


def gqa_bound_s(b: int, h: int, h_kv: int, n: int, hd: int, dtype: str, causal: bool) -> float:
    """The least time of one grouped attention forward: its two products over
    the causal triangle (all n² pairs when not causal) at the type's peak, or
    Q and O at ``h`` heads and K and V at ``h_kv`` read or written once at
    HBM bandwidth, whichever is larger."""
    pairs = n * (n + 1) / 2 if causal else n * n
    ops = 2 * 2.0 * b * h * pairs * hd
    nbytes = (2 * b * h * n * hd + 2 * b * h_kv * n * hd) * BYTES[dtype]
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
