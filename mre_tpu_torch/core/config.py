"""Lightweight config objects (copy of mre_tpu/core/config.py).

A plain dict subclass with attribute access and a ``defaults + updates``
constructor, plus the transformer size presets of the reference's
model-type table (reference: module/utils.py:126-192) and the port's
LFM2-MoE encoder presets (``models/lfm2.py``), which the JAX package does
not have.
"""

from __future__ import annotations

import json
from typing import Any, Mapping


class Config(dict):
    """Dict with attribute access and a `defaults + updates` constructor."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def make(cls, defaults: Mapping[str, Any], updates: Mapping[str, Any] | None = None) -> "Config":
        cfg = cls(defaults)
        if updates:
            unknown = set(updates) - set(defaults)
            if unknown:
                raise KeyError(f"unknown config keys: {sorted(unknown)}")
            cfg.update(updates)
        return cfg

    def replace(self, **updates: Any) -> "Config":
        new = Config(self)
        new.update(updates)
        return new

    def to_json(self) -> str:
        return json.dumps(self, sort_keys=True, default=str)


TRANSFORMER_PRESETS: dict[str, dict[str, int]] = {
    "small": dict(emb_dim=384, dec_emb_dim=512, depth=12, dec_depth=8, num_heads=6, dec_num_heads=16, mlp_ratio=4),
    "small_modif": dict(emb_dim=384, dec_emb_dim=512, depth=12, dec_depth=2, num_heads=6, dec_num_heads=16, mlp_ratio=4),
    "base": dict(emb_dim=768, dec_emb_dim=512, depth=12, dec_depth=8, num_heads=12, dec_num_heads=16, mlp_ratio=4),
    "large": dict(emb_dim=1024, dec_emb_dim=512, depth=24, dec_depth=8, num_heads=16, dec_num_heads=16, mlp_ratio=4),
    "huge": dict(emb_dim=1280, dec_emb_dim=512, depth=32, dec_depth=8, num_heads=16, dec_num_heads=16, mlp_ratio=4),
    "debug": dict(emb_dim=1024, dec_emb_dim=512, depth=2, dec_depth=2, num_heads=16, dec_num_heads=16, mlp_ratio=4),
    "tiny": dict(emb_dim=384, dec_emb_dim=512, depth=2, dec_depth=2, num_heads=6, dec_num_heads=16, mlp_ratio=4),
    "tiny4": dict(emb_dim=384, dec_emb_dim=512, depth=4, dec_depth=4, num_heads=6, dec_num_heads=16, mlp_ratio=4),
}


_LFM2_8B_A1B_LAYERS = ("conv", "conv", "full_attention") + ("conv", "conv", "conv", "full_attention") * 4 \
    + ("conv", "conv", "full_attention", "conv", "conv")

# LFM2-MoE as the multimodal encoder: ``encoder="lfm2"`` puts ``models/lfm2.py``'s
# stack in place of the ViT encoder, over M3AE's token layout, pooled at each
# row's last valid position. The widths are the published config's
# (huggingface.co/LiquidAI/LFM2-8B-A1B, config.json, model_type lfm2_moe); the
# decoder keys are M3AE's, for the training heads, which this encoder does not
# train. ``lfm2-tiny`` is the CPU tests' size.
ENCODER_PRESETS: dict[str, dict] = {
    "lfm2-8b-a1b": dict(
        encoder="lfm2", emb_dim=2048, num_heads=32, num_kv_heads=8,
        layer_types=_LFM2_8B_A1B_LAYERS, num_dense_layers=2, intermediate_size=7168,
        moe_intermediate_size=1792, num_experts=32, num_experts_per_tok=4,
        norm_topk_prob=True, routed_scaling_factor=1.0, use_expert_bias=True,
        conv_L_cache=3, rope_theta=1e6, norm_eps=1e-5,
        dec_emb_dim=512, dec_depth=8, dec_num_heads=16, mlp_ratio=4),
    "lfm2-tiny": dict(
        encoder="lfm2", emb_dim=128, num_heads=4, num_kv_heads=2,
        layer_types=("conv", "conv", "full_attention", "conv", "conv", "conv"),
        num_dense_layers=2, intermediate_size=256, moe_intermediate_size=64, num_experts=8,
        num_experts_per_tok=4, norm_topk_prob=True, routed_scaling_factor=1.0,
        use_expert_bias=True, conv_L_cache=3, rope_theta=1e6, norm_eps=1e-5,
        dec_emb_dim=64, dec_depth=1, dec_num_heads=2, mlp_ratio=4),
}


def transformer_preset(model_type: str) -> Config:
    if model_type in ENCODER_PRESETS:
        return Config(ENCODER_PRESETS[model_type])
    if model_type not in TRANSFORMER_PRESETS:
        raise ValueError(f"Unsupported model type: {model_type!r}")
    return Config(TRANSFORMER_PRESETS[model_type])
