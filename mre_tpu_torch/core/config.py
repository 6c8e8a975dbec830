"""Lightweight config objects (copy of mre_tpu/core/config.py).

A plain dict subclass with attribute access and a ``defaults + updates``
constructor, plus the transformer size presets of the reference's
model-type table (reference: module/utils.py:126-192).
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


def transformer_preset(model_type: str) -> Config:
    if model_type not in TRANSFORMER_PRESETS:
        raise ValueError(f"Unsupported model type: {model_type!r}")
    return Config(TRANSFORMER_PRESETS[model_type])
