"""Fixed sin-cos positional embeddings (numpy copy of mre_tpu/ops/pos_embed.py).

Reference semantics: module/model.py:113-153. The 2-D variant uses the
square patch grid, xy-indexed meshgrid, h-embedding first.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def _sincos_1d(embed_dim: int, length: int) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    pos = np.arange(length, dtype=np.float64)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


def get_1d_sincos_pos_embed(embed_dim: int, length: int) -> np.ndarray:
    """[1, length, embed_dim]"""
    return _sincos_1d(embed_dim, length)[None]


def _from_grid_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0, f"sincos embed_dim must be even, got {embed_dim}"
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _sincos_2d(embed_dim: int, length: int, patch_size: int) -> np.ndarray:
    grid_w = int(round(length ** 0.5))
    grid_h = grid_w
    assert grid_h * grid_w == length, (length, patch_size)
    gw = np.arange(grid_w, dtype=np.float32)
    gh = np.arange(grid_h, dtype=np.float32)
    grid = np.meshgrid(gw, gh, indexing="xy")          # w first, like reference
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_h, grid_w)
    emb_h = _from_grid_1d(embed_dim // 2, grid[0])
    emb_w = _from_grid_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, length: int, patch_size: int) -> np.ndarray:
    """[1, length, embed_dim]"""
    return _sincos_2d(embed_dim, length, patch_size)[None]
