"""MAE-style random token masking (port of mre_tpu/ops/masking.py).

Reference semantics (module/model.py:97-111): one shared shuffle per batch
(the same permutation for every example), keep the first ``keep_len``
tokens of the shuffled sequence, and return the restore permutation.

The JAX function draws the permutation from a key; here the caller passes
it (``ids_shuffle`` [L], a permutation of ``range(L)``), so a test can hand
both sides the same one and the trainer draws it from its own generator.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Masking(NamedTuple):
    kept: torch.Tensor                      # [B, keep_len, D] kept tokens
    mask: torch.Tensor                      # [B, L] 1.0 where the token was dropped
    ids_restore: torch.Tensor               # [L] inverse permutation
    padding_mask_kept: torch.Tensor | None  # [B, keep_len] or None


def random_masking(x: torch.Tensor, keep_len: int, ids_shuffle: torch.Tensor,
                   padding_mask: torch.Tensor | None = None) -> Masking:
    batch, length, _ = x.shape
    ids_shuffle = ids_shuffle.to(device=x.device, dtype=torch.int64)
    if ids_shuffle.shape != (length,):
        raise ValueError(f"ids_shuffle must be a permutation of {length} "
                         f"positions, got shape {tuple(ids_shuffle.shape)}")
    ids_restore = torch.argsort(ids_shuffle)
    keep = ids_shuffle[:keep_len]

    mask = torch.ones(batch, length, dtype=torch.float32, device=x.device)
    mask[:, :keep_len] = 0.0
    mask = mask[:, ids_restore]

    pk = None if padding_mask is None else padding_mask[:, keep]
    return Masking(kept=x[:, keep, :], mask=mask, ids_restore=ids_restore,
                   padding_mask_kept=pk)


def restore_with_mask_tokens(kept: torch.Tensor, mask_token: torch.Tensor,
                             ids_restore: torch.Tensor) -> torch.Tensor:
    """Scatter kept tokens back to their positions, filling dropped slots
    with the learned mask embedding (module/model.py:442-470 semantics)."""
    batch, keep_len, dim = kept.shape
    length = ids_restore.shape[0]
    fill = mask_token.expand(batch, length - keep_len, dim)
    return torch.cat([kept, fill], dim=1)[:, ids_restore, :]
