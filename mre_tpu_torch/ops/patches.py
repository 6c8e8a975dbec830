"""Image patch extract / merge as reshapes (port of mre_tpu/ops/patches.py).

Reference semantics: module/model.py:86-92 (extract_patches),
module/utils.py:246-259 (merge_patches, mask_select). Layout is NHWC with
patches flattened row-major to [B, (H/p)·(W/p), p²·C]. All three run on
the host, in numpy.
"""

from __future__ import annotations

import numpy as np


def extract_patches(image: np.ndarray, patch_size: int) -> np.ndarray:
    b, h, w, c = image.shape
    gh, gw = h // patch_size, w // patch_size
    x = image.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(x.reshape(b, gh * gw, patch_size * patch_size * c))


def merge_patches(patches: np.ndarray, patch_size: int) -> np.ndarray:
    b, length, _ = patches.shape
    side = int(round(length ** 0.5))
    x = patches.reshape(b, side, side, patch_size, patch_size, -1)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, side * patch_size, side * patch_size, -1)


def mask_select(mask: np.ndarray, this: np.ndarray, other=None) -> np.ndarray:
    """Where mask == 0 keep ``this``, else ``other`` (default 0)."""
    if other is None:
        other = np.zeros((), this.dtype)
    if this.ndim == 3:
        mask = mask[..., None]
    return np.where(mask == 0.0, this, other)
