"""Image patch extraction as a numpy reshape (mre_tpu/ops/patches.py).

Reference semantics: module/model.py:86-92. Layout is NHWC with patches
flattened row-major to [B, (H/p)·(W/p), p²·C].
"""

from __future__ import annotations

import numpy as np


def extract_patches(image: np.ndarray, patch_size: int) -> np.ndarray:
    b, h, w, c = image.shape
    gh, gw = h // patch_size, w // patch_size
    x = image.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(x.reshape(b, gh * gw, patch_size * patch_size * c))
