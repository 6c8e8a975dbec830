"""Image logging / reconstruction-visualization helpers (port of
mre_tpu/utils/images.py).

The reference's wandb image utilities (module/utils.py:246-269,
module/model.py:688-701): merge patch predictions back into pixel space and
assemble [original | predicted | masked-combined] grids for logging.
"""

from __future__ import annotations

import numpy as np
import torch

from mre_tpu_torch.ops.patches import extract_patches, mask_select, merge_patches


def image_float2int(image: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(image) * 255.0, 0.0, 255.0).astype(np.uint8)


def create_log_images(images, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0), n=5):
    """Stack [rows of variants] × n examples into one uint8 grid
    (module/utils.py:264-269)."""
    images = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
              for x in images]
    rows = np.concatenate(images, axis=2)
    n = min(n, rows.shape[0])
    mean = np.asarray(mean)
    std = np.asarray(std)
    result = np.concatenate([rows[i] * std + mean for i in range(n)], axis=0)
    return image_float2int(result)


@torch.no_grad()
def patch_predict(m3ae_apply, image, text, text_padding_mask, patch_size):
    """(original, predicted, predicted-combined) images of a masked M3AE
    forward (module/model.py:688-701). ``image`` [B, H, W, 3] numpy;
    ``m3ae_apply(patches, text, pad) → (image_output, text_output,
    image_mask, text_mask)`` (tensors) with its masking permutations bound;
    it gets the patches as a numpy array and moves them to its device."""
    patches = extract_patches(np.asarray(image), patch_size)
    image_output, _, image_mask, _ = m3ae_apply(patches, text, text_padding_mask)
    image_output, image_mask = image_output.cpu().numpy(), image_mask.cpu().numpy()
    predicted = merge_patches(image_output, patch_size)
    combined = merge_patches(mask_select(image_mask, patches, image_output), patch_size)
    return image, predicted, combined
