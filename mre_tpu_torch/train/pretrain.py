"""M3AE-only pretraining objective, paired + unpaired text (port of
mre_tpu/train/pretrain.py).

The reference's ``first_fusion_train`` (module/model.py:22-84; dead code
upstream, implemented as intended): the weighted loss of a masked
multimodal pass over a paired (image, text) batch and a text-only pass over
an unpaired text batch, with the info dict of the same metric names.
"""

from __future__ import annotations

import torch

from mre_tpu_torch.ops import losses as L


def m3ae_pretrain_loss(m3ae_apply, batch: dict, image_loss_weight: float = 0.7,
                       text_loss_weight: float = 0.5,
                       unpaired_text_loss_weight: float = 0.5,
                       image_all_token_loss: bool = False,
                       text_all_token_loss: bool = False):
    """``m3ae_apply(image_patches, text, pad) → (image_out, text_out,
    image_mask, text_mask)``: a masked M3AE forward with its masking
    permutations bound (e.g. ``M3AE.forward`` with ``*_ids_shuffle``).

    batch: image_patches, text, text_padding_mask, unpaired_text,
    unpaired_text_padding_mask."""
    image_patches = batch["image_patches"]
    text = batch["text"]
    pad = batch["text_padding_mask"]
    u_text = batch["unpaired_text"]
    u_pad = batch["unpaired_text_padding_mask"]

    image_out, text_out, image_mask, text_mask = m3ae_apply(image_patches, text, pad)
    _, u_text_out, _, u_text_mask = m3ae_apply(None, u_text, u_pad)

    image_loss = L.patch_mse_loss(
        image_out, image_patches, None if image_all_token_loss else image_mask)
    text_valid = L.mask_intersection(
        torch.ones_like(text_mask) if text_all_token_loss else text_mask, L.mask_not(pad))
    text_loss, text_acc = L.cross_entropy_loss_and_accuracy(text_out, text, text_valid)
    u_valid = L.mask_intersection(
        torch.ones_like(u_text_mask) if text_all_token_loss else u_text_mask,
        L.mask_not(u_pad))
    u_loss, u_acc = L.cross_entropy_loss_and_accuracy(u_text_out, u_text, u_valid)

    loss = (image_loss_weight * image_loss + text_loss_weight * text_loss
            + unpaired_text_loss_weight * u_loss)
    info = dict(
        loss=loss, image_loss=image_loss, text_loss=text_loss,
        unpaired_text_loss=u_loss, text_accuracy=text_acc,
        unpaired_text_accuracy=u_acc,
        average_text_length=L.mask_not(pad).sum(dim=-1).mean(),
        average_unpaired_text_length=L.mask_not(u_pad).sum(dim=-1).mean(),
    )
    return loss, info
