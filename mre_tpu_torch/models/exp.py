"""ExpModel — the no-GCN ablation (port of mre_tpu/models/exp.py).

The reference's ExpModel (module/model.py:703-835): a per-entity 2-layer
MLP (mm_layer1/2, LeakyReLU(0.2), dropout 0.2) over the head and tail M3AE
cls embeddings instead of the RGCN; the relation-description encoder uses
plain (not spectral-norm) map layers with an activation between them. It
reuses the port's M3AE encoder and decoder.

As elsewhere in the port, the random parts are arguments: the masking
permutations (``image_ids_shuffle``, ``text_ids_shuffle``) and the dropout
masks (``drop``, a ``DropoutMasks``: three calls, head, tail, relation,
in the JAX call order).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mre_tpu_torch.core.config import Config
from mre_tpu_torch.models.initializers import Dense
from mre_tpu_torch.models.m3ae import M3AE, m3ae_config
from mre_tpu_torch.models.transformer import DropoutMasks

DROPOUT = 0.2


class ExpModel(nn.Module):
    def __init__(self, text_vocab_size: int, config: Config | None = None):
        super().__init__()
        cfg = Config(config)
        m3ae_cfg = m3ae_config(cfg.model_type, dict(
            image_mask_ratio=cfg.image_mask_ratio,
            text_mask_ratio=cfg.text_mask_ratio,
            attention_impl=cfg.get("attention_impl", "auto")))
        self.dim = cfg.emb_dim
        width = m3ae_cfg.emb_dim
        self.M3AEmodel = M3AE(text_vocab_size, cfg.patch_size,
                              cfg.patch_size * cfg.patch_size * 3, m3ae_cfg)
        self.des_rel_map_layer1 = Dense(width, self.dim)
        self.des_rel_map_layer2 = Dense(self.dim, self.dim)
        self.mm_layer1 = Dense(width, self.dim)
        self.mm_layer2 = Dense(self.dim, self.dim)

    @staticmethod
    def _dropout(x, drop: DropoutMasks | None):
        return x if drop is None else drop(x, DROPOUT)

    def forward_entity_emb(self, cls_x, drop: DropoutMasks | None = None):
        x = self._dropout(cls_x.reshape(cls_x.shape[0], -1), drop)
        return self.mm_layer2(F.leaky_relu(self.mm_layer1(x), negative_slope=0.2))

    def forward_relation_emb(self, description_tokens, des_padding_mask,
                             drop: DropoutMasks | None = None):
        with torch.no_grad():      # the JAX stop_gradient
            rel_emb, _ = self.M3AEmodel.forward_representation(
                None, description_tokens, des_padding_mask)
        rel_emb = self._dropout(rel_emb.reshape(rel_emb.shape[0], -1), drop)
        rel_emb = F.leaky_relu(self.des_rel_map_layer1(rel_emb), negative_slope=0.2)
        return self.des_rel_map_layer2(rel_emb)

    def forward(self, batch: dict, is_evaluate: bool = False, image_ids_shuffle=None,
                text_ids_shuffle=None, drop: DropoutMasks | None = None):
        """batch: image_patches_head/tail, text_head/tail,
        text_padding_mask_head/tail, rel_des, rel_des_padding_mask.
        ``drop`` None is the deterministic pass. ``is_evaluate`` returns
        (x_head, x_tail, rel_emb); else the masked encoder and decoder run
        on the head entities and (x_head, x_tail, rel_emb, batch_output)."""
        m3ae = self.M3AEmodel
        cls_h, _ = m3ae.forward_representation(
            batch.get("image_patches_head"), batch["text_head"],
            batch["text_padding_mask_head"])
        cls_t, _ = m3ae.forward_representation(
            batch.get("image_patches_tail"), batch["text_tail"],
            batch["text_padding_mask_tail"])
        x_head = self.forward_entity_emb(cls_h, drop)
        x_tail = self.forward_entity_emb(cls_t, drop)
        rel_emb = self.forward_relation_emb(batch["rel_des"], batch["rel_des_padding_mask"],
                                            drop)
        if is_evaluate:
            return x_head, x_tail, rel_emb

        (enc_cls, image_x, text_x, image_mask, text_mask,
         image_ids_restore, text_ids_restore) = m3ae.forward_encoder(
            batch.get("image_patches_head"), batch["text_head"],
            batch["text_padding_mask_head"], image_ids_shuffle, text_ids_shuffle)
        image_output, text_output = m3ae.forward_decoder(
            enc_cls, image_x, text_x, image_ids_restore, text_ids_restore,
            batch["text_padding_mask_head"])
        # reference quirk kept (model.py:780-786): the contrastive loss is
        # computed upstream but hard-coded to 0 in batch_output
        batch_output = dict(image_output=image_output, text_output=text_output,
                            image_mask=image_mask, text_mask=text_mask,
                            contrastive_loss=0.0, contrastive_accuracy=0.0)
        return x_head, x_tail, rel_emb, batch_output
