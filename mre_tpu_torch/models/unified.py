"""UnifiedModel, serving form (port of mre_tpu/models/unified.py).

* M3AE multimodal encoder → per-node cls embeddings;
* one RGCNConv (emb_dim → dim, 30 bases) + LeakyReLU(0.2);
* relation-description encoder: M3AE text pass → two spectral-norm Dense
  layers;
* conditional generator head: text encoding ⊕ noise → spectral-norm fc →
  the same map layers → std-LayerNorm.

Reference quirk kept (``norm_rel_emb=False``): ``forward_relation_emb``
drops the LayerNorm (module/model.py:609 discards its result) while
``generate`` applies it (model.py:686).

``forward`` is the JAX ``__call__(is_evaluate=True)``: it returns
(x_gcn, rel_emb). The training form (masked encoder, decoder, contrastive
loss) comes with the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mre_tpu_torch.core.config import Config
from mre_tpu_torch.models.m3ae import M3AE, m3ae_config
from mre_tpu_torch.models.rgcn import RGCNConv
from mre_tpu_torch.models.spectral_norm import SNDense
from mre_tpu_torch.models.transformer import LayerNormalization


def unified_config(model_type: str = "small", updates: dict | None = None) -> Config:
    cfg = Config(dict(
        model_type=model_type,
        emb_dim=200,                 # GCN/relation embedding dim (args.emb_dim)
        noise_dim=15,
        num_bases=30,
        patch_size=16,
        leaky_slope=0.2,
        norm_rel_emb=False,
        attention_impl="auto",       # forwarded to the M3AE transformers
    ))
    if updates:
        unknown = set(updates) - set(cfg)
        if unknown:
            raise KeyError(f"unknown unified config keys: {sorted(unknown)}")
        cfg.update(updates)
    return cfg


class UnifiedModel(nn.Module):
    def __init__(self, text_vocab_size: int, num_relations: int,
                 config: Config | None = None):
        super().__init__()
        cfg = Config(config)
        self.cfg = cfg
        m3ae_cfg = m3ae_config(cfg.model_type, dict(attention_impl=cfg.attention_impl))
        self.reduced_dim = m3ae_cfg.emb_dim
        self.dim = cfg.emb_dim
        self.M3AEmodel = M3AE(text_vocab_size, cfg.patch_size,
                              cfg.patch_size * cfg.patch_size * 3, m3ae_cfg)
        self.conv = RGCNConv(self.reduced_dim, self.dim, num_relations,
                             cfg.num_bases)
        self.des_rel_map_layer1 = SNDense(self.reduced_dim, self.dim)
        self.des_rel_map_layer2 = SNDense(self.dim, self.dim)
        self.generate_fc_layer = SNDense(self.reduced_dim + cfg.noise_dim,
                                         self.reduced_dim)
        self.layer_norm = LayerNormalization(self.dim)

    # -- structure consolidator -------------------------------------------

    def gcn_forward_encoder(self, x, edge_index, edge_type, edge_mask=None):
        x = self.conv(x.reshape(x.shape[0], -1), edge_index, edge_type,
                      edge_mask=edge_mask)
        return F.leaky_relu(x, negative_slope=self.cfg.leaky_slope)

    # -- relation-description encoder ---------------------------------------

    def _text_cls(self, description_tokens, des_padding_mask):
        rel_emb, _ = self.M3AEmodel.forward_representation(
            None, description_tokens, des_padding_mask)
        return rel_emb.detach().reshape(rel_emb.shape[0], -1)

    def forward_relation_emb(self, description_tokens, des_padding_mask):
        rel_emb = self._text_cls(description_tokens, des_padding_mask)
        rel_emb = self.des_rel_map_layer2(self.des_rel_map_layer1(rel_emb))
        if self.cfg.norm_rel_emb:
            rel_emb = self.layer_norm(rel_emb)
        return rel_emb

    # -- conditional relation generator -------------------------------------

    def generate(self, description_tokens, des_padding_mask, noise):
        rel_emb = self._text_cls(description_tokens, des_padding_mask)
        x = self.generate_fc_layer(torch.cat([noise, rel_emb], dim=1))
        x = self.des_rel_map_layer2(self.des_rel_map_layer1(x))
        return self.layer_norm(x)

    # -- evaluation forward (JAX __call__ with is_evaluate=True) -------------

    def forward(self, edge_index, edge_type, batch, edge_mask=None):
        cls_x, _ = self.M3AEmodel.forward_representation(
            batch.get("image_patches"), batch["text"], batch["text_padding_mask"])
        x_gcn = self.gcn_forward_encoder(cls_x, edge_index, edge_type, edge_mask)
        rel_emb = self.forward_relation_emb(batch["rel_des"],
                                            batch["rel_des_padding_mask"])
        return x_gcn, rel_emb
