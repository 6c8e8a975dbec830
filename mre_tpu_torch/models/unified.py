"""UnifiedModel (port of mre_tpu/models/unified.py).

* M3AE multimodal encoder → per-node cls embeddings;
* one RGCNConv (emb_dim → dim, 30 bases) + LeakyReLU(0.2);
* relation-description encoder: M3AE text pass (no gradient) → two
  spectral-norm Dense layers;
* conditional generator head: text encoding ⊕ noise → spectral-norm fc →
  the same map layers → std-LayerNorm;
* bidirectional InfoNCE between mean image / text tokens (τ = 0.05).

Reference quirk kept (``norm_rel_emb=False``): ``forward_relation_emb``
drops the LayerNorm (module/model.py:609 discards its result) while
``generate`` applies it (model.py:686).

``compute_dtype`` reaches the M3AE encoder and decoder transformers only:
RGCN, the spectral-norm layers, the heads and the losses stay float32, as
in JAX (unified.py:50,71).

``forward`` is the JAX ``__call__(is_evaluate=True)``: (x_gcn, rel_emb).
``forward_train`` is the training ``__call__``: it adds the masked encoder,
the decoder and the contrastive loss, and steps the spectral norms of the
relation map layers when ``update_sn``.
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
from mre_tpu_torch.ops import losses as L


def unified_config(model_type: str = "small", updates: dict | None = None) -> Config:
    cfg = Config(dict(
        model_type=model_type,
        emb_dim=200,                 # GCN/relation embedding dim (args.emb_dim)
        noise_dim=15,
        num_bases=30,
        patch_size=16,
        image_mask_ratio=0.75,
        text_mask_ratio=0.75,
        leaky_slope=0.2,
        contrastive=True,
        norm_rel_emb=False,
        compute_dtype="float32",     # forwarded to the M3AE transformers
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
        m3ae_cfg = m3ae_config(cfg.model_type, dict(
            image_mask_ratio=cfg.image_mask_ratio,
            text_mask_ratio=cfg.text_mask_ratio,
            compute_dtype=cfg.compute_dtype,
            attention_impl=cfg.attention_impl))
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

    def _text_cls(self, description_tokens, des_padding_mask, shard=None):
        # the JAX stop_gradient (unified.py:109): no graph is built, so a
        # training step keeps no activations of this pass
        with torch.no_grad():
            if shard is not None:
                description_tokens = shard.local(description_tokens)
                des_padding_mask = shard.local(des_padding_mask)
            rel_emb, _ = self.M3AEmodel.forward_representation(
                None, description_tokens, des_padding_mask)
            rel_emb = rel_emb.reshape(rel_emb.shape[0], -1)
            return rel_emb if shard is None else shard.gather(rel_emb)

    def forward_relation_emb(self, description_tokens, des_padding_mask,
                             update_sn: bool = False, shard=None):
        rel_emb = self._text_cls(description_tokens, des_padding_mask, shard)
        rel_emb = self.des_rel_map_layer1(rel_emb, update_stats=update_sn)
        rel_emb = self.des_rel_map_layer2(rel_emb, update_stats=update_sn)
        if self.cfg.norm_rel_emb:
            rel_emb = self.layer_norm(rel_emb)
        return rel_emb

    # -- conditional relation generator -------------------------------------

    def generate(self, description_tokens, des_padding_mask, noise,
                 update_sn: bool = False):
        """Generator head (unified.py:118-128). The text pass builds no
        graph; ``update_sn`` steps the power iteration of the three SN
        layers (the ZSL G step)."""
        rel_emb = self._text_cls(description_tokens, des_padding_mask)
        x = self.generate_fc_layer(torch.cat([noise, rel_emb], dim=1), update_stats=update_sn)
        x = self.des_rel_map_layer1(x, update_stats=update_sn)
        x = self.des_rel_map_layer2(x, update_stats=update_sn)
        return self.layer_norm(x)

    # -- evaluation forward (JAX __call__ with is_evaluate=True) -------------

    def forward(self, edge_index, edge_type, batch, edge_mask=None):
        cls_x, _ = self.M3AEmodel.forward_representation(
            batch.get("image_patches"), batch["text"], batch["text_padding_mask"])
        x_gcn = self.gcn_forward_encoder(cls_x, edge_index, edge_type, edge_mask)
        rel_emb = self.forward_relation_emb(batch["rel_des"],
                                            batch["rel_des_padding_mask"])
        return x_gcn, rel_emb

    # -- training forward (JAX __call__ with is_evaluate=False) ---------------

    def forward_train(self, edge_index, edge_type, batch, image_ids_shuffle,
                      text_ids_shuffle, edge_mask=None, update_sn: bool = False,
                      node_mask=None, node_shard=None, edge_shard=None):
        """(x_gcn, rel_emb, batch_output) as the JAX ``__call__``; the masking
        permutations [L] of the image patches and the text tokens are
        arguments (``ops/masking.py``).

        Data parallel (``parallel.mesh.RowShard``): with ``node_shard`` the
        M3AE passes (representation, masked encoder, decoder) run on this
        rank's node rows only, and the cls and mean-token reps are gathered
        into the full node table, so the RGCN and the contrastive loss see
        every node; ``batch_output``'s image and text outputs and masks are
        this rank's rows. ``edge_shard`` does the same for the description
        pass of the relation encoder."""
        image = batch.get("image_patches")
        text = batch["text"]
        text_padding_mask = batch["text_padding_mask"]
        m3ae = self.M3AEmodel
        if node_shard is not None:
            image, text, text_padding_mask = (
                None if image is None else node_shard.local(image),
                node_shard.local(text), node_shard.local(text_padding_mask))

        def gathered(x):
            return x if node_shard is None else node_shard.gather(x)

        cls_x, _ = m3ae.forward_representation(image, text, text_padding_mask)
        x_gcn = self.gcn_forward_encoder(gathered(cls_x), edge_index, edge_type, edge_mask)
        rel_emb = self.forward_relation_emb(
            batch["rel_des"], batch["rel_des_padding_mask"], update_sn=update_sn,
            shard=edge_shard)

        (enc_cls, image_x, text_x, image_mask, text_mask,
         image_ids_restore, text_ids_restore) = m3ae.forward_encoder(
            image, text, text_padding_mask, image_ids_shuffle, text_ids_shuffle)
        image_output, text_output = m3ae.forward_decoder(
            enc_cls, image_x, text_x, image_ids_restore, text_ids_restore,
            text_padding_mask)

        if self.cfg.contrastive and image is not None and text is not None:
            loss_c, c_acc = L.contrastive_loss(gathered(image_x.mean(dim=1)),
                                               gathered(text_x.mean(dim=1)),
                                               row_mask=node_mask)
        else:
            loss_c = c_acc = torch.zeros((), device=cls_x.device)
        return x_gcn, rel_emb, dict(
            image_output=image_output, text_output=text_output,
            image_mask=image_mask, text_mask=text_mask,
            contrastive_loss=loss_c, contrastive_accuracy=c_acc)
