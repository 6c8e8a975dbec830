"""Masked Multimodal Autoencoder, representation pass (port of mre_tpu/models/m3ae.py).

All submodules are built, decoder included, so the ``state_dict`` mirrors
the flax tree and carried weights round-trip. This slice ports the
unmasked representation pass only (``forward_representation``,
m3ae.py:118-139): [cls | image patches | text tokens] with modality type
embeddings and fixed sin-cos positions through the shared pre-LN encoder.
The masked encoder pass, the decoder pass and masking come with training.
"""

from __future__ import annotations

import torch
from torch import nn

from mre_tpu_torch.core.config import Config, transformer_preset
from mre_tpu_torch.models.initializers import Dense, normal
from mre_tpu_torch.models.transformer import MLP, Transformer
from mre_tpu_torch.ops.pos_embed import get_1d_sincos_pos_embed, get_2d_sincos_pos_embed


def m3ae_config(model_type: str = "small", updates: dict | None = None) -> Config:
    cfg = Config(dict(
        model_type=model_type,
        output_head_depth=0,
        use_type_embedding=True,
        attention_impl="auto",      # auto | kernel | torch (transformer.py)
    ))
    cfg.update(transformer_preset(model_type))
    if updates:
        unknown = set(updates) - set(cfg)
        if unknown:
            raise KeyError(f"unknown m3ae config keys: {sorted(unknown)}")
        cfg.update(updates)
    return cfg


_TOKENS = {  # learned [1, 1, width] tokens: name → width key, init N(0, 0.02)
    "cls_token": "emb_dim",
    "encoder_image_type_embedding": "emb_dim",
    "encoder_text_type_embedding": "emb_dim",
    "decoder_image_type_embedding": "dec_emb_dim",
    "decoder_text_type_embedding": "dec_emb_dim",
    "image_mask_embedding": "dec_emb_dim",
    "text_mask_embedding": "dec_emb_dim",
}


class M3AE(nn.Module):
    def __init__(self, text_vocab_size: int, patch_size: int,
                 image_output_dim: int = 768, config: Config | None = None):
        super().__init__()
        cfg = Config(config)
        self.cfg = cfg
        self.patch_size = patch_size
        self.text_embedding = nn.Embedding(text_vocab_size, cfg.emb_dim)
        self.image_embedding = Dense(patch_size * patch_size * 3, cfg.emb_dim)
        for name, width in _TOKENS.items():
            if "type_embedding" in name and not cfg.use_type_embedding:
                continue
            setattr(self, name, nn.Parameter(torch.zeros(1, 1, cfg[width])))
        impl = cfg.get("attention_impl", "auto")
        self.encoder = Transformer(cfg.emb_dim, cfg.depth, cfg.num_heads,
                                   cfg.mlp_ratio, impl)
        self.decoder = Transformer(cfg.dec_emb_dim, cfg.dec_depth,
                                   cfg.dec_num_heads, cfg.mlp_ratio, impl)
        self.decoder_input_projection = Dense(cfg.emb_dim, cfg.dec_emb_dim)
        head_norm = cfg.output_head_depth > 0
        self.decoder_image_output = MLP(cfg.dec_emb_dim, cfg.dec_emb_dim,
                                        image_output_dim, cfg.output_head_depth,
                                        input_norm=head_norm)
        self.decoder_text_output = MLP(cfg.dec_emb_dim, cfg.dec_emb_dim,
                                       text_vocab_size, cfg.output_head_depth,
                                       input_norm=head_norm)

    @torch.no_grad()
    def init_(self, gen):
        self.text_embedding.weight.copy_(
            normal(tuple(self.text_embedding.weight.shape), 1.0, gen))
        for name in _TOKENS:
            p = getattr(self, name, None)
            if p is not None:
                p.copy_(normal(tuple(p.shape), 0.02, gen))

    def _type_emb(self, name):
        return getattr(self, name) if self.cfg.use_type_embedding else 0.0

    def forward_representation(self, image, text, text_padding_mask):
        """image: [B, L, p²·3] patches or None; text: [B, T] ids or None;
        text_padding_mask: [B, T], 1.0 = PAD. Returns (cls [B, 1, D],
        all tokens [B, 1+L+T, D])."""
        ref = image if image is not None else text
        batch, dev = ref.shape[0], ref.device
        emb = self.cfg.emb_dim
        toks = [self.cls_token.expand(batch, 1, emb)]
        pads = [torch.zeros(batch, 1, dtype=torch.float32, device=dev)]
        if image is not None:
            pos = torch.from_numpy(get_2d_sincos_pos_embed(
                emb, image.shape[1], self.patch_size)).to(dev)
            toks.append(self.image_embedding(image) + pos
                        + self._type_emb("encoder_image_type_embedding"))
            pads.append(torch.zeros(batch, image.shape[1], dtype=torch.float32,
                                    device=dev))
        if text is not None:
            pos = torch.from_numpy(get_1d_sincos_pos_embed(emb, text.shape[1])).to(dev)
            toks.append(self.text_embedding(text.long()) + pos
                        + self._type_emb("encoder_text_type_embedding"))
            pads.append(text_padding_mask.to(torch.float32))
        x = self.encoder(torch.cat(toks, dim=1), torch.cat(pads, dim=1))
        return x[:, :1, :], x
