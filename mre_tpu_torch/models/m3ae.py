"""Masked Multimodal Autoencoder (port of mre_tpu/models/m3ae.py).

Text-token + image-patch embeddings with modality type embeddings and fixed
sin-cos positions, a shared pre-LN encoder over [cls | image | text], MAE
random masking (one shared permutation per batch, static keep lengths) and a
decoder that reconstructs image patches and text tokens.

* ``forward_representation`` — the unmasked pass (m3ae.py:118-139);
* ``forward_encoder`` — the masked pass (m3ae.py:143-188) over
  1 + keep_img + keep_txt tokens;
* ``forward_decoder`` — mask tokens restored, the decoder over every
  position (m3ae.py:192-228);
* ``forward`` — the JAX ``__call__``: encoder then decoder.

The masking permutations are arguments (``image_ids_shuffle``,
``text_ids_shuffle``), not draws: see ``ops/masking.py``. The config's
``compute_dtype`` reaches the encoder and decoder ``Transformer``s only;
the embeddings, the decoder's input projection and the output heads stay
float32, as in JAX (m3ae.py:89-109). The masked passes are not
deterministic by default, as in JAX: with nonzero ``att_drop`` / ``drop``
/ ``drop_path`` they take their masks from ``drop`` (a ``DropoutMasks``).

``load_cc12m_checkpoint`` reads the upstream flax CC12M pickle without
flax and copies its encoder-side leaves into the module.

A config with ``encoder="lfm2"`` (an ``ENCODER_PRESETS`` model type, such
as ``lfm2-8b-a1b``) builds ``models/lfm2.py``'s stack in place of the ViT
encoder, over the same input assembly: ``forward_representation`` then
pools each row at its last non-PAD position (causal attention leaves
position 0 blind), and the masked pass, which only training runs, raises.
"""

from __future__ import annotations

import codecs
import pickle

import numpy as np
import torch
from torch import nn

from mre_tpu_torch.core.config import Config, transformer_preset
from mre_tpu_torch.interop import load_flax, module_to_flax
from mre_tpu_torch.models.initializers import Dense, normal
from mre_tpu_torch.models.lfm2 import LFM2, last_valid
from mre_tpu_torch.models.transformer import MLP, Transformer, compute_dtype
from mre_tpu_torch.ops.masking import random_masking, restore_with_mask_tokens
from mre_tpu_torch.ops.pos_embed import get_1d_sincos_pos_embed, get_2d_sincos_pos_embed


def m3ae_config(model_type: str = "small", updates: dict | None = None) -> Config:
    cfg = Config(dict(
        model_type=model_type,
        output_head_depth=0,
        att_drop=0.0, drop=0.0, drop_path=0.0,
        use_type_embedding=True,
        image_mask_ratio=0.75,
        text_mask_ratio=0.75,
        compute_dtype="float32",    # "bfloat16": the transformers' Dense layers in bf16
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
        self.lfm2 = cfg.get("encoder") == "lfm2"
        drops = dict(att_drop=cfg.att_drop, drop=cfg.drop, drop_path=cfg.drop_path,
                     dtype=compute_dtype(cfg.get("compute_dtype", "float32")))
        if self.lfm2:
            if cfg.att_drop or cfg.drop or cfg.drop_path:
                raise ValueError("the LFM2 encoder has no dropout")
            self.encoder = LFM2(cfg, impl, drops["dtype"])
        else:
            self.encoder = Transformer(cfg.emb_dim, cfg.depth, cfg.num_heads,
                                       cfg.mlp_ratio, impl, **drops)
        self.decoder = Transformer(cfg.dec_emb_dim, cfg.dec_depth,
                                   cfg.dec_num_heads, cfg.mlp_ratio, impl, **drops)
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
        all tokens [B, 1+L+T, D]); with the LFM2 encoder the first is each
        row's state at its last non-PAD position."""
        ref = image if image is not None else text
        batch, dev = ref.shape[0], ref.device
        emb = self.cfg.emb_dim
        toks = [self.cls_token.expand(batch, 1, emb)]
        pads = [torch.zeros(batch, 1, dtype=torch.float32, device=dev)]
        if image is not None:
            toks.append(self._embed_image(image))
            pads.append(torch.zeros(batch, image.shape[1], dtype=torch.float32,
                                    device=dev))
        if text is not None:
            toks.append(self._embed_text(text))
            pads.append(text_padding_mask.to(torch.float32))
        pads = torch.cat(pads, dim=1)
        x = self.encoder(torch.cat(toks, dim=1), pads)
        if self.lfm2:
            return last_valid(x, pads), x
        return x[:, :1, :], x

    def _embed_image(self, image):
        pos = torch.from_numpy(get_2d_sincos_pos_embed(
            self.cfg.emb_dim, image.shape[1], self.patch_size)).to(image.device)
        return (self.image_embedding(image) + pos
                + self._type_emb("encoder_image_type_embedding"))

    def _embed_text(self, text):
        pos = torch.from_numpy(get_1d_sincos_pos_embed(
            self.cfg.emb_dim, text.shape[1])).to(text.device)
        return (self.text_embedding(text.long()) + pos
                + self._type_emb("encoder_text_type_embedding"))

    def forward_encoder(self, image, text, text_padding_mask,
                        image_ids_shuffle=None, text_ids_shuffle=None,
                        deterministic: bool = False, drop=None):
        """Masked encoder pass. Each present modality keeps
        int(L·(1 − ratio)) tokens, the first of its ``*_ids_shuffle``
        permutation [L]. Returns (cls, image_x, text_x, image_mask,
        text_mask, image_ids_restore, text_ids_restore) as JAX does."""
        if self.lfm2:
            raise NotImplementedError("the LFM2 encoder serves only: its masked pass "
                                      "(training) is not supported")
        ref = image if image is not None else text
        batch, dev = ref.shape[0], ref.device
        emb = self.cfg.emb_dim
        toks = [self.cls_token.expand(batch, 1, emb)]
        pads = [torch.zeros(batch, 1, dtype=torch.float32, device=dev)]
        image_mask = image_ids_restore = text_mask = text_ids_restore = None
        img_keep = 0
        if image is not None:
            img_keep = int(image.shape[1] * (1.0 - self.cfg.image_mask_ratio))
            m = random_masking(self._embed_image(image), img_keep, image_ids_shuffle)
            toks.append(m.kept)
            pads.append(torch.zeros(batch, img_keep, dtype=torch.float32, device=dev))
            image_mask, image_ids_restore = m.mask, m.ids_restore
        if text is not None:
            txt_keep = int(text.shape[1] * (1.0 - self.cfg.text_mask_ratio))
            m = random_masking(self._embed_text(text), txt_keep, text_ids_shuffle,
                               text_padding_mask.to(torch.float32))
            toks.append(m.kept)
            pads.append(m.padding_mask_kept)
            text_mask, text_ids_restore = m.mask, m.ids_restore
        x = self.encoder(torch.cat(toks, dim=1), torch.cat(pads, dim=1), deterministic, drop)
        cls_x = x[:, :1, :]
        if image is None:
            image_x, text_x = None, x[:, 1:, :]
        elif text is None:
            image_x, text_x = x[:, 1:, :], None
        else:
            image_x, text_x = x[:, 1:img_keep + 1, :], x[:, img_keep + 1:, :]
        return (cls_x, image_x, text_x, image_mask, text_mask,
                image_ids_restore, text_ids_restore)

    def forward_decoder(self, cls_x, image_x, text_x, image_ids_restore,
                        text_ids_restore, text_padding_mask, deterministic: bool = False,
                        drop=None):
        """Decoder over [cls | every image position | every text position],
        dropped positions filled with the mask embeddings; the text part
        takes the FULL padding mask (m3ae.py:216)."""
        width = self.cfg.dec_emb_dim
        batch, dev = cls_x.shape[0], cls_x.device
        toks = [self.decoder_input_projection(cls_x)]
        pads = [torch.zeros(batch, 1, dtype=torch.float32, device=dev)]
        img_len = 0
        if image_x is not None:
            img_len = image_ids_restore.shape[0]
            x = restore_with_mask_tokens(self.decoder_input_projection(image_x),
                                         self.image_mask_embedding, image_ids_restore)
            pos = torch.from_numpy(get_2d_sincos_pos_embed(
                width, img_len, self.patch_size)).to(dev)
            toks.append(x + pos + self._type_emb("decoder_image_type_embedding"))
            pads.append(torch.zeros(batch, img_len, dtype=torch.float32, device=dev))
        if text_x is not None:
            x = restore_with_mask_tokens(self.decoder_input_projection(text_x),
                                         self.text_mask_embedding, text_ids_restore)
            pos = torch.from_numpy(get_1d_sincos_pos_embed(
                width, text_ids_restore.shape[0])).to(dev)
            toks.append(x + pos + self._type_emb("decoder_text_type_embedding"))
            pads.append(text_padding_mask.to(torch.float32))
        x = self.decoder(torch.cat(toks, dim=1), torch.cat(pads, dim=1), deterministic, drop)
        if image_x is None:
            return None, self.decoder_text_output(x[:, 1:, :])
        if text_x is None:
            return self.decoder_image_output(x[:, 1:, :]), None
        return (self.decoder_image_output(x[:, 1:img_len + 1, :]),
                self.decoder_text_output(x[:, img_len + 1:, :]))

    def forward(self, image, text, text_padding_mask, image_ids_shuffle=None,
                text_ids_shuffle=None, deterministic: bool = False, drop=None):
        """The JAX ``__call__``: (image_output, text_output, image_mask,
        text_mask). ``drop`` serves the encoder's masks, then the
        decoder's."""
        (cls_x, image_x, text_x, image_mask, text_mask,
         image_ids_restore, text_ids_restore) = self.forward_encoder(
            image, text, text_padding_mask, image_ids_shuffle, text_ids_shuffle,
            deterministic, drop)
        image_output, text_output = self.forward_decoder(
            cls_x, image_x, text_x, image_ids_restore, text_ids_restore,
            text_padding_mask, deterministic, drop)
        return image_output, text_output, image_mask, text_mask


# -- the upstream CC12M checkpoint (m3ae.py:240-267) -----------------------------

# leaves copied from the checkpoint, as JAX copies them: the named tokens and
# embeddings, then whole subtrees
CC12M_TOKENS = ("cls_token", "encoder_image_type_embedding", "encoder_text_type_embedding",
                "image_mask_embedding", "text_mask_embedding",
                "decoder_image_type_embedding", "decoder_text_type_embedding")
CC12M_SUBTREES = ("image_embedding", "text_embedding", "encoder")


class _Pickled:
    """A pickled object of a class the port does not have (a flax
    ``TrainState``, an optax state): its constructor arguments and its
    attributes."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __setstate__(self, state):
        if isinstance(state, tuple):          # (dict state, slot state)
            state = {**(state[0] or {}), **(state[1] or {})}
        self.__dict__.update(state)


def _jax_array(fun, args, arr_state, aval_state):
    """jax ``_reconstruct_array`` (jax/_src/array.py) on the host: the
    numpy array it wraps."""
    out = fun(*args)
    out.__setstate__(arr_state)
    return out


def _frombuffer(buf, dtype, shape, order):
    """numpy's ``_frombuffer`` (pickle protocol 5)."""
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order=order)


_ALLOWED_GLOBALS = {
    ("flax.training.train_state", "TrainState"): _Pickled,
    ("optax._src.transform", "ScaleByAdamState"): _Pickled,
    ("optax._src.base", "EmptyState"): _Pickled,
    ("flax.core.frozen_dict", "FrozenDict"): dict,     # flax < 0.7 parameter trees
    ("jax._src.array", "_reconstruct_array"): _jax_array,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("_codecs", "encode"): codecs.encode,              # bytes under pickle protocol 2
    **{(f"{mod}.multiarray", name): fn for mod in ("numpy.core", "numpy._core")
       for name, fn in (("_reconstruct", np.zeros(0).__reduce__()[0]),
                        ("scalar", np.zeros(1)[0].__reduce__()[0]))},
    **{(f"{mod}.numeric", "_frombuffer"): _frombuffer for mod in ("numpy.core", "numpy._core")},
}


class _CheckpointUnpickler(pickle.Unpickler):
    """Resolves only the globals a pickled flax train state names; any
    other global is refused by name."""

    def find_class(self, module, name):
        found = _ALLOWED_GLOBALS.get((module, name))
        if found is None:
            raise pickle.UnpicklingError(
                f"checkpoint pickle names the global {module}.{name}, which the "
                "CC12M loader does not allow")
        return found


def _cast_like(src, ref, path: str):
    """``src`` cast leaf by leaf to ``ref``'s dtypes; a structure that
    differs from ``ref``'s raises, as ``jax.tree_util.tree_map`` does."""
    if isinstance(ref, dict):
        if not isinstance(src, dict) or set(src) != set(ref):
            got = sorted(src) if isinstance(src, dict) else type(src).__name__
            raise ValueError(f"checkpoint subtree {path!r}: {got} does not match the "
                             f"model's {sorted(ref)}")
        return {k: _cast_like(src[k], ref[k], f"{path}/{k}") for k in ref}
    if isinstance(src, dict):
        raise ValueError(f"checkpoint subtree {path!r} is a dict where the model has a leaf")
    return np.asarray(src).astype(ref.dtype)


def load_cc12m_checkpoint(path: str, module: "M3AE") -> "M3AE":
    """Load the upstream flax M3AE pickle ``{'state': <flax TrainState>,
    'variant': ...}`` into ``module`` without flax (m3ae.py:240-267): the
    tokens of ``CC12M_TOKENS`` and the subtrees of ``CC12M_SUBTREES`` that
    both the checkpoint's ``state.params['params']`` and the module have
    are copied, each leaf cast to the module's dtype; the rest keeps its
    init. Only the globals such a pickle names are resolved."""
    with open(path, "rb") as f:
        data = _CheckpointUnpickler(f).load()
    src = data["state"].params["params"]
    out = module_to_flax(module)[0]
    for name in CC12M_TOKENS:
        if name in src and name in out:
            out[name] = np.asarray(src[name]).astype(out[name].dtype)
    for name in CC12M_SUBTREES:
        if name in src and name in out:
            out[name] = _cast_like(src[name], out[name], name)
    return load_flax(module, out)
