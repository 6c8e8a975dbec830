"""The plain reference of the benchmark's configurations: M3AE (Geng et al.
2022, arXiv:2205.14204) under the multimodal relation-extrapolation model,
in plain PyTorch operations and float32, with no kernel, cache or batching
of the program. It imports nothing of the program.

Parameters come as one dict of tensors under the benchmark's names (those
of the weights it draws, ``weights.py``). The equations:

* a pre-LN ViT encoder over [cls | image patches | text tokens]: LayerNorm
  eps 1e-6, one qkv Dense with bias, softmax attention with the logit
  −1e7 at PAD keys, exact GELU MLP of ratio 4, a final LayerNorm; fixed
  sin-cos positions (2-D over the patch grid, 1-D over tokens) and learned
  modality type embeddings;
* MAE masking: one permutation per batch, the first ⌊L(1 − ratio)⌋ kept;
  the decoder fills the dropped positions with a learned mask token and
  sees the text's full PAD mask;
* the RGCN layer with basis decomposition, mean aggregation per
  (destination, relation), root weight and bias, LeakyReLU 0.2;
* spectrally normalised Dense layers (one power step on a training pass,
  σ = uᵀWv with u, v constant to autograd);
* the std-based LayerNorm (unbiased std, eps 1e-3 added to the std) of the
  generator head and the critic;
* the zero-shot Extractor (neighbour encoder, entity encoder, a residual
  support encoder with LayerNorm) and the WGAN critic.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

M3 = "M3AEmodel."


def sincos_1d(dim: int, length: int) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.outer(np.arange(length, dtype=np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


def sincos_2d(dim: int, length: int) -> np.ndarray:
    side = int(round(length ** 0.5))
    gw, gh = np.meshgrid(np.arange(side, dtype=np.float64), np.arange(side, dtype=np.float64),
                         indexing="xy")

    def one(pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 4, dtype=np.float64) / (dim / 4.0))
        out = np.outer(pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([one(gw), one(gh)], axis=1).astype(np.float32)


def _pos(table: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(table).to(like.device)[None]


def dense(p, name, x):
    y = x @ p[f"{name}.weight"].T
    b = p.get(f"{name}.bias")
    return y if b is None else y + b


def layer_norm(p, name, x, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def std_norm(p, name, z, eps=1e-3):
    mu = z.mean(-1, keepdim=True)
    std = torch.sqrt(((z - mu) ** 2).sum(-1, keepdim=True) / (z.shape[-1] - 1))
    return (z - mu) / (std + eps) * p[f"{name}.a_2"] + p[f"{name}.b_2"]


def attention(q, k, v, pad):
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = s.masked_fill(pad[:, None, None, :] > 0, -1e7)
    return torch.softmax(s, -1) @ v


def transformer(p, name, x, pad, depth: int, heads: int):
    b, n, d = x.shape
    for i in range(depth):
        blk = f"{name}.Block_{i}"
        h = layer_norm(p, f"{blk}.LayerNorm_0", x)
        qkv = dense(p, f"{blk}.Attention_0.Dense_0", h).reshape(b, n, 3, heads, d // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        a = attention(q, k, v, pad).transpose(1, 2).reshape(b, n, d)
        x = x + dense(p, f"{blk}.Attention_0.Dense_1", a)
        h = layer_norm(p, f"{blk}.LayerNorm_1", x)
        h = F.gelu(dense(p, f"{blk}.TransformerMLP_0.fc1", h))
        x = x + dense(p, f"{blk}.TransformerMLP_0.fc2", h)
    return layer_norm(p, f"{name}.LayerNorm_0", x)


class M3AE:
    """The encoder and decoder of one configuration (``cfg``: emb_dim,
    dec_emb_dim, depth, dec_depth, num_heads, dec_num_heads, mask ratios)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    def _image(self, p, image):
        d = self.cfg["emb_dim"]
        return (dense(p, M3 + "image_embedding", image) + _pos(sincos_2d(d, image.shape[1]), image)
                + p[M3 + "encoder_image_type_embedding"])

    def _text(self, p, text):
        d = self.cfg["emb_dim"]
        return (p[M3 + "text_embedding.weight"][text] + _pos(sincos_1d(d, text.shape[1]), text)
                + p[M3 + "encoder_text_type_embedding"])

    def _encode(self, p, toks, pads):
        c = self.cfg
        return transformer(p, M3 + "encoder", torch.cat(toks, 1), torch.cat(pads, 1),
                           c["depth"], c["num_heads"])

    def representation(self, p, image, text, text_pad):
        """All tokens of the unmasked pass ([B, 1 + L + T, D]); image may
        be None."""
        ref = text if image is None else image
        b = ref.shape[0]
        toks = [p[M3 + "cls_token"].expand(b, 1, -1)]
        pads = [torch.zeros(b, 1, device=ref.device)]
        if image is not None:
            toks.append(self._image(p, image))
            pads.append(torch.zeros(b, image.shape[1], device=ref.device))
        toks.append(self._text(p, text))
        pads.append(text_pad)
        return self._encode(p, toks, pads)

    def masked(self, p, image, text, text_pad, img_perm, txt_perm):
        """The masked encoder and the decoder: (image output, text output,
        image mask, text mask, mean kept image token, mean kept text token)."""
        c = self.cfg
        b, L, T = image.shape[0], image.shape[1], text.shape[1]
        ki = int(L * (1.0 - c["image_mask_ratio"]))
        kt = int(T * (1.0 - c["text_mask_ratio"]))
        keep_i, keep_t = img_perm[:ki], txt_perm[:kt]
        dev = image.device
        x = self._encode(p, [p[M3 + "cls_token"].expand(b, 1, -1), self._image(p, image)[:, keep_i],
                             self._text(p, text)[:, keep_t]],
                         [torch.zeros(b, 1 + ki, device=dev), text_pad[:, keep_t]])
        cls_x, img_x, txt_x = x[:, :1], x[:, 1:1 + ki], x[:, 1 + ki:]

        def restore(kept, token, perm):
            n = perm.shape[0]
            full = torch.cat([kept, p[M3 + token].expand(b, n - kept.shape[1], -1)], 1)
            return full[:, torch.argsort(perm)]

        def dropped(perm, keep):
            m = torch.ones(b, perm.shape[0], device=dev)
            m[:, perm[:keep]] = 0.0
            return m

        dd = c["dec_emb_dim"]
        proj = M3 + "decoder_input_projection"
        toks = [dense(p, proj, cls_x),
                restore(dense(p, proj, img_x), "image_mask_embedding", img_perm)
                + _pos(sincos_2d(dd, L), image) + p[M3 + "decoder_image_type_embedding"],
                restore(dense(p, proj, txt_x), "text_mask_embedding", txt_perm)
                + _pos(sincos_1d(dd, T), image) + p[M3 + "decoder_text_type_embedding"]]
        y = transformer(p, M3 + "decoder", torch.cat(toks, 1),
                        torch.cat([torch.zeros(b, 1 + L, device=dev), text_pad], 1),
                        c["dec_depth"], c["dec_num_heads"])
        return (dense(p, M3 + "decoder_image_output.Dense_0", y[:, 1:1 + L]),
                dense(p, M3 + "decoder_text_output.Dense_0", y[:, 1 + L:]),
                dropped(img_perm, ki), dropped(txt_perm, kt), img_x.mean(1), txt_x.mean(1))


# -- graph, spectral norm, heads ----------------------------------------------


def rgcn(p, x, src, dst, etype, n_rel: int, edge_mask=None, name="conv"):
    """LeakyReLU_0.2(Σ_r mean_{(s→d, r)} x_s W_r + x W_root + b), W_r =
    Σ_b comp[r, b] basis_b; padded edges (``edge_mask`` False) left out."""
    n = x.shape[0]
    if edge_mask is not None:
        src, dst, etype = src[edge_mask], dst[edge_mask], etype[edge_mask]
    w = torch.einsum("rb,bio->rio", p[f"{name}.comp"], p[f"{name}.basis"])
    out = x @ p[f"{name}.root"] + p[f"{name}.bias"]
    for r in range(n_rel):
        sel = etype == r
        if not bool(sel.any()):
            continue
        s, d = src[sel], dst[sel]
        cnt = torch.zeros(n, device=x.device).index_add_(0, d, torch.ones_like(d, dtype=x.dtype))
        msg = (x[s] @ w[r]) / cnt[d][:, None]
        out = out.index_add(0, d, msg)
    return F.leaky_relu(out, 0.2)


def _l2(v):
    return v / torch.clamp(torch.linalg.norm(v), min=1e-12)


def sn_dense(p, name, x, step: bool = False):
    """A spectrally normalised Dense. ``step`` first runs one power step on
    the stored (u, v) and stores the result in ``p``; either way σ = uᵀWv
    takes the stored vectors, constants to autograd."""
    w = p[f"{name}.weight"]
    if step:
        with torch.no_grad():
            v = _l2(w.T @ p[f"{name}.u"])
            p[f"{name}.u"], p[f"{name}.v"] = _l2(w @ v), v
    sigma = p[f"{name}.u"] @ w @ p[f"{name}.v"]
    return x @ (w / sigma).T + p[f"{name}.bias"]


def relation_embedding(p, cls, step: bool = False):
    """The relation map of a description's cls (two SN layers)."""
    return sn_dense(p, "des_rel_map_layer2", sn_dense(p, "des_rel_map_layer1", cls, step), step)


def generate(p, cls, noise, step: bool = False):
    x = sn_dense(p, "generate_fc_layer", torch.cat([noise, cls], 1), step)
    return std_norm(p, "layer_norm", relation_embedding(p, x, step))


# -- the zero-shot Extractor and the critic -------------------------------------


def extractor(q, sym, pairs, left_meta, right_meta, masks=None, rate=0.2):
    """The Extractor's embedding of [B, 2] symbol pairs; a meta is the
    (connections, degrees) rows of the left or right entities. ``masks``,
    when given, are the ten dropout masks (True keeps) of one matching pass
    whose support is the query batch itself, in its order: e1, e2 of the
    query, e1, e2 of the support, the query's left and right neighbours,
    the support's, the query's support encoder, the support's. The query
    side takes masks 0, 1, 4, 5 and 8."""
    def drop(i, x):
        return x if masks is None else torch.where(masks[i], x / (1.0 - rate), torch.zeros_like(x))

    def nbr(i, conn, deg):
        e = drop(i, sym[conn[..., 1]])
        return torch.tanh(dense(q, "gcn_w", e).sum(-2) / torch.clamp(deg, min=1.0)[..., None])

    ent = torch.tanh(torch.cat([dense(q, "fc1", drop(0, sym[pairs[:, 0]])),
                                dense(q, "fc2", drop(1, sym[pairs[:, 1]]))], -1))
    x = dense(q, "reshape_layer", torch.cat([nbr(4, *left_meta), ent, nbr(5, *right_meta)], -1))
    out = dense(q, "support_encoder.proj2", F.relu(dense(q, "support_encoder.proj1", x)))
    return layer_norm(q, "support_encoder.LayerNorm_0", drop(8, out) + x)


def critic(c, x, centroid, step: bool = False):
    """(logit [B, 1], class scores [B, labels]). ``step`` steps fc_middle
    on the ep-vec branch (the centroid branch then reads the stepped
    vectors) and fc_TF."""
    mid = std_norm(c, "layer_norm", F.leaky_relu(sn_dense(c, "fc_middle", x, step), 0.01))
    cen = std_norm(c, "layer_norm", F.leaky_relu(sn_dense(c, "fc_middle", centroid), 0.01))
    return sn_dense(c, "fc_TF", mid, step), mid @ cen.T


# -- Adam -------------------------------------------------------------------------


class Adam:
    def __init__(self, params: dict, lr_of_step, betas=(0.9, 0.999), eps=1e-8):
        self.p, self.lr_of_step, self.betas, self.eps = params, lr_of_step, betas, eps
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, grads: dict):
        b1, b2 = self.betas
        lr = self.lr_of_step(self.t)
        self.t += 1
        for k, g in grads.items():
            if g is None:
                continue
            m = self.m[k] = b1 * self.m.get(k, torch.zeros_like(g)) + (1 - b1) * g
            v = self.v[k] = b2 * self.v.get(k, torch.zeros_like(g)) + (1 - b2) * g * g
            mh = m / (1 - b1 ** self.t)
            vh = v / (1 - b2 ** self.t)
            self.p[k] = self.p[k] - lr * mh / (vh.sqrt() + self.eps)


def cosine_restarts(lr_max, lr_min, t0, t_mult=2):
    """SGDR: cosine periods t0, t0·t_mult, … from lr_max to lr_min."""
    def lr(step):
        start, t = 0, t0
        while step >= start + t:
            start += t
            t *= t_mult
        count = step - start
        alpha = lr_min / max(lr_max, 1e-12)
        return lr_max * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / t)) + alpha)
    return lr
