"""The plain reference of the ``lfm2-8b-a1b`` configuration: LiquidAI's
LFM2-8B-A1B (huggingface.co/LiquidAI/LFM2-8B-A1B, config.json, model_type
``lfm2_moe``) as the multimodal encoder of the relation-extrapolation
model, in plain PyTorch operations and float32, with no kernel, grouping
or batching of the program. It imports nothing of the program. ``run``
sets TF32 off for its float32 products (``tf32=True`` is the benchmark's
control, the precision below float32).

Parameters come as one dict under the benchmark's names (``weights.py``
draws them over the program's ``state_dict``); the encoder's leaves lie
under ``M3AEmodel.encoder.``. The published equations (the ``lfm2_moe``
modelling code), per layer ``h = x + op(RMSNorm(x)); out = h +
ffn(RMSNorm(h))`` and a final RMSNorm (``embedding_norm``):

* RMSNorm: ``x · rsqrt(mean(x²) + eps) · weight``;
* conv: ``B, C, x̃ = split₃(W_in x)``, ``y = C ⊙ conv1d(B ⊙ x̃)``, depthwise,
  ``conv_L_cache`` taps, padded by ``L − 1`` and cut to the sequence (as
  ``nn.Conv1d(groups=D, padding=L−1)[..., :N]``), no bias; ``W_out y``;
* attention: q, k, v projections; an RMSNorm per head on q and on k
  (QK-norm); RoPE, θ ``rope_theta``, rotate-half; one causal softmax over
  every key with K and V repeated over each group of query heads, scale
  1/√head_dim; the output projection;
* FFN: SwiGLU ``w2(silu(w1 x) ⊙ w3 x)`` in the first ``num_dense_layers``
  layers; then the sparse MoE: ``s = sigmoid(W_r x)``, experts chosen by
  ``topk(s + expert_bias)``, weights the chosen unbiased ``s`` over their sum
  (``norm_topk_prob``) times ``routed_scaling_factor``. Every expert runs on
  every token and is weighted by its (mostly zero) routing weight: no
  grouping.

Departures from the published model, all shared with the program: the
input is M3AE's token layout ([cls | 256 patches | text], or [cls |
description]) with M3AE's patch, text and type embeddings and sin-cos
positions (LFM2 has no absolute positions and embeds text ids alone); the
pooled vector is each row's final-normed state at its last non-PAD
position (rows are right-padded, so no valid position sees a PAD one);
weights are random, float32 in place of the published bfloat16.

Routing near ties. With random weights a token's top-k can hold two
experts whose biased scores differ by round-off, and the program's and
this float32 computation can then choose apart; such a flip moves the
whole row by O(1) and says nothing of either. So a reference pass may be
given the program's choices (``follow``): where this reference's own
margin for the program's choice (``margins``) is under ``tie``, it routes
as the program did, and everywhere else as its own scores say.
``route_margin`` is then the largest such margin at which the program
chose otherwise.

The serving round (``run``) follows ``serve.run`` of the M3AE reference,
with this encoder's pooled vectors in place of M3AE's cls token, and uses
the same RGCN, relation map, generator head and Extractor.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import data as rdata
from portbench.reference import model as rm

ENC = "M3AEmodel.encoder."


def rms_norm(p, name, x, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * p[f"{name}.weight"]


def short_conv(p, name, x):
    """The gated short convolution of [B, N, D] states."""
    n, d = x.shape[1], x.shape[2]
    b, c, xt = (x @ p[f"{name}.in_proj.weight"].T).chunk(3, dim=-1)
    kernel = p[f"{name}.kernel"]
    bx = (b * xt).transpose(1, 2)                                   # [B, D, N]
    conv = F.conv1d(bx, kernel[:, None, :], padding=kernel.shape[1] - 1, groups=d)[..., :n]
    return (c * conv.transpose(1, 2)) @ p[f"{name}.out_proj.weight"].T


def rope(x, theta):
    """Rotate-half RoPE of [B, H, N, hd] at positions 0..N-1."""
    n, hd = x.shape[2], x.shape[3]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().to(x.dtype), ang.sin().to(x.dtype)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def causal_attention(q, k, v):
    """One causal softmax of [B, H, N, hd] queries over [B, H_kv, N, hd]
    keys and values, each KV head repeated over its group of query heads."""
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    n = q.shape[2]
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1), float("-inf"))
    return torch.softmax(s, -1) @ v


def attention(p, name, x, cfg):
    b, n, d = x.shape
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps = d // h, cfg["norm_eps"]

    def heads(proj, count, norm=None):
        y = (x @ p[f"{name}.{proj}.weight"].T).view(b, n, count, hd)
        if norm is not None:
            y = rms_norm(p, f"{name}.{norm}", y, eps)
        return y.transpose(1, 2)

    q = rope(heads("q_proj", h, "q_LayerNorm"), cfg["rope_theta"])
    k = rope(heads("k_proj", hkv, "k_LayerNorm"), cfg["rope_theta"])
    v = heads("v_proj", hkv)
    out = causal_attention(q, k, v).transpose(1, 2).reshape(b, n, d)
    return out @ p[f"{name}.out_proj.weight"].T


def swiglu(w1, w3, w2, x):
    return (F.silu(x @ w1.T) * (x @ w3.T)) @ w2.T


def margins(scores, a, b):
    """Per token, the largest score in ``b`` and not in ``a`` minus the
    least in ``a`` and not in ``b`` (0 where they choose the same set): how
    far ``scores`` must move for ``a``'s choice to be its top-k when ``b``
    is. ``scores`` [T, E]; ``a``, ``b`` [T, k] expert indices."""
    ma = torch.zeros_like(scores, dtype=torch.bool).scatter_(1, a, True)
    mb = torch.zeros_like(scores, dtype=torch.bool).scatter_(1, b, True)
    only_b, only_a = mb & ~ma, ma & ~mb
    hi = scores.masked_fill(~only_b, float("-inf")).amax(1)
    lo = scores.masked_fill(~only_a, float("inf")).amin(1)
    return torch.where(only_a.any(1), hi - lo, torch.zeros_like(hi))


def moe(p, name, x, cfg, follow=None, tie: float = 0.0):
    """The sparse MoE over [T, D] tokens, every expert dense and masked.
    Returns (output, biased scores [T, E], the experts used [T, k],
    followed [T] bool): ``follow`` [T, k], the program's choices, is taken
    where its margin is under ``tie``."""
    scores = torch.sigmoid(x @ p[f"{name}.gate.weight"].T)
    bias = p.get(f"{name}.expert_bias")
    biased = scores if bias is None or not cfg["use_expert_bias"] else scores + bias
    own = torch.topk(biased, cfg["num_experts_per_tok"], dim=-1).indices
    followed = torch.zeros(len(x), dtype=torch.bool, device=x.device)
    chosen = own
    if follow is not None:
        follow = follow.long()
        differ = (follow.sort(-1).values != own.sort(-1).values).any(-1)
        followed = differ & (margins(biased, follow, own) < tie)
        chosen = torch.where(followed[:, None], follow, own)
    w = scores.gather(1, chosen)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    w = torch.zeros_like(scores).scatter_(1, chosen, w * cfg["routed_scaling_factor"])
    out = torch.zeros_like(x)
    for e in range(scores.shape[1]):
        out = out + w[:, e:e + 1] * swiglu(p[f"{name}.w1"][e], p[f"{name}.w3"][e],
                                           p[f"{name}.w2"][e], x)
    return out, biased, chosen, followed


class LFM2:
    """The encoder of one configuration (``cfg``: the configuration file's
    keys), over M3AE's input assembly (``model.M3AE``'s embeddings)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.m3ae = rm.M3AE(dict(cfg, emb_dim=cfg["hidden_size"]))

    def moe_layers(self) -> list:
        c = self.cfg
        return [i for i in range(len(c["layer_types"])) if i >= c["num_dense_layers"]]

    def encode(self, p, x, follow=None, tie: float = 0.0):
        """[B, N, D] tokens → (final-normed states, per MoE layer (biased
        scores, experts used, followed), each [B, N, ...])."""
        c = self.cfg
        b, n, d = x.shape
        routes = []
        for i, kind in enumerate(c["layer_types"]):
            name = f"{ENC}Layer_{i}"
            h = rms_norm(p, f"{name}.LayerNorm_0", x, c["norm_eps"])
            if kind == "conv":
                x = x + short_conv(p, f"{name}.conv", h)
            else:
                x = x + attention(p, f"{name}.self_attn", h, c)
            h = rms_norm(p, f"{name}.LayerNorm_1", x, c["norm_eps"]).reshape(b * n, d)
            f = f"{name}.feed_forward"
            if i < c["num_dense_layers"]:
                y = swiglu(p[f"{f}.w1.weight"], p[f"{f}.w3.weight"], p[f"{f}.w2.weight"], h)
            else:
                fl = None if follow is None else follow[len(routes)].reshape(b * n, -1)
                y, biased, chosen, followed = moe(p, f, h, c, fl, tie)
                routes.append((biased.view(b, n, -1), chosen.view(b, n, -1), followed.view(b, n)))
            x = x + y.view(b, n, d)
        return rms_norm(p, f"{ENC}LayerNorm_0", x, c["norm_eps"]), routes

    def pooled(self, p, image, text, text_pad, follow=None, tie: float = 0.0):
        """([B, D] states at each row's last non-PAD position, routes);
        ``image`` may be None."""
        ref = text if image is None else image
        b, dev = ref.shape[0], ref.device
        toks = [p[rm.M3 + "cls_token"].expand(b, 1, -1)]
        pads = [torch.zeros(b, 1, device=dev)]
        if image is not None:
            toks.append(self.m3ae._image(p, image))
            pads.append(torch.zeros(b, image.shape[1], device=dev))
        toks.append(self.m3ae._text(p, text))
        pads.append(text_pad)
        states, routes = self.encode(p, torch.cat(toks, 1), follow, tie)
        pad = torch.cat(pads, 1)
        last = pad.shape[1] - 1 - (pad == 0).flip(1).float().argmax(1)
        return states[torch.arange(b, device=dev), last], routes


def _tokens(lines, max_length: int, vocab_size: int):
    """Ids and PAD masks of each line, by ``data.tokenize`` over the
    configuration's vocabulary."""
    out = [rdata.tokenize(line, max_length, vocab_size) for line in lines]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def _pooled_rows(enc, p, image_fn, text, pad, n: int, block: int, device, follow, tie):
    """Pooled vectors of rows 0..n-1 in blocks, and per MoE layer the
    routes of all rows (biased scores, experts used, followed)."""
    out, routes = [], []
    for i in range(0, n, block):
        ids = np.arange(i, min(i + block, n))
        img = None if image_fn is None else torch.as_tensor(image_fn(ids), device=device)
        fl = None if follow is None else [f[ids] for f in follow]
        v, r = enc.pooled(p, img, torch.as_tensor(text[ids], device=device),
                          torch.as_tensor(pad[ids], device=device), fl, tie)
        out.append(v)
        routes.append(r)
    per_layer = [tuple(torch.cat(parts) for parts in zip(*(r[l] for r in routes)))
                 for l in range(len(routes[0]))]
    return torch.cat(out), per_layer


@contextlib.contextmanager
def _tf32(enabled: bool):
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    old = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = enabled
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = old


def run(cfg: dict, p: dict, q: dict, d: dict, noises: torch.Tensor, pipeline_seed: int,
        device, block: int = 64, follow: dict | None = None, tie: float = 0.0,
        tf32: bool = False) -> dict:
    """The serving round as ``serve.run`` of the M3AE reference: {ent, rel,
    generated, scores}, and ``routes``: "ent" and "rel" per MoE layer
    (biased scores [rows, N, E], experts used [rows, N, k], followed [rows,
    N]), and "gen" {relation id: the same of its description's pass}.
    ``follow``: the program's choices in the same layout ([rows, N, k] per
    MoE layer), taken where their margin is under ``tie``.

    Each unseen relation's description is encoded again for its generated
    vectors, as the program's generator encodes it in a pass of its own: a
    tie there may fall otherwise than in the relation sweep. ``tf32`` sets
    the float32 products' precision: off for the reference, on for the
    benchmark's control."""
    with torch.no_grad(), _tf32(tf32):
        return _run(cfg, p, q, d, noises, pipeline_seed, device, block, follow, tie)


def _run(cfg, p, q, d, noises, pipeline_seed, device, block, follow, tie) -> dict:
    enc = LFM2(cfg)
    follow = follow or {}
    ids, pads = _tokens([rec[-1] for rec in d["mm_info"]], cfg["text_tokens"], cfg["vocab_size"])
    rid, rpad = _tokens(d["rel_des"], cfg["description_tokens"], cfg["vocab_size"])
    n_ent, n_rel = len(d["e2id"]), len(d["r2id"])

    def images(ent_ids):
        seeds = rdata.eval_seeds(ent_ids, pipeline_seed)
        imgs = np.stack([rdata.entity_image(d["mm_info"][e], s, cfg["image_size"], False)
                         for e, s in zip(ent_ids, seeds)])
        return rdata.patches(imgs, cfg["patch_size"])

    cls, ent_routes = _pooled_rows(enc, p, images, ids, pads, n_ent, block, device,
                                   follow.get("ent"), tie)
    tri = torch.as_tensor(rdata.train_triples(d), device=device)
    ent = rm.rgcn(p, cls, tri[:, 0], tri[:, 2], tri[:, 1], n_rel)
    rel_cls, rel_routes = _pooled_rows(enc, p, None, rid, rpad, n_rel, block, device,
                                       follow.get("rel"), tie)
    rel = rm.relation_embedding(p, rel_cls)

    sym = torch.as_tensor(rdata.symbol_table(d, ent.cpu().numpy(), rel.cpu().numpy()),
                          device=device)
    conn, deg = rdata.neighbours(d, cfg["max_neighbor"])
    conn, deg = torch.as_tensor(conn, device=device), torch.as_tensor(deg, device=device)
    s2, _ = rdata.symbols(d)
    e2id = d["e2id"]
    generated, scores = [], []
    gen_routes = {}
    for rname, queries in d["test_candidates"].items():
        r = d["r2id"][rname]
        pooled, route = enc.pooled(p, None, torch.as_tensor(rid[[r]], device=device),
                                   torch.as_tensor(rpad[[r]], device=device),
                                   follow.get("gen", {}).get(r), tie)
        gen_routes[r] = route
        g = rm.generate(p, pooled.expand(noises.shape[0], -1), noises)
        generated.append(g)
        vbar = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)
        vbar = vbar.mean(0)
        for key, cands in queries.items():
            head = key.split("\t")[0]
            h = e2id[head]
            c_ids = [e2id[c] for c in cands]
            pairs = torch.as_tensor([[s2[head], s2[c]] for c in cands], device=device)
            hh = torch.full((len(cands),), h, device=device)
            cc = torch.as_tensor(c_ids, device=device)
            emb = rm.extractor(q, sym, pairs, (conn[hh], deg[hh]), (conn[cc], deg[cc]))
            emb = emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True), min=1e-12)
            s = (emb @ vbar).double().cpu().numpy()
            scores.append((float(s[0]), s[1:], c_ids[0], np.asarray(c_ids[1:])))
    return dict(ent=ent, rel=rel, generated=generated, scores=scores,
                routes=dict(ent=ent_routes, rel=rel_routes, gen=gen_routes))
