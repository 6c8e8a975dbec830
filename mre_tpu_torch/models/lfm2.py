"""LFM2-MoE (LiquidAI's LFM2-8B-A1B, ``model_type`` ``lfm2_moe``) as the
multimodal encoder: the port's own, which the JAX package does not have.

``M3AE`` puts ``LFM2`` in place of its ViT encoder when its config names
``encoder="lfm2"`` (``core/config.py``'s ``ENCODER_PRESETS``): M3AE's input
assembly stays (patch and text embeddings, modality type embeddings,
sin-cos positions, the cls token first, in the role of LFM2's BOS token),
and the pooled vector is the final-normed state at each row's last
non-PAD position, since under causal attention position 0 sees nothing.
LFM2 itself has no absolute positions; the sin-cos tables are M3AE's.

Each layer is ``h = x + op(RMSNorm(x)); out = h + ffn(RMSNorm(h))``, and an
RMSNorm (LFM2's ``embedding_norm``) follows the stack. As the published
``lfm2_moe`` modelling code has them:

* RMSNorm: ``x · rsqrt(mean(x²) + eps) · weight``;
* the gated short convolution (``layer_types`` "conv"): ``B, C, x̃ =
  split₃(W_in x)``, ``y = C ⊙ causal_dwconv(B ⊙ x̃)`` with a depthwise kernel
  of ``conv_L_cache`` taps per channel, left-padded, no bias; ``W_out y``;
* attention ("full_attention"): q, k, v projections (``num_kv_heads`` KV
  heads), an RMSNorm per head on q and on k over the head's channels
  (QK-norm), RoPE (``rope_theta``, rotate-half), causal softmax attention
  at scale 1/√hd, query head h reading KV head h // (H / H_kv)
  (``ops.attention.grouped_attention``: the kernel on CUDA), an output
  projection;
* the FFN: SwiGLU ``w2(silu(w1 x) ⊙ w3 x)`` of ``intermediate_size`` in the
  first ``num_dense_layers`` layers; after them a sparse MoE of
  ``num_experts`` SwiGLU experts of ``moe_intermediate_size``: scores
  ``s = sigmoid(W_r x)``, experts chosen by ``topk(s + expert_bias)``,
  weighted by the unbiased ``s`` of the chosen ones divided by their sum
  (``norm_topk_prob``) times ``routed_scaling_factor``. Every token is
  routed (none dropped); the rows are grouped by expert (a stable sort) and
  each expert's SwiGLU runs on its own rows only.

No layer reads the padding mask: rows are right-padded ([cls | patches |
text] with the text's PAD last), so under causal attention and the causal
convolution a valid position never sees a PAD one, and adding right
padding leaves every valid position as it was.

``compute_dtype`` reaches the projections, the depthwise convolution, the
experts and the attention, as in the M3AE blocks: the norms, the router and
the residual stream stay float32. The module computes a forward only:
training it, and the mesh's tensor-parallel FFN, are not supported
(``FusionTrainer`` and ``parallel.mesh.shard_transformer_ffn`` refuse it).

Names. The norms are ``LayerNorm_0`` (the operator's), ``LayerNorm_1`` (the
FFN's), ``q_LayerNorm`` and ``k_LayerNorm``, and the stack's final
``LayerNorm_0``, after the ViT blocks' names; the stacked expert weights
keep their input dimension last (``w1``, ``w3`` [E, F, D], ``w2`` [E, D,
F]). The weights are drawn on the device the module was built on
(``init_``), N(0, 0.02²) for every matrix and kernel as the published
initialiser has them, norm scales 1, expert bias 0: ``FusionTrainer``
builds this encoder on its device, so no host draw of billions of values
holds set-up back. Draws on the CPU and on a card differ for one seed.

Spans (``core/profiling.py``): ``lfm2.conv``, ``lfm2.attn`` (⊃
``attention.fwd``), ``lfm2.moe`` ⊃ ``moe.route``, ``moe.experts``.
Counters: ``moe.routed``, the token-expert assignments; and
``moe.max_expert_rows``, the largest expert's rows, summed over calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mre_tpu_torch.core.profiling import count, span
from mre_tpu_torch.models.initializers import dense
from mre_tpu_torch.ops.attention import grouped_attention

INIT_STD = 0.02   # the published initializer_range


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


def rope_tables(n: int, head_dim: int, theta: float, device):
    """(cos, sin) [n, head_dim] of positions 0..n-1, rotate-half layout."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, device=device, dtype=torch.float32)
                          / head_dim)
    freqs = torch.outer(torch.arange(n, device=device, dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], -1)
    return emb.cos(), emb.sin()


def apply_rope(x, cos, sin):
    """x: [B, H, N, hd]."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rotated * sin


class ShortConv(nn.Module):
    """The gated short convolution (``layer_types`` "conv")."""

    def __init__(self, dim: int, taps: int, dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.in_proj = nn.Linear(dim, 3 * dim, bias=False)
        self.kernel = nn.Parameter(torch.empty(dim, taps))   # taps[j] reads position t - (L-1) + j
        self.out_proj = nn.Linear(dim, dim, bias=False)

    def forward(self, x):
        dtype = self.compute_dtype
        b, c, xt = dense(self.in_proj, x, dtype).chunk(3, dim=-1)
        bx = b * xt
        taps = self.kernel.shape[1]
        w = self.kernel.to(dtype)
        y = bx * w[:, taps - 1]
        for j in range(taps - 1):
            shift = taps - 1 - j           # tap j reads the position `shift` steps back
            y[:, shift:] += bx[:, :-shift] * w[:, j]
        return dense(self.out_proj, c * y, dtype).float()


class GroupedAttention(nn.Module):
    """Causal attention with QK-norm, RoPE and grouped KV heads."""

    def __init__(self, dim: int, heads: int, kv_heads: int, eps: float, impl: str, dtype):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, dim // heads
        self.attention_impl = impl
        self.compute_dtype = dtype
        self.q_proj = nn.Linear(dim, heads * self.head_dim, bias=False)
        self.k_proj = nn.Linear(dim, kv_heads * self.head_dim, bias=False)
        self.v_proj = nn.Linear(dim, kv_heads * self.head_dim, bias=False)
        self.out_proj = nn.Linear(heads * self.head_dim, dim, bias=False)
        self.q_LayerNorm = RMSNorm(self.head_dim, eps)
        self.k_LayerNorm = RMSNorm(self.head_dim, eps)

    def forward(self, x, cos, sin):
        batch, n, _ = x.shape
        dtype, hd = self.compute_dtype, self.head_dim

        def heads(proj, n_heads, norm=None):
            y = dense(proj, x, dtype).view(batch, n, n_heads, hd)
            if norm is not None:
                y = norm(y)
            return y.transpose(1, 2)                        # [B, n_heads, N, hd]

        q = apply_rope(heads(self.q_proj, self.heads, self.q_LayerNorm), cos, sin)
        k = apply_rope(heads(self.k_proj, self.kv_heads, self.k_LayerNorm), cos, sin)
        v = heads(self.v_proj, self.kv_heads)
        q, k, v = (t.to(dtype).contiguous() for t in (q, k, v))
        with span("attention.fwd"):
            out = grouped_attention(q, k, v, None, hd ** -0.5, impl=self.attention_impl)
        out = out.transpose(1, 2).reshape(batch, n, self.heads * hd)
        return dense(self.out_proj, out, dtype).float()


class SwiGLU(nn.Module):
    def __init__(self, dim: int, width: int, dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.w1 = nn.Linear(dim, width, bias=False)
        self.w3 = nn.Linear(dim, width, bias=False)
        self.w2 = nn.Linear(width, dim, bias=False)

    def forward(self, x):
        dtype = self.compute_dtype
        h = F.silu(dense(self.w1, x, dtype)) * dense(self.w3, x, dtype)
        return dense(self.w2, h, dtype).float()


class SparseMoE(nn.Module):
    """The sparse MoE FFN (module docstring). ``select`` is the routing
    decision alone, a method of its own so that a caller can read which
    experts each token went to."""

    def __init__(self, dim: int, width: int, experts: int, top_k: int, norm_topk_prob: bool,
                 scaling: float, expert_bias: bool, dtype):
        super().__init__()
        self.top_k, self.norm_topk_prob, self.scaling = top_k, norm_topk_prob, scaling
        self.compute_dtype = dtype
        self.gate = nn.Linear(dim, experts, bias=False)
        self.w1 = nn.Parameter(torch.empty(experts, width, dim))
        self.w3 = nn.Parameter(torch.empty(experts, width, dim))
        self.w2 = nn.Parameter(torch.empty(experts, dim, width))
        if expert_bias:
            self.register_buffer("expert_bias", torch.zeros(experts))
        else:
            self.expert_bias = None

    def select(self, biased: torch.Tensor) -> torch.Tensor:
        """[T, E] biased scores → [T, top_k] chosen experts."""
        return torch.topk(biased, self.top_k, dim=-1).indices

    def route(self, x: torch.Tensor):
        """[T, D] → (chosen experts [T, k], their weights [T, k])."""
        scores = torch.sigmoid(F.linear(x, self.gate.weight))
        biased = scores if self.expert_bias is None else scores + self.expert_bias
        chosen = self.select(biased)
        w = scores.gather(1, chosen)
        if self.norm_topk_prob:
            w = w / w.sum(-1, keepdim=True)
        return chosen, w * self.scaling

    def forward(self, x):
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        with span("moe.route"):
            chosen, w = self.route(x)
        with span("moe.experts"):
            y = self.experts(x, chosen)
        return (y * w[..., None]).sum(1).view(shape)

    def experts(self, x, chosen):
        """Each expert's SwiGLU on the rows routed to it: [T, k, D], slot for
        slot as ``chosen``."""
        dtype, k = self.compute_dtype, chosen.shape[1]
        flat = chosen.reshape(-1)
        order = torch.argsort(flat, stable=True)
        rows = torch.bincount(flat, minlength=self.w1.shape[0]).tolist()
        count("moe.routed", len(flat))
        count("moe.max_expert_rows", max(rows))
        xs = x.index_select(0, order // k).to(dtype)
        ys = torch.empty(len(flat), x.shape[1], dtype=dtype, device=x.device)
        start = 0
        for e, n in enumerate(rows):
            if n:
                h = xs[start:start + n]
                h = F.silu(F.linear(h, self.w1[e].to(dtype))) * F.linear(h, self.w3[e].to(dtype))
                ys[start:start + n] = F.linear(h, self.w2[e].to(dtype))
            start += n
        del xs
        y = torch.empty_like(ys)
        y[order] = ys                           # back to (token, slot) order
        return y.view(-1, k, x.shape[1]).float()


class Layer(nn.Module):
    def __init__(self, cfg, kind: str, dense: bool, impl: str, dtype):
        super().__init__()
        d, eps = cfg.emb_dim, cfg.norm_eps
        self.kind = kind
        self.LayerNorm_0 = RMSNorm(d, eps)
        if kind == "conv":
            self.conv = ShortConv(d, cfg.conv_L_cache, dtype)
        elif kind == "full_attention":
            self.self_attn = GroupedAttention(d, cfg.num_heads, cfg.num_kv_heads, eps, impl, dtype)
        else:
            raise ValueError(f"LFM2: unknown layer type {kind!r} (conv | full_attention)")
        self.LayerNorm_1 = RMSNorm(d, eps)
        if dense:
            self.feed_forward = SwiGLU(d, cfg.intermediate_size, dtype)
        else:
            self.feed_forward = SparseMoE(d, cfg.moe_intermediate_size, cfg.num_experts,
                                          cfg.num_experts_per_tok, cfg.norm_topk_prob,
                                          cfg.routed_scaling_factor, cfg.use_expert_bias, dtype)

    def forward(self, x, cos, sin):
        h = self.LayerNorm_0(x)
        if self.kind == "conv":
            with span("lfm2.conv"):
                h = self.conv(h)
        else:
            with span("lfm2.attn"):
                h = self.self_attn(h, cos, sin)
        x = x + h
        h = self.LayerNorm_1(x)
        if isinstance(self.feed_forward, SparseMoE):
            with span("lfm2.moe"):
                return x + self.feed_forward(h)
        return x + self.feed_forward(h)


class LFM2(nn.Module):
    """The layer stack of ``cfg.layer_types`` (the first
    ``cfg.num_dense_layers`` with the dense SwiGLU) and the final RMSNorm;
    ``forward`` takes and gives ``[B, N, emb_dim]``, as the ViT encoder."""

    def __init__(self, cfg, attention_impl: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rope_theta = cfg.rope_theta
        self.head_dim = cfg.emb_dim // cfg.num_heads
        self.depth = len(cfg.layer_types)
        for i, kind in enumerate(cfg.layer_types):
            self.add_module(f"Layer_{i}", Layer(cfg, kind, i < cfg.num_dense_layers,
                                                attention_impl, dtype))
        self.LayerNorm_0 = RMSNorm(cfg.emb_dim, cfg.norm_eps)

    @torch.no_grad()
    def init_(self, gen):
        """Every weight of the stack drawn on its own device, from a seed
        drawn from ``gen`` (module docstring)."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        device = self.LayerNorm_0.weight.device
        g = torch.Generator(device=device).manual_seed(seed)
        for name, p in self.named_parameters():
            if "LayerNorm" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, INIT_STD, generator=g)
        for b in self.buffers():
            b.zero_()

    def forward(self, x, padding_mask=None, deterministic: bool = True, drop=None):
        """x: [B, N, D]. ``padding_mask`` is not read (module docstring)."""
        cos, sin = rope_tables(x.shape[1], self.head_dim, self.rope_theta, x.device)
        x = x.float()
        for i in range(self.depth):
            x = getattr(self, f"Layer_{i}")(x, cos, sin)
        return self.LayerNorm_0(x)


def last_valid(x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
    """[B, N, D] states → [B, 1, D] at each row's last non-PAD position
    (``padding_mask`` [B, N], 1.0 = PAD)."""
    valid = (padding_mask == 0).flip(1).float()
    last = x.shape[1] - 1 - valid.argmax(1)
    return x[torch.arange(x.shape[0], device=x.device), last][:, None]
