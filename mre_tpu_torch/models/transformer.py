"""ViT-style transformer stack (port of mre_tpu/models/transformer.py).

Submodule names follow the flax tree (Block_i / LayerNorm_0|1 /
Attention_0 / Dense_0|1 / TransformerMLP_0.fc1|fc2), so ``interop`` maps
the JAX parameters onto ``state_dict`` keys one to one.

Semantics kept from the JAX package:
* Block and Transformer LayerNorms are flax ``nn.LayerNorm``: eps 1e-6;
* ``LayerNormalization`` uses the unbiased std, adds eps to the std, and is
  an identity when axis 1 has size 1 (module/submodule.py:58-77);
* GELU is exact;
* qkv comes from one Dense(3·dim) reshaped to [B, N, 3, H, hd];
* ``padding_mask`` is 1.0 at PAD keys, which get the logit −1e7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mre_tpu_torch.models.initializers import Dense
from mre_tpu_torch.ops.attention import fused_attention

LN_EPS = 1e-6   # flax nn.LayerNorm default


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class LayerNormalization(nn.Module):
    """Std-based layer norm with affine params ``a_2``/``b_2``."""

    def __init__(self, d_hid: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.a_2 = nn.Parameter(torch.ones(d_hid))
        self.b_2 = nn.Parameter(torch.zeros(d_hid))

    def forward(self, z):
        if z.dim() >= 2 and z.shape[1] == 1:
            return z
        mu = z.mean(dim=-1, keepdim=True)
        var = ((z - mu) ** 2).sum(dim=-1, keepdim=True) / (z.shape[-1] - 1)
        out = (z - mu) / (torch.sqrt(var) + self.eps)
        return out * self.a_2 + self.b_2


class TransformerMLP(nn.Module):
    def __init__(self, dim: int, out_dim: int, hidden_ratio: int = 4):
        super().__init__()
        self.fc1 = Dense(dim, hidden_ratio * dim)
        self.fc2 = Dense(hidden_ratio * dim, out_dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Attention(nn.Module):
    """Multi-head self-attention; ``attention_impl``: auto | kernel | torch
    (the JAX auto | pallas | xla). ``auto`` launches the Hopper kernel for
    CUDA tensors and runs the plain version for CPU tensors."""

    def __init__(self, dim: int, num_heads: int = 8, use_bias: bool = False,
                 attention_impl: str = "auto"):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.attention_impl = attention_impl
        self.Dense_0 = Dense(dim, 3 * dim, bias=use_bias)
        self.Dense_1 = Dense(dim, dim)

    def forward(self, x, padding_mask=None):
        batch, n, channels = x.shape
        head_dim = self.dim // self.num_heads
        qkv = self.Dense_0(x).reshape(batch, n, 3, self.num_heads, head_dim)
        qkv = qkv.permute(2, 0, 3, 1, 4)                 # [3, B, H, N, hd]
        q, k, v = (t.contiguous() for t in qkv.unbind(0))
        if padding_mask is not None:
            padding_mask = padding_mask.to(torch.float32).contiguous()
        out = fused_attention(q, k, v, padding_mask, head_dim ** -0.5,
                              self.attention_impl)
        out = out.transpose(1, 2).reshape(batch, n, channels)
        return self.Dense_1(out)


class Block(nn.Module):
    def __init__(self, emb_dim: int = 256, num_heads: int = 8, mlp_ratio: int = 4,
                 attention_impl: str = "auto"):
        super().__init__()
        self.LayerNorm_0 = layer_norm(emb_dim)
        self.Attention_0 = Attention(emb_dim, num_heads, True, attention_impl)
        self.LayerNorm_1 = layer_norm(emb_dim)
        self.TransformerMLP_0 = TransformerMLP(emb_dim, emb_dim, mlp_ratio)

    def forward(self, inputs, padding_mask=None):
        x = self.Attention_0(self.LayerNorm_0(inputs), padding_mask)
        inputs = inputs + x
        return inputs + self.TransformerMLP_0(self.LayerNorm_1(inputs))


class Transformer(nn.Module):
    def __init__(self, emb_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: int = 4, attention_impl: str = "auto"):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"Block_{i}", Block(emb_dim, num_heads, mlp_ratio,
                                                attention_impl))
        self.LayerNorm_0 = layer_norm(emb_dim)

    def forward(self, x, padding_mask=None):
        for i in range(self.depth):
            x = getattr(self, f"Block_{i}")(x, padding_mask)
        return self.LayerNorm_0(x)


class MLP(nn.Module):
    """Output head: optional input LN, ``depth`` residual GELU layers, final
    projection. Names follow flax's compact numbering (LayerNorm_i,
    Dense_i)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, depth: int,
                 input_norm: bool = True):
        super().__init__()
        self.input_norm = input_norm
        self.depth = depth
        ln = 0
        if input_norm:
            self.add_module("LayerNorm_0", layer_norm(in_dim))
            ln = 1
        d = in_dim
        for i in range(depth):
            self.add_module(f"Dense_{i}", Dense(d, hidden_dim))
            self.add_module(f"LayerNorm_{ln + i}", layer_norm(hidden_dim))
            d = hidden_dim
        self.add_module(f"Dense_{depth}", Dense(d, output_dim))

    def forward(self, x):
        ln = 0
        if self.input_norm:
            x = self.LayerNorm_0(x)
            ln = 1
        for i in range(self.depth):
            y = F.gelu(getattr(self, f"Dense_{i}")(x), approximate="none")
            y = getattr(self, f"LayerNorm_{ln + i}")(y)
            x = x + y if i > 0 else y
        return getattr(self, f"Dense_{self.depth}")(x)


class SupportEncoder(nn.Module):
    """Residual 2-layer FFN with LN (module/submodule.py:240-258); eval form
    (dropout is an identity)."""

    def __init__(self, d_model: int, d_inner: int):
        super().__init__()
        self.proj1 = Dense(d_model, d_inner, kernel_init="xavier_normal")
        self.proj2 = Dense(d_inner, d_model, kernel_init="xavier_normal")
        self.LayerNorm_0 = layer_norm(d_model)

    def forward(self, x):
        out = self.proj2(F.relu(self.proj1(x)))
        return self.LayerNorm_0(out + x)
