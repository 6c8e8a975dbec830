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
* ``padding_mask`` is 1.0 at PAD keys, which get the logit −1e7;
* ``compute_dtype`` (float32 or bfloat16) is the dtype of the attention's
  and the MLP's Dense layers over float32 parameters, as flax
  ``Dense(dtype=...)``: their outputs, q, k, v and the GELU activations are
  in it, while every LayerNorm and the residual stream stay float32
  (``inputs + x`` promotes, transformer.py:157-170);
* dropout and DropPath act when a pass is not ``deterministic``, at JAX's
  six sites in JAX's call order (attention probabilities, ``proj_drop``,
  DropPath, MLP after GELU, MLP after ``fc2``, DropPath); their masks come
  from a ``DropoutMasks``. A rate of 0 draws no mask, as in flax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mre_tpu_torch.models.initializers import Dense, dense
from mre_tpu_torch.ops.attention import fused_attention

LN_EPS = 1e-6   # flax nn.LayerNorm default
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` name; the port computes in
    float32 or bfloat16 (the kernel's two instantiations)."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r} not in {tuple(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU. Below float32 it is ``jax.nn.gelu``'s op sequence,
    ``0.5 · x · erfc(−x · √½)`` with √½ and every product rounded to
    ``x``'s dtype, as JAX computes it op by op; in float32 one ``F.gelu``."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    sqrt_half = torch.tensor(0.5 ** 0.5, dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


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
    def __init__(self, dim: int, out_dim: int, hidden_ratio: int = 4, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.compute_dtype = dtype
        self.fc1 = Dense(dim, hidden_ratio * dim)
        self.fc2 = Dense(hidden_ratio * dim, out_dim)

    def forward(self, x, deterministic: bool = True, drop=None):
        dropping = self.dropout and not deterministic
        x = gelu(dense(self.fc1, x, self.compute_dtype))
        if dropping:
            x = drop(x, self.dropout)
        x = dense(self.fc2, x, self.compute_dtype)
        return drop(x, self.dropout) if dropping else x


class TensorParallelMLP(nn.Module):
    """A ``TransformerMLP`` split Megatron-style over the model axis of a
    mesh (``parallel.mesh.shard_transformer_ffn``; the JAX shardings of
    ``mesh.py:68-89``): this rank computes with ``fc1``'s output columns
    and bias and ``fc2``'s input rows for its model index, as views of the
    replicated module's weights (no copy; they follow its updates). The
    ``fc2`` products are summed over the model group, then ``fc2``'s bias
    is added once. Dropout would need the replicated layer's masks, so a
    non-deterministic pass with a rate raises."""

    def __init__(self, mlp: TransformerMLP, mesh):
        super().__init__()
        width = mlp.fc1.out_features // mesh.n_model
        cols = slice(mesh.model_index * width, (mesh.model_index + 1) * width)
        self.group = mesh.model_group
        self.dropout = mlp.dropout
        self.compute_dtype = mlp.compute_dtype
        self.w1, self.b1 = mlp.fc1.weight[cols], mlp.fc1.bias[cols]
        self.w2, self.b2 = mlp.fc2.weight[:, cols], mlp.fc2.bias

    def forward(self, x, deterministic: bool = True, drop=None):
        from mre_tpu_torch.parallel import mesh as pmesh

        if self.dropout and not deterministic:
            raise NotImplementedError("TensorParallelMLP: dropout in a tensor-parallel "
                                      "FFN is not supported")
        dtype = self.compute_dtype
        x = pmesh.copy_to_group(x, self.group)
        if dtype == torch.float32:
            x = F.linear(x, self.w1, self.b1)
        else:                                   # flax's rounding, as ``dense``
            x = F.linear(x.to(dtype), self.w1.to(dtype)) + self.b1.to(dtype)
        y = F.linear(gelu(x).to(dtype), self.w2.to(dtype))
        y = pmesh.all_reduce_sum(y, self.group, replicated_grad=True)
        return y + self.b2.to(dtype)


def _attention_dropped(q, k, v, padding_mask, scale, rate, drop):
    """JAX's plain attention with dropout on the probabilities
    (transformer.py:129-137): float32 logits and softmax, the output in
    float32."""
    att = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if padding_mask is not None:
        att = att.masked_fill(padding_mask[:, None, None, :] > 0, -1e7)
    att = drop(torch.softmax(att, dim=-1), rate)
    return torch.einsum("bhqk,bhkd->bhqd", att, v.float())


class Attention(nn.Module):
    """Multi-head self-attention; ``attention_impl``: auto | kernel | torch
    (the JAX auto | pallas | xla). ``auto`` launches the Hopper kernel for
    CUDA tensors and runs the plain version for CPU tensors. A pass with
    attention dropout (``att_drop > 0``, not ``deterministic``) takes the
    plain attention, as JAX does (transformer.py:124): no kernel there."""

    def __init__(self, dim: int, num_heads: int = 8, use_bias: bool = False,
                 attention_impl: str = "auto", att_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.attention_impl = attention_impl
        self.att_drop = att_drop
        self.proj_drop = proj_drop
        self.compute_dtype = dtype
        self.Dense_0 = Dense(dim, 3 * dim, bias=use_bias)
        self.Dense_1 = Dense(dim, dim)

    def forward(self, x, padding_mask=None, deterministic: bool = True, drop=None):
        batch, n, channels = x.shape
        head_dim = self.dim // self.num_heads
        qkv = dense(self.Dense_0, x, self.compute_dtype).reshape(
            batch, n, 3, self.num_heads, head_dim)
        qkv = qkv.permute(2, 0, 3, 1, 4)                 # [3, B, H, N, hd]
        q, k, v = (t.contiguous() for t in qkv.unbind(0))
        if padding_mask is not None:
            padding_mask = padding_mask.to(torch.float32).contiguous()
        scale = head_dim ** -0.5
        if self.att_drop and not deterministic:
            out = _attention_dropped(q, k, v, padding_mask, scale, self.att_drop, drop)
        else:
            out = fused_attention(q, k, v, padding_mask, scale, self.attention_impl)
        out = out.transpose(1, 2).reshape(batch, n, channels)
        out = dense(self.Dense_1, out, self.compute_dtype)
        if self.proj_drop and not deterministic:
            out = drop(out, self.proj_drop)
        return out


class Block(nn.Module):
    def __init__(self, emb_dim: int = 256, num_heads: int = 8, mlp_ratio: int = 4,
                 attention_impl: str = "auto", att_drop: float = 0.0, drop: float = 0.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path = drop_path
        self.LayerNorm_0 = layer_norm(emb_dim)
        self.Attention_0 = Attention(emb_dim, num_heads, True, attention_impl,
                                     att_drop, drop, dtype)
        self.LayerNorm_1 = layer_norm(emb_dim)
        self.TransformerMLP_0 = TransformerMLP(emb_dim, emb_dim, mlp_ratio, drop, dtype)

    def _drop_path(self, x, deterministic, drop):
        return drop.path(x, self.drop_path) if self.drop_path and not deterministic else x

    def forward(self, inputs, padding_mask=None, deterministic: bool = True, drop=None):
        x = self.Attention_0(self.LayerNorm_0(inputs), padding_mask, deterministic, drop)
        inputs = inputs + self._drop_path(x, deterministic, drop)
        x = self.TransformerMLP_0(self.LayerNorm_1(inputs), deterministic, drop)
        return inputs + self._drop_path(x, deterministic, drop)


class Transformer(nn.Module):
    """Pre-LN block stack + final LayerNorm.

    ``att_drop``, ``drop`` and ``drop_path`` are the JAX config's dropout
    and stochastic-depth rates; ``dtype`` is the compute dtype of the
    blocks' Dense layers. A pass that is not ``deterministic`` with a
    nonzero rate takes its masks from ``drop`` (a ``DropoutMasks``)."""

    def __init__(self, emb_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: int = 4, attention_impl: str = "auto",
                 att_drop: float = 0.0, drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        self.dropping = bool(att_drop or drop or drop_path)
        for i in range(depth):
            self.add_module(f"Block_{i}", Block(emb_dim, num_heads, mlp_ratio, attention_impl,
                                                att_drop, drop, drop_path, dtype))
        self.LayerNorm_0 = layer_norm(emb_dim)

    def forward(self, x, padding_mask=None, deterministic: bool = True, drop=None):
        if self.dropping and not deterministic and drop is None:
            raise ValueError("Transformer: a non-deterministic pass with nonzero dropout "
                             "rates needs drop (DropoutMasks)")
        for i in range(self.depth):
            x = getattr(self, f"Block_{i}")(x, padding_mask, deterministic, drop)
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


class DropoutMasks:
    """The masks of a sequence of flax ``nn.Dropout`` and ``DropPath``
    calls, handed out in call order. Each is drawn from ``generator`` or,
    when ``masks`` is given, taken from it (e.g. the JAX step's own masks
    in the tests).

    * ``drop(x, rate)`` — ``nn.Dropout``: keep where U[0, 1) < 1 − rate, as
      ``jax.random.bernoulli``; a given mask is boolean (True = keep) of
      ``x``'s shape. Kept values are scaled by 1 / (1 − rate), as flax does.
    * ``drop.path(x, rate)`` — ``DropPath`` (transformer.py:50-63): one
      0/1 value per sample, ``floor(keep + U)`` over ``[B, 1, …]``, applied
      as ``x / keep · mask`` (the float32 mask promotes a bfloat16 ``x``,
      as in JAX); a given mask has that ``[B, 1, …]`` shape.

    ``rows`` (a ``parallel.mesh.RowShard``) serves a data-parallel rank
    that holds those rows of each masked tensor: every mask is drawn (or
    taken) at the full batch and cut to the rank's rows, so the ranks
    together apply the masks of the undivided batch."""

    def __init__(self, generator: torch.Generator | None = None, masks=None, rows=None):
        if (generator is None) == (masks is None):
            raise ValueError("DropoutMasks needs exactly one of generator, masks")
        self.generator = generator
        self._given = None if masks is None else list(masks)
        self.rows = rows
        self.used = 0

    def _full(self, shape) -> tuple:
        return tuple(shape) if self.rows is None else (self.rows.n,) + tuple(shape[1:])

    def _cut(self, mask: torch.Tensor) -> torch.Tensor:
        return mask if self.rows is None else self.rows.local(mask)

    def _take(self, shape, dtype, device) -> torch.Tensor:
        if self.used == len(self._given):
            raise ValueError(f"DropoutMasks: only {len(self._given)} masks given")
        mask = torch.as_tensor(self._given[self.used], dtype=dtype, device=device)
        if tuple(mask.shape) != self._full(shape):
            raise ValueError(f"DropoutMasks: mask {self.used} has shape "
                             f"{tuple(mask.shape)}, expected {self._full(shape)}")
        return mask

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        keep = 1.0 - rate
        if self._given is not None:
            mask = self._take(x.shape, torch.bool, x.device)
        else:
            mask = torch.rand(self._full(x.shape), generator=self.generator,
                              device=x.device) < keep
        self.used += 1
        return torch.where(self._cut(mask), x / keep, torch.zeros_like(x))

    def path(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        keep = 1.0 - rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        if self._given is not None:
            mask = self._take(shape, torch.float32, x.device)
        else:
            mask = torch.floor(keep + torch.rand(self._full(shape), generator=self.generator,
                                                 device=x.device))
        self.used += 1
        return x / keep * self._cut(mask)

    def check_all_used(self):
        """Given masks must be used up by the step they were given for."""
        if self._given is not None and self.used != len(self._given):
            raise ValueError(f"DropoutMasks: {len(self._given)} masks given, "
                             f"{self.used} used")


class SupportEncoder(nn.Module):
    """Residual 2-layer FFN with LN (module/submodule.py:240-258), with
    Dropout(``dropout``) on ``proj2``'s output when not ``deterministic``
    (transformer.py:217-232); its mask comes from ``drop``."""

    def __init__(self, d_model: int, d_inner: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.proj1 = Dense(d_model, d_inner, kernel_init="xavier_normal")
        self.proj2 = Dense(d_inner, d_model, kernel_init="xavier_normal")
        self.LayerNorm_0 = layer_norm(d_model)

    def forward(self, x, deterministic: bool = True, drop: DropoutMasks | None = None):
        out = self.proj2(F.relu(self.proj1(x)))
        if not deterministic:
            out = drop(out, self.dropout)
        return self.LayerNorm_0(out + x)
