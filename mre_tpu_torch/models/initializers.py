"""Seeded initializers that follow the flax ones in distribution.

The port cannot reproduce flax's numbers (different generators), so weights
carried from the JAX package go through ``interop``; a port model built on
its own draws its weights from these, each from an explicit
``torch.Generator`` on the CPU, so a seed gives the same model on any device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to ±2


def _fans(shape) -> tuple[int, int]:
    """flax/jax fan convention: kernel [..., in, out], receptive = prod(rest)."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def xavier_uniform(shape, gen) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def xavier_normal(shape, gen) -> torch.Tensor:
    """jax ``xavier_normal``: truncated normal (±2σ), variance 2/(in+out)."""
    fan_in, fan_out = _fans(shape)
    std = math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen) * (hi - lo) + lo
    return torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0) * std


def normal(shape, std: float, gen) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def uniform(shape, bound: float, gen) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


_KERNEL_INITS = {"xavier_uniform": xavier_uniform, "xavier_normal": xavier_normal}


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None = None):
    """flax ``Dense(dtype=...)``: input, kernel and bias cast to ``dtype``
    (default: the kernel's own). Below float32 the product is rounded to
    ``dtype`` before the bias is added, as flax adds the bias after
    ``dot_general``; in float32 it is one ``F.linear``."""
    dtype = layer.weight.dtype if dtype is None else dtype
    if dtype == torch.float32:
        return F.linear(x, layer.weight, layer.bias)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` whose ``init_`` draws the flax Dense init: the kernel
    from ``kernel_init`` on the flax [in, out] shape, the bias zero. Its
    forward is ``dense`` (flax's rounding when the module is cast to
    bfloat16)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 kernel_init: str = "xavier_uniform"):
        super().__init__(in_features, out_features, bias=bias)
        self.kernel_init = kernel_init

    def forward(self, x):
        return dense(self, x)

    @torch.no_grad()
    def init_(self, gen):
        kernel = _KERNEL_INITS[self.kernel_init](
            (self.in_features, self.out_features), gen)
        self.weight.copy_(kernel.T)
        if self.bias is not None:
            self.bias.zero_()


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of ``model`` from one seeded CPU generator, in
    module registration order. Call before moving the model to a device."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if hasattr(m, "init_"):
            m.init_(gen)
    return model
