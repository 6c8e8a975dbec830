"""Spectrally normalized Dense layer, eval form (mre_tpu/models/spectral_norm.py).

In eval, σ = uᵀ W v comes from the STORED ``u`` and ``v`` buffers with no
power-iteration step (spectral_norm.py:62-66; torch keeps both buffers).
The training-time update step comes with the training slice.

``weight`` is [out, in] (the flax ``kernel`` transposed); ``u`` [out] and
``v`` [in] are the flax ``"spectral"`` collection.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mre_tpu_torch.models.initializers import uniform

_EPS = 1e-12


def _l2(v):
    return v / torch.clamp(torch.linalg.norm(v), min=_EPS)


class SNDense(nn.Module):
    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.register_buffer("u", torch.zeros(features))
        self.register_buffer("v", torch.zeros(in_features))

    @torch.no_grad()
    def init_(self, gen):
        # torch Linear default: U(±1/sqrt(fan_in)) for kernel and bias
        bound = 1.0 / float(self.in_features) ** 0.5
        self.weight.copy_(uniform((self.in_features, self.features), bound, gen).T)
        if self.bias is not None:
            self.bias.copy_(uniform((self.features,), bound, gen))
        self.u.copy_(_l2(torch.randn(self.features, generator=gen)))
        self.v.copy_(_l2(self.weight.T @ self.u))

    def forward(self, x):
        sigma = torch.einsum("o,oi,i->", self.u, self.weight, self.v)
        return F.linear(x, self.weight / sigma, self.bias)
