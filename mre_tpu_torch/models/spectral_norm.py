"""Spectrally normalized Dense layer (port of mre_tpu/models/spectral_norm.py).

Semantics of torch's spectral norm with n_power_iterations=1, eps=1e-12:

* ``update_stats=True`` (training) runs one power-iteration step on the
  stored buffers, v ← l2(Wᵀu), u ← l2(W v), stores both without gradient,
  and normalizes by σ = uᵀ W v with the NEW u, v (spectral_norm.py:56-61);
* ``update_stats=False`` (eval) takes σ from the STORED ``u`` and ``v``
  with no step (spectral_norm.py:62-66; torch keeps both buffers).

Either way u and v are constants to autograd: the gradient flows through
W only, in σ and in the product.

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

    def forward(self, x, update_stats: bool = False):
        if update_stats:
            with torch.no_grad():
                v = _l2(self.weight.T @ self.u)
                # new tensors, not in-place copies: the old buffers may be
                # saved for the backward of an earlier call
                self.u = _l2(self.weight @ v)
                self.v = v
        sigma = torch.einsum("o,oi,i->", self.u, self.weight, self.v)
        return F.linear(x, self.weight / sigma, self.bias)
