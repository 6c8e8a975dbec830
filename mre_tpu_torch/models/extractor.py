"""ZSL Extractor, evaluation paths (port of mre_tpu/models/extractor.py).

Entity-pair embedding network over a frozen symbol table (relations +
entities + PAD) passed in as a tensor. This slice ports what the
``rel_shared`` zero-shot evaluation runs:

* ``encode_neighbors`` — per-entity neighbor encodings [n_ent, D/2];
* ``precompute_pair_tables`` — per-entity left/right pre-activations
  (L, R) of the pair embedding;
* ``embed_pairs_factored`` — SupportEncoder(L[left] + R[right]);
* ``embed_pairs_rel_shared`` — one shared candidate list per query block,
  with the SupportEncoder's first matmul distributed over the L + R add.

Dropout is an identity in eval. The episodic ``forward``, the Discriminator
and pretraining come with the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mre_tpu_torch.models.initializers import Dense
from mre_tpu_torch.models.transformer import SupportEncoder


class Extractor(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        half = embed_dim // 2
        self.embed_dim = embed_dim
        self.gcn_w = Dense(embed_dim, half, kernel_init="xavier_normal")
        self.fc1 = Dense(embed_dim, half, kernel_init="xavier_normal")
        self.fc2 = Dense(embed_dim, half, kernel_init="xavier_normal")
        self.reshape_layer = Dense(4 * half, embed_dim, kernel_init="xavier_normal")
        self.support_encoder = SupportEncoder(embed_dim, 2 * embed_dim)

    def encode_neighbors(self, symbols, connections, degrees):
        """Mean of projected neighbor-entity embeddings → tanh
        (zsl_module.py:46-59). connections: [n_ent, K, 2] (rel_sym, ent_sym)."""
        ent_embeds = symbols[connections[..., 1].long()]
        out = self.gcn_w(ent_embeds).sum(dim=-2)
        out = out / torch.clamp(degrees, min=1.0)[..., None]
        return torch.tanh(out)

    def precompute_pair_tables(self, symbols, nbr_table, ent_sym):
        """(L, R), each [n_entities, D]: x(e1, e2) = L[e1] + R[e2] with the
        reshape kernel split over its concat rows (extractor.py:105-129)."""
        half = self.embed_dim // 2
        kernel = self.reshape_layer.weight.T                   # flax [in, out]
        bias = self.reshape_layer.bias
        W_nl, W_e1, W_e2, W_nr = (kernel[:half], kernel[half:2 * half],
                                  kernel[2 * half:3 * half], kernel[3 * half:])
        e_sym = symbols[ent_sym.long()]
        L = (nbr_table @ W_nl + torch.tanh(self.fc1(e_sym)) @ W_e1) + bias
        R = torch.tanh(self.fc2(e_sym)) @ W_e2 + nbr_table @ W_nr
        return L, R

    def embed_pairs_factored(self, L, R, left, right):
        """Pair embeddings from the factored tables: [N] entity ids."""
        return self.support_encoder(L[left.long()] + R[right.long()])

    def _distributed_support_encoder(self, A, B, residual):
        """The SupportEncoder with its first matmul distributed over the
        L + R add; its LayerNorm is inlined as in extractor.py:135-154
        (var = E[y²] − μ², eps 1e-6)."""
        se = self.support_encoder
        ln = se.LayerNorm_0
        h = F.relu(A + B)
        y = (h @ se.proj2.weight.T + se.proj2.bias) + residual
        y32 = y.float()
        mu = y32.mean(dim=-1, keepdim=True)
        var = (y32 * y32).mean(dim=-1, keepdim=True) - mu * mu
        norm = (y32 - mu) * torch.rsqrt(var + 1e-6)
        return norm.to(y.dtype) * ln.weight + ln.bias

    def embed_pairs_rel_shared(self, L, R, left, right):
        """left [Q] head ids, right [C] shared candidate ids → [Q, C, D]."""
        p1 = self.support_encoder.proj1
        Lr = L[left.long()]                                    # [Q, D]
        Rr = R[right.long()]                                   # [C, D]
        return self._distributed_support_encoder(
            (Lr @ p1.weight.T)[:, None, :], (Rr @ p1.weight.T + p1.bias)[None, :, :],
            Lr[:, None, :] + Rr[None, :, :])
