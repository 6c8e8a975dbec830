"""ZSL matching networks: Extractor and WGAN critic (port of mre_tpu/models/extractor.py).

``Extractor`` — entity-pair embedding network over a frozen symbol table
(relations + entities + PAD) passed in as a tensor:

* ``forward`` — the episodic matching pass (the JAX ``__call__``): query
  and support pair embeddings and the query scores against the support
  mean. Dropout(0.2) acts on the symbol rows of the neighbor encoder, on
  e1/e2 of the entity encoder and in the SupportEncoder when not
  ``deterministic``; its masks come from a ``DropoutMasks`` in the JAX
  call order;
* ``encode_neighbors`` / ``embed_pairs_precomputed`` — eval pair embeddings
  from per-entity neighbor encodings;
* ``precompute_pair_tables`` — per-entity left/right pre-activations
  (L, R) of the pair embedding;
* ``embed_pairs_factored`` — SupportEncoder(L[left] + R[right]);
* ``embed_pairs_head_shared`` / ``embed_pairs_rel_shared`` — one head per
  query (and one shared candidate list per block), with the
  SupportEncoder's first matmul distributed over the L + R add.

``Discriminator`` — spectral-norm critic producing (middle vector,
real/fake logit, class scores against the centroid matrix).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mre_tpu_torch.models.initializers import Dense
from mre_tpu_torch.models.spectral_norm import SNDense
from mre_tpu_torch.models.transformer import (DropoutMasks, LayerNormalization,
                                              SupportEncoder)


class Extractor(nn.Module):
    dropout = 0.2           # extractor.py:34, and the SupportEncoder's (:43-44)

    def __init__(self, embed_dim: int):
        super().__init__()
        half = embed_dim // 2
        self.embed_dim = embed_dim
        self.gcn_w = Dense(embed_dim, half, kernel_init="xavier_normal")
        self.fc1 = Dense(embed_dim, half, kernel_init="xavier_normal")
        self.fc2 = Dense(embed_dim, half, kernel_init="xavier_normal")
        self.reshape_layer = Dense(4 * half, embed_dim, kernel_init="xavier_normal")
        self.support_encoder = SupportEncoder(embed_dim, 2 * embed_dim, self.dropout)

    def _drop(self, x, drop):
        return x if drop is None else drop(x, self.dropout)

    def encode_neighbors(self, symbols, connections, num_neighbors, drop=None):
        """Mean of projected neighbor-entity embeddings → tanh
        (zsl_module.py:46-59). connections: [..., K, 2] (rel_sym, ent_sym);
        over every entity's row it is the eval paths' neighbor table."""
        ent_embeds = self._drop(symbols[connections[..., 1].long()], drop)
        out = self.gcn_w(ent_embeds).sum(dim=-2)
        out = out / torch.clamp(num_neighbors, min=1.0)[..., None]
        return torch.tanh(out)

    def _entity_encoder(self, e1, e2, drop=None):
        e1 = self._drop(e1, drop)
        e2 = self._drop(e2, drop)
        return torch.tanh(torch.cat([self.fc1(e1), self.fc2(e2)], dim=-1))

    def forward(self, symbols, query, support, query_meta, support_meta,
                deterministic: bool = True, drop: DropoutMasks | None = None):
        """symbols: [num_symbols+1, D]; query/support: [B, 2] symbol ids;
        metas: (left_connections, left_degrees, right_connections,
        right_degrees). Returns (query_embeddings, matching_scores).
        ``drop`` gives the dropout masks when not ``deterministic``."""
        if deterministic:
            drop = None
        elif drop is None:
            raise ValueError("Extractor: deterministic=False needs drop (DropoutMasks)")
        ql_conn, ql_deg, qr_conn, qr_deg = query_meta
        sl_conn, sl_deg, sr_conn, sr_deg = support_meta
        query, support = query.long(), support.long()

        # the JAX call order (extractor.py:69-80), so given masks line up
        q_e = self._entity_encoder(symbols[query[:, 0]], symbols[query[:, 1]], drop)
        s_e = self._entity_encoder(symbols[support[:, 0]], symbols[support[:, 1]], drop)
        q = self.reshape_layer(torch.cat(
            [self.encode_neighbors(symbols, ql_conn, ql_deg, drop), q_e,
             self.encode_neighbors(symbols, qr_conn, qr_deg, drop)], dim=-1))
        s = self.reshape_layer(torch.cat(
            [self.encode_neighbors(symbols, sl_conn, sl_deg, drop), s_e,
             self.encode_neighbors(symbols, sr_conn, sr_deg, drop)], dim=-1))
        q_g = self.support_encoder(q, deterministic, drop)
        s_g = self.support_encoder(s, deterministic, drop)
        s_g = s_g.mean(dim=0, keepdim=True)
        scores = (q_g @ s_g.T).squeeze(-1)
        return q_g, scores

    # -- eval fast paths -----------------------------------------------------

    def embed_pairs_precomputed(self, symbols, nbr_table, pairs, left, right):
        """Eval pair embeddings from precomputed neighbor encodings: pairs
        [N, 2] symbol ids, left/right [N] entity ids into ``nbr_table``
        (extractor.py:92-101)."""
        pairs = pairs.long()
        e = self._entity_encoder(symbols[pairs[..., 0]], symbols[pairs[..., 1]])
        x = self.reshape_layer(torch.cat(
            [nbr_table[left.long()], e, nbr_table[right.long()]], dim=-1))
        return self.support_encoder(x)

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

    def embed_pairs_head_shared(self, L, R, left, right):
        """left [Q] head ids, right [Q, C] candidate ids → [Q, C, D]
        (extractor.py:156-173): the head row goes through the first matmul
        once per query."""
        p1 = self.support_encoder.proj1
        Lr = L[left.long()]                                    # [Q, D]
        Rr = R[right.long()]                                   # [Q, C, D]
        return self._distributed_support_encoder(
            (Lr @ p1.weight.T)[:, None, :], Rr @ p1.weight.T + p1.bias,
            Lr[:, None, :] + Rr)

    def embed_pairs_rel_shared(self, L, R, left, right):
        """left [Q] head ids, right [C] shared candidate ids → [Q, C, D]."""
        p1 = self.support_encoder.proj1
        Lr = L[left.long()]                                    # [Q, D]
        Rr = R[right.long()]                                   # [C, D]
        return self._distributed_support_encoder(
            (Lr @ p1.weight.T)[:, None, :], (Rr @ p1.weight.T + p1.bias)[None, :, :],
            Lr[:, None, :] + Rr[None, :, :])


class Discriminator(nn.Module):
    """WGAN critic (extractor.py:199-214). ``update_sn`` steps the power
    iteration of ``fc_middle`` on the ep_vec branch and of ``fc_TF``; the
    centroid branch then runs ``fc_middle`` on the stepped buffers without
    stepping again."""

    def __init__(self, dim: int = 200):
        super().__init__()
        self.fc_middle = SNDense(dim, dim)
        self.fc_TF = SNDense(dim, 1)
        self.layer_norm = LayerNormalization(dim)

    def forward(self, ep_vec, centroid_matrix, update_sn: bool = False):
        middle = self.layer_norm(F.leaky_relu(
            self.fc_middle(ep_vec, update_stats=update_sn), negative_slope=0.01))
        centroid = self.layer_norm(F.leaky_relu(
            self.fc_middle(centroid_matrix, update_stats=False), negative_slope=0.01))
        logit_tf = self.fc_TF(middle, update_stats=update_sn)
        class_scores = middle @ centroid.T
        return middle, logit_tf, class_scores
