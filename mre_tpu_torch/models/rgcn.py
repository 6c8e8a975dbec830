"""Relational GCN with basis decomposition (port of mre_tpu/models/rgcn.py).

Per-relation weights W_r = Σ_b comp[r,b]·B_b, mean aggregation over
incoming edges per (destination, relation), root weight and bias
(torch_geometric ``RGCNConv(in, out, num_relations, num_bases=30)`` as the
reference uses it, module/model.py:552-570). Padded edges (``edge_mask``
False) are parked in an extra segment and contribute nothing.

The segment sums are ``index_add_``. On CUDA it adds with atomics, so the
order of the additions, and the last bits of each sum, change from run to
run; callers compare with a tolerance, not bitwise.
"""

from __future__ import annotations

import torch
from torch import nn

from mre_tpu_torch.models.initializers import xavier_uniform


class RGCNConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_relations: int,
                 num_bases: int = 30):
        super().__init__()
        self.num_relations = num_relations
        self.basis = nn.Parameter(torch.empty(num_bases, in_channels, out_channels))
        self.comp = nn.Parameter(torch.empty(num_relations, num_bases))
        self.root = nn.Parameter(torch.empty(in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    @torch.no_grad()
    def init_(self, gen):
        for p in (self.basis, self.comp, self.root):
            p.copy_(xavier_uniform(tuple(p.shape), gen))
        self.bias.zero_()

    def forward(self, x, edge_index, edge_type, num_nodes=None, edge_mask=None):
        """x: [N, in]; edge_index: [2, E] (src, dst) local ids; edge_type:
        [E]; edge_mask: [E] bool, False for padded edge slots."""
        N = x.shape[0] if num_nodes is None else num_nodes
        R = self.num_relations
        src, dst = edge_index[0].long(), edge_index[1].long()
        edge_type = edge_type.long()
        if edge_mask is None:
            edge_mask = torch.ones_like(src, dtype=torch.bool)

        xb = torch.einsum("ni,bio->nbo", x, self.basis)           # [N, B, out]
        msg = torch.einsum("ebo,eb->eo", xb[src], self.comp[edge_type])

        seg = torch.where(edge_mask, dst * R + edge_type,
                          torch.full_like(dst, N * R))
        w = edge_mask.to(x.dtype)
        counts = torch.zeros(N * R + 1, dtype=x.dtype, device=x.device
                             ).index_add_(0, seg, w)
        norm = torch.where(edge_mask, 1.0 / torch.clamp(counts[seg], min=1.0),
                           torch.zeros_like(w))
        park = torch.where(edge_mask, dst, torch.full_like(dst, N))
        agg = torch.zeros(N + 1, msg.shape[1], dtype=x.dtype, device=x.device
                          ).index_add_(0, park, msg * norm[:, None])[:N]
        return agg + x @ self.root + self.bias
