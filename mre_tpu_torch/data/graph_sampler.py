"""Neighbor-sampled subgraph batches with static shapes (numpy copy of
mre_tpu/data/graph_sampler.py).

The reference's torch_geometric ``NeighborSampler(edge_index, sizes=[4],
batch_size=12)`` loop (main.py:93-129): every batch has the same padded
shapes (seed nodes + up to ``size`` sampled incoming edges per seed). The
same seed gives the same batches as the JAX package, bit for bit: the same
incoming-edge CSR, the same ``rng.choice(..., replace=False)`` draws, and
padding by repeating ``n_id[0]``.

Yields dicts with:
  n_id        [N_max] global node ids (padded by repeating node 0)
  node_mask   [N_max] bool
  edge_index  [2, E_max] local (src, dst) ids into n_id
  edge_type   [E_max]
  e_id        [E_max] original edge ids (for relation descriptions)
  edge_mask   [E_max] bool
"""

from __future__ import annotations

import numpy as np


class NeighborSampler:
    def __init__(self, edge_index: np.ndarray, edge_type: np.ndarray,
                 num_nodes: int, size: int = 4, batch_size: int = 12,
                 shuffle: bool = True, seed: int = 0):
        self.edge_index = np.asarray(edge_index, np.int64)
        self.edge_type = np.asarray(edge_type, np.int64)
        self.num_nodes = num_nodes
        self.size = size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

        # CSR over INCOMING edges only (indexed by destination), as the
        # reference's graph has no inverse edges (module/data.py:161)
        dst = self.edge_index[1]
        self._edges_by_dst = np.argsort(dst, kind="stable")
        self._offsets = np.zeros(num_nodes + 1, np.int64)
        np.add.at(self._offsets, dst + 1, 1)
        self._offsets = np.cumsum(self._offsets)

        self.n_max = batch_size * (1 + size)
        self.e_max = batch_size * size

    def __len__(self):
        return (self.num_nodes + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        nodes = np.arange(self.num_nodes)
        if self.shuffle:
            self._rng.shuffle(nodes)
        for i in range(0, self.num_nodes, self.batch_size):
            yield self.sample_batch(nodes[i:i + self.batch_size])

    def sample_batch(self, seeds: np.ndarray) -> dict:
        picked = []
        for s in seeds:
            lo, hi = self._offsets[s], self._offsets[s + 1]
            if hi > lo:
                k = min(self.size, hi - lo)
                sel = self._rng.choice(hi - lo, k, replace=False)
                picked.append(self._edges_by_dst[lo + sel])
        e_id = np.concatenate(picked) if picked else np.zeros(0, np.int64)

        src = self.edge_index[0, e_id]
        dst = self.edge_index[1, e_id]
        n_id = np.unique(np.concatenate([seeds, src, dst]))
        src_l = np.searchsorted(n_id, src).astype(np.int32)
        dst_l = np.searchsorted(n_id, dst).astype(np.int32)

        n_pad = self.n_max - len(n_id)
        e_pad = self.e_max - len(e_id)
        return {
            "n_id": np.pad(n_id.astype(np.int32), (0, n_pad),
                           constant_values=n_id[0] if len(n_id) else 0),
            "node_mask": np.pad(np.ones(len(n_id), bool), (0, n_pad)),
            "edge_index": np.stack([np.pad(src_l, (0, e_pad)), np.pad(dst_l, (0, e_pad))]),
            "edge_type": np.pad(self.edge_type[e_id].astype(np.int32), (0, e_pad)),
            "e_id": np.pad(e_id.astype(np.int32), (0, e_pad)),
            "edge_mask": np.pad(np.ones(len(e_id), bool), (0, e_pad)),
        }


def edges_from_tasks(triples: np.ndarray):
    """Global edge arrays from an (h, r, t) triple list (module/data.py:149-166)."""
    triples = np.asarray(triples)
    edge_index = np.stack([triples[:, 0], triples[:, 2]])
    edge_type = triples[:, 1]
    return edge_index, edge_type
