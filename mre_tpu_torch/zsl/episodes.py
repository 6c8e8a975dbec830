"""ZSL symbol table and neighbor connections (numpy copy of mre_tpu/zsl/episodes.py).

The serving path needs the relations-then-entities-then-PAD symbol space
and the per-entity neighbor matrix. ``EpisodeSampler`` (pretraining and GAN
batches) comes with training.
"""

from __future__ import annotations

import numpy as np


class SymbolTable:
    """Relations-then-entities-then-PAD symbol space
    (module/zsl_module.py:209-233)."""

    def __init__(self, r2id: dict, e2id: dict):
        self.rel_names = [k for k in r2id if k not in ("", "OOV")]
        self.ent_names = [k for k in e2id if k not in ("", "OOV")]
        self.symbol2id = {}
        i = 0
        for k in self.rel_names:
            self.symbol2id[k] = i
            i += 1
        for k in self.ent_names:
            self.symbol2id[k] = i
            i += 1
        self.pad_id = i
        self.num_symbols = i
        self.r2id = r2id
        self.e2id = e2id

    def build_embedding(self, ent_embs: np.ndarray, rel_embs: np.ndarray) -> np.ndarray:
        """Stack [rel embeddings; entity embeddings; zero PAD] in symbol order."""
        dim = rel_embs.shape[1]
        rows = [rel_embs[self.r2id[k]] for k in self.rel_names]
        rows += [ent_embs[self.e2id[k]] for k in self.ent_names]
        rows.append(np.zeros(dim, rel_embs.dtype))
        return np.stack(rows)


def build_connections(tasks_list, symbol2id, e2id, num_ents, pad_id,
                      max_neighbor=50):
    """Neighbor matrix [num_ents, max_neighbor, 2] of (rel_sym, ent_sym),
    degrees [num_ents] — from train+test task triples, both directions
    (module/zsl_module.py:239-268)."""
    connections = np.full((num_ents, max_neighbor, 2), pad_id, np.int32)
    neighbors: list[list] = [[] for _ in range(num_ents)]
    for tasks in tasks_list:
        for rel, rows in tasks.items():
            for e1, r, e2 in rows:
                neighbors[e2id[e1]].append((symbol2id[r], symbol2id[e2]))
                neighbors[e2id[e2]].append((symbol2id[r], symbol2id[e1]))
    degrees = np.zeros(num_ents, np.float32)
    for i, ns in enumerate(neighbors):
        ns = ns[:max_neighbor]
        degrees[i] = len(ns)
        for j, (rs, es) in enumerate(ns):
            connections[i, j, 0] = rs
            connections[i, j, 1] = es
    return connections, degrees
