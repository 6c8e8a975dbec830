"""ZSL host-side index math (numpy copy of mre_tpu/zsl/episodes.py).

* ``SymbolTable`` — the relations-then-entities-then-PAD symbol space;
* ``build_connections`` — the per-entity neighbor matrix;
* ``EpisodeSampler`` — few-shot episodes for Extractor pretraining,
  per-relation centroid batches and per-relation GAN batches
  (module/utils.py:548-690). It keeps ``np.random.default_rng(seed)``: with
  the same seed and call order it gives the JAX package's arrays bit for
  bit.
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


class EpisodeSampler:
    """All episodic batch shapes used by pretraining and GAN training."""

    def __init__(self, train_tasks: dict, rel2candidates: dict, e1rel_e2: dict,
                 symbols: SymbolTable, seed: int = 0):
        self.train_tasks = train_tasks
        self.rel2candidates = rel2candidates
        self.e1rel_e2 = e1rel_e2
        self.symbols = symbols
        self.rng = np.random.default_rng(seed)

        # task sampling probability ∝ candidate count (utils.py:556-564)
        self.task_pool = list(train_tasks.keys())
        t_num = []
        for k in self.task_pool:
            n = len(rel2candidates.get(k, []))
            t_num.append(0 if n <= 20 else min(n, 1000))
        total = max(sum(t_num), 1)
        self.task_prob = np.asarray([x / total for x in t_num])
        if self.task_prob.sum() == 0:
            self.task_prob = np.full(len(self.task_pool), 1.0 / len(self.task_pool))

        rela_sorted = sorted(train_tasks.keys())
        self.rela2label = {r: i for i, r in enumerate(rela_sorted)}
        self.label_num = len(rela_sorted)

    # -- helpers -----------------------------------------------------------

    def _sym_pair(self, tri):
        s = self.symbols.symbol2id
        return [s[tri[0]], s[tri[2]]]

    def _false_for(self, tri, candidates):
        """Rejection-sample a corrupted tail from the candidate pool,
        excluding known-true tails (utils.py:600-611)."""
        e2id = self.symbols.e2id
        known = set(self.e1rel_e2.get(tri[0] + tri[1], []))
        for _ in range(1000):
            noise = candidates[self.rng.integers(len(candidates))]
            if noise in e2id and noise not in known and noise != tri[2]:
                return noise
        # exhausted: fall back to the exact pre-filtered valid subset — an
        # unvalidated candidate here could KeyError downstream (not in e2id)
        # or silently hand a known-TRUE tail to training as a "false" pair
        valid = [c for c in candidates
                 if c in e2id and c not in known and c != tri[2]]
        if valid:
            return valid[self.rng.integers(len(valid))]
        # degenerate pool (every candidate true/unknown): keep the reference's
        # infinite-loop semantics bounded — return the least-harmful option
        in_vocab = [c for c in candidates if c in e2id]
        return in_vocab[self.rng.integers(len(in_vocab))] if in_vocab else tri[2]

    # -- Extractor pretraining episodes (utils.py:548-613) ------------------

    def extractor_episode(self, batch_size: int, few: int, sub_epoch: int):
        s2 = self.symbols.symbol2id
        e2id = self.symbols.e2id
        support, query, false = [], [], []
        s_l, s_r, q_l, q_r, f_l, f_r = [], [], [], [], [], []
        task = self.task_pool[self.rng.choice(len(self.task_pool), p=self.task_prob)]
        candidates = self.rel2candidates[task]
        for _ in range(sub_epoch):
            rows = list(self.train_tasks[task])
            self.rng.shuffle(rows)
            support_rows = rows[:few]
            support += [self._sym_pair(t) for t in support_rows]
            s_l += [e2id[t[0]] for t in support_rows]
            s_r += [e2id[t[2]] for t in support_rows]
            rest = rows[few:]
            if not rest:
                continue
            if len(rest) < batch_size:
                q_rows = [rest[self.rng.integers(len(rest))] for _ in range(batch_size)]
            else:
                idx = self.rng.choice(len(rest), batch_size, replace=False)
                q_rows = [rest[i] for i in idx]
            query += [self._sym_pair(t) for t in q_rows]
            q_l += [e2id[t[0]] for t in q_rows]
            q_r += [e2id[t[2]] for t in q_rows]
            for t in q_rows:
                noise = self._false_for(t, candidates)
                false.append([s2[t[0]], s2[noise]])
                f_l.append(e2id[t[0]])
                f_r.append(e2id[noise])
        return (np.asarray(support, np.int32), np.asarray(query, np.int32),
                np.asarray(false, np.int32), np.asarray(s_l), np.asarray(s_r),
                np.asarray(q_l), np.asarray(q_r), np.asarray(f_l), np.asarray(f_r))

    # -- centroid batches (utils.py:615-623) --------------------------------

    def centroid_batch(self, relation_name: str):
        e2id = self.symbols.e2id
        rows = self.train_tasks[relation_name]
        query = np.asarray([self._sym_pair(t) for t in rows], np.int32)
        left = np.asarray([e2id[t[0]] for t in rows])
        right = np.asarray([e2id[t[2]] for t in rows])
        return query, left, right, self.rela2label[relation_name]

    # -- GAN batches (utils.py:625-690) --------------------------------------

    def gan_batch(self, batch_size: int, gan_batch_rela: int, r2id: dict):
        e2id = self.symbols.e2id
        rel_ids, labels = [], []
        query, q_l, q_r = [], [], []
        false, f_l, f_r = [], [], []
        pool = list(self.task_pool)
        self.rng.shuffle(pool)
        for task in pool[:gan_batch_rela]:
            candidates = self.rel2candidates[task]
            if len(candidates) <= 20:
                continue
            rows = list(self.train_tasks[task])
            if not rows:
                continue
            if len(rows) < batch_size:
                q_rows = [rows[self.rng.integers(len(rows))] for _ in range(batch_size)]
            else:
                idx = self.rng.choice(len(rows), batch_size, replace=False)
                q_rows = [rows[i] for i in idx]
            query += [self._sym_pair(t) for t in q_rows]
            q_l += [e2id[t[0]] for t in q_rows]
            q_r += [e2id[t[2]] for t in q_rows]
            for t in q_rows:
                noise = self._false_for(t, candidates)
                false.append([self.symbols.symbol2id[t[0]], self.symbols.symbol2id[noise]])
                f_l.append(e2id[t[0]])
                f_r.append(e2id[noise])
            rel_ids += [r2id[task]] * batch_size
            labels += [self.rela2label[task]] * batch_size
        return (np.asarray(rel_ids), np.asarray(query, np.int32), np.asarray(q_l),
                np.asarray(q_r), np.asarray(false, np.int32), np.asarray(f_l),
                np.asarray(f_r), np.asarray(labels))
