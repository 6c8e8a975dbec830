"""Zero-shot relation evaluation, relation-shared path (port of mre_tpu/eval/zero_shot.py).

Every query of an unseen relation ranks the same shared candidate list
(reference utils/gen_mode_candidates.py), so each chunk of queries carries
its relation's shared row: the candidate gather and the SupportEncoder's
first matmul are computed once per chunk. The host builds the padded query
stream; the device ranks it chunk by chunk (the JAX ``lax.scan`` becomes a
Python loop).

Ranks are pessimistic, 1 + #greater + #tied, and a duplicate candidate
counts once per occurrence (zero_shot.py:207-223, 280-286).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def metrics_from_ranks(ranks: np.ndarray) -> dict:
    ranks = np.asarray(ranks, np.float64)
    return dict(
        hits10=float(np.mean(ranks <= 10)),
        hits5=float(np.mean(ranks <= 5)),
        hits1=float(np.mean(ranks <= 1)),
        mrr=float(np.mean(1.0 / ranks)),
        n=int(len(ranks)),
    )


def _unit(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


@torch.no_grad()
def _rank_stream_rel_shared(embed_rel_block: Callable, embed_true: Callable,
                            heads, trues, shared, mask, vbar) -> np.ndarray:
    """heads/trues [nc, chunk]; shared [nc, C]; mask [nc, chunk, C]
    per-occurrence candidate counts; vbar [nc, chunk, D]. Returns ranks
    [nc·chunk] (host)."""
    ranks = []
    for c in range(heads.shape[0]):
        emb = _unit(embed_rel_block(heads[c], shared[c]).float())    # [chunk, C, D]
        te = _unit(embed_true(heads[c], trues[c]).float())           # [chunk, D]
        v = vbar[c]
        scores = torch.einsum("qcd,qd->qc", emb, v)
        true_s = torch.einsum("qd,qd->q", te, v)
        ranks.append(torch.where(scores >= true_s[:, None], mask[c],
                                 torch.zeros_like(mask[c])).sum(1) + 1)
    return torch.cat(ranks).cpu().numpy()


def evaluate_zero_shot_rel_shared(test_candidates: dict, e2id: dict,
                                  embed_rel_block: Callable,
                                  embed_true: Callable,
                                  generate_relation_vecs: Callable,
                                  query_chunk: int = 64, verbose: bool = True,
                                  return_ranks: bool = False,
                                  device: torch.device | str = "cpu") -> dict:
    """Zero-shot ranking via the relation-shared path.

    ``embed_rel_block(heads [Q], shared [C]) → [Q, C, D]``,
    ``embed_true(heads [Q], trues [Q]) → [Q, D]``,
    ``generate_relation_vecs(rel_name) → [S, D]``."""
    rel_order = list(test_candidates.keys())
    shared_idx: dict = {}
    c_max = 1
    for rel in rel_order:
        seen: dict = {}
        for cands in test_candidates[rel].values():
            for c in cands[1:]:
                if c not in seen:
                    seen[c] = len(seen)
        shared_idx[rel] = seen
        c_max = max(c_max, len(seen))

    heads_l, trues_l, mask_l, vbar_l = [], [], [], []
    shared_rows = []
    counts, pads = [], []
    for rel in rel_order:
        seen = shared_idx[rel]
        row = np.zeros(c_max, np.int32)
        if seen:
            row[:len(seen)] = [e2id[c] for c in seen]
        rv = np.asarray(generate_relation_vecs(rel), np.float32)
        rv = rv / np.maximum(np.linalg.norm(rv, axis=-1, keepdims=True), 1e-12)
        vbar = rv.mean(0)
        D = vbar.shape[0]
        queries = test_candidates[rel]
        counts.append(len(queries))
        for key, cands in queries.items():
            head, _, _ = key.split("\t")
            m = np.zeros(c_max, np.int32)
            for c in cands[1:]:
                m[seen[c]] += 1          # multiplicity, not a membership bit
            heads_l.append(e2id[head])
            trues_l.append(e2id[cands[0]])
            mask_l.append(m)
            vbar_l.append(vbar)
        pad = (-len(queries)) % query_chunk
        pads.append(pad)
        for _ in range(pad):
            heads_l.append(0)
            trues_l.append(0)
            mask_l.append(np.zeros(c_max, np.int32))
            vbar_l.append(np.zeros(D, np.float32))
        shared_rows += [row] * ((len(queries) + pad) // query_chunk)

    if sum(counts) == 0:
        overall = dict(hits10=0.0, hits5=0.0, hits1=0.0, mrr=0.0, n=0)
        overall["per_relation"] = {}
        if return_ranks:
            overall["ranks"] = np.zeros(0, np.int64)
        return overall

    nc = len(shared_rows)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    ranks = _rank_stream_rel_shared(
        embed_rel_block, embed_true,
        put(np.asarray(heads_l).reshape(nc, query_chunk), torch.int64),
        put(np.asarray(trues_l).reshape(nc, query_chunk), torch.int64),
        put(np.stack(shared_rows), torch.int64),
        put(np.stack(mask_l).reshape(nc, query_chunk, c_max), torch.int64),
        put(np.stack(vbar_l).reshape(nc, query_chunk, -1), torch.float32))

    per_relation = {}
    real_ranks = []
    off = 0
    for rel, cnt, pad in zip(rel_order, counts, pads):
        r = ranks[off:off + cnt]
        real_ranks.append(r)
        per_relation[rel] = metrics_from_ranks(r)
        off += cnt + pad
        if verbose:
            m = per_relation[rel]
            print(f"{rel} Hits10:{m['hits10']:.3f}, Hits5:{m['hits5']:.3f}, "
                  f"Hits1:{m['hits1']:.3f} MRR:{m['mrr']:.3f}")
    real_ranks = np.concatenate(real_ranks)
    overall = metrics_from_ranks(real_ranks)
    if return_ranks:
        overall["ranks"] = np.asarray(real_ranks, np.int64)
    if verbose:
        print(f"OVERALL HITS10: {overall['hits10']:.3f}  HITS5: {overall['hits5']:.3f}  "
              f"HITS1: {overall['hits1']:.3f}  MRR: {overall['mrr']:.3f}")
    overall["per_relation"] = per_relation
    return overall
