"""Structural (TransE) candidate-list evaluation (port of
mre_tpu/eval/structural.py).

The reference's second evaluator (main.py:217-272): score each padded
candidate list with |h + r − t|₁ over the learner's entity and relation
embeddings, tie-aware rank = #better + #ties//2 + 1, per-relation and
final MRR / Hits@{1,3,10}; one device call per query chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.ops.ranking import candidate_ranks


def _transe_candidate_scores(head_emb, rel_emb, tail_embs):
    """head_emb [Q, D]; rel_emb [Q, D]; tail_embs [Q, C, D] → scores [Q, C]."""
    return (head_emb[:, None, :] + rel_emb[:, None, :] - tail_embs).abs().sum(dim=-1)


@torch.no_grad()
def evaluate_structural(test_candidates: dict, ent_embs, rel_embs,
                        e2id: dict, r2id: dict, query_chunk: int = 128,
                        verbose: bool = True,
                        device: str | torch.device | None = None) -> dict:
    """Scores on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    ent = torch.as_tensor(ent_embs, dtype=torch.float32).to(device)
    rel = torch.as_tensor(rel_embs, dtype=torch.float32).to(device)
    n_queries = sum(len(q) for q in test_candidates.values())
    if n_queries == 0:
        # a misloaded or empty candidates file fails loudly, not as NaN
        raise ValueError("evaluate_structural: no evaluable queries")

    c_max = 1
    for queries in test_candidates.values():
        for cands in queries.values():
            c_max = max(c_max, len(cands))

    all_ranks = []
    per_relation = {}
    for rel_name, queries in test_candidates.items():
        keys = list(queries.keys())
        ranks_rel = []
        for i in range(0, len(keys), query_chunk):
            chunk_keys = keys[i:i + query_chunk]
            Q = query_chunk
            heads = np.zeros(Q, np.int64)
            rels = np.zeros(Q, np.int64)
            tails = np.zeros((Q, c_max), np.int64)
            mask = np.zeros((Q, c_max), bool)
            for qi, key in enumerate(chunk_keys):
                head, rname, _ = key.split("\t")
                cands = queries[key]
                heads[qi] = e2id[head]
                rels[qi] = r2id[rname]
                tails[qi, :len(cands)] = [e2id[c] for c in cands]
                mask[qi, :len(cands)] = True
            heads, rels, tails, mask = (torch.as_tensor(a, device=device)
                                        for a in (heads, rels, tails, mask))
            # padded candidate slots gather entity 0; the mask drops them
            scores = _transe_candidate_scores(ent[heads], rel[rels], ent[tails])
            ranks = candidate_ranks(scores, mask, lower_is_better=True).cpu().numpy()
            ranks_rel.extend(ranks[:len(chunk_keys)].tolist())

        if not ranks_rel:   # a relation with no query: n = 0, no NaN
            per_relation[rel_name] = dict(mrr=0.0, hits1=0.0, hits3=0.0,
                                          hits10=0.0, n=0)
            continue
        r = np.asarray(ranks_rel, np.float64)
        per_relation[rel_name] = dict(
            mrr=float(np.mean(1 / r)), hits1=float(np.mean(r <= 1)),
            hits3=float(np.mean(r <= 3)), hits10=float(np.mean(r <= 10)),
            n=len(r))
        if verbose:
            m = per_relation[rel_name]
            print(f"Relation: {rel_name}| Number {m['n']} | mrr: {m['mrr']:.4f} | "
                  f"hit1: {m['hits1']:.4f} | hit3: {m['hits3']:.4f} | hit10: {m['hits10']:.4f}")
        all_ranks.extend(ranks_rel)

    r = np.asarray(all_ranks, np.float64)
    out = dict(mrr=float(np.mean(1 / r)), hits1=float(np.mean(r <= 1)),
               hits3=float(np.mean(r <= 3)), hits10=float(np.mean(r <= 10)),
               n=len(r), per_relation=per_relation)
    if verbose:
        print(f"[Final Scores] MRR: {out['mrr']} \tHits@1: {out['hits1']} \t"
              f"Hits@3: {out['hits3']} \tHits@10: {out['hits10']}")
    return out
