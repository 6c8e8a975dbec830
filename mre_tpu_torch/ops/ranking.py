"""Batched filtered link-prediction ranking and candidate-list ranking (port
of mre_tpu/ops/ranking.py).

Link prediction replaces the C++ metric accumulators (OpenKE
base/Test.h:36-192, 232-327): each chunk of test triples scores every
entity with one ``predict_all`` call and computes raw, filtered and
type-constrained ranks by vectorized comparison, with the strictly-less
semantics of Test.h:83 (rank = 1 + #candidates scoring strictly below the
true triple, the true entity excluded, known-true candidates excluded for
the filtered rank). The structural evaluator (main.py:217-272) ranks
candidate 0 of each padded list (``candidate_ranks``).

With the entity tables split by rows over a mesh's ``model`` axis
(``shard``, a ``parallel.mesh.RowShard``), each rank scores its own
entities (``shard_predictors``), the owner of the true entity contributes
its score (summed exactly over the group: the others add 0) and the
per-rank counts of candidates that beat it are summed: the ranks of the
whole table, from the same per-row arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mre_tpu_torch.data.kg import DeviceKG

# Bytes of one [queries, entity chunk, row width] float32 intermediate of the
# broadcast all-entity scorer. Eager PyTorch materializes every such
# intermediate (about eight for RotatE), so this caps the fallback's memory.
ENT_CHUNK_BYTES = 1 << 28


@dataclasses.dataclass
class RankResults:
    mrr: float
    mr: float
    hits1: float
    hits3: float
    hits10: float

    def as_dict(self, prefix: str = "") -> dict:
        return {prefix + k: getattr(self, k) for k in ("mrr", "mr", "hits1", "hits3", "hits10")}


def _filter_mask(kg: DeviceKG, anchors, r, side: str, n_entities: int,
                 pad: int = 1024) -> torch.Tensor:
    """[B, E] bool mask of the known-true candidates of each (anchor, r),
    scattered from the padded CSR true sets; ``pad`` bounds the row length
    (longer rows are truncated: pick pad ≥ ``kg.max_row_len()``)."""
    rows = anchors.to(torch.int64) * kg.n_relations + r.to(torch.int64)
    if side == "tail":
        values = kg.hrt_tails
        start, cnt, _ = kg.hr_range(rows)
    else:
        values = kg.trh_heads
        start, cnt, _ = kg.tr_range(rows)
    lane = torch.arange(pad, device=rows.device)
    gidx = torch.clamp(start[:, None] + lane[None, :], max=values.shape[0] - 1)
    vals = values[gidx].to(torch.int64)
    cols = torch.where(lane[None, :] < cnt[:, None], vals, n_entities)  # scratch column
    B = rows.shape[0]
    mask = torch.zeros((B, n_entities + 1), dtype=torch.bool, device=rows.device)
    mask[torch.arange(B, device=rows.device)[:, None], cols] = True
    return mask[:, :n_entities]


def _rank_chunk(predict_all: Callable, params, kg: DeviceKG, h, r, t, side: str,
                filter_pad: int, type_mask=None, shard=None):
    """Ranks for one chunk: (raw, filtered[, type-constrained raw, filtered]).
    With ``shard`` the scores are this rank's entities' and the counts are
    summed over its group."""
    n_ent = kg.n_entities
    if side == "tail":
        scores = predict_all(params, h, r)                 # [B, E], lower = better
        true_idx = t
        known = _filter_mask(kg, h, r, "tail", n_ent, filter_pad)
    else:
        scores = predict_all(params, t, r)
        true_idx = h
        known = _filter_mask(kg, t, r, "head", n_ent, filter_pad)
    rows = torch.arange(true_idx.shape[0], device=true_idx.device)
    if shard is None:
        true_score = torch.gather(scores, 1, true_idx[:, None])
        is_true = torch.zeros_like(known)
        is_true[rows, true_idx] = True
    else:
        from mre_tpu_torch.parallel import mesh as pmesh

        known = shard.local(known.T).T
        type_mask = None if type_mask is None else shard.local(type_mask.T).T
        own = (true_idx >= shard.rows.start) & (true_idx < shard.rows.stop)
        col = torch.clamp(true_idx - shard.rows.start, 0, shard.n_local - 1)
        mine = torch.where(own, scores[rows, col], torch.zeros_like(scores[rows, col]))
        true_score = pmesh.all_reduce_sum(mine, shard.group)[:, None]
        is_true = torch.zeros_like(known)
        is_true[rows, col] = own
    below = (scores < true_score) & ~is_true
    counts = [below.sum(dim=1), (below & ~known).sum(dim=1)]
    if type_mask is not None:
        allowed = below & type_mask
        counts += [allowed.sum(dim=1), (allowed & ~known).sum(dim=1)]
    counts = torch.stack(counts)
    if shard is not None:
        counts = pmesh.all_reduce_sum(counts, shard.group)
    return tuple(counts + 1)


def _metrics(ranks) -> RankResults:
    ranks = np.asarray(ranks, np.float64)
    return RankResults(mrr=float(np.mean(1.0 / ranks)), mr=float(np.mean(ranks)),
                       hits1=float(np.mean(ranks <= 1)), hits3=float(np.mean(ranks <= 3)),
                       hits10=float(np.mean(ranks <= 10)))


def rank_arrays(predict_all_tails: Callable, predict_all_heads: Callable, params,
                kg_filter: DeviceKG, test_triples, chunk: int = 256,
                filter_pad: int | None = None, type_constraints=None,
                shard=None) -> dict[str, np.ndarray]:
    """Per-triple ranks, [n] int64 numpy arrays under ``tail_raw``,
    ``tail_filter``, ``head_raw``, ``head_filter`` (and ``*_tc`` with
    ``type_constraints``). The ranks of every chunk stay on the device and
    come to the host once. With ``shard`` the predictors score this rank's
    entities (``shard_predictors``) and ``params`` holds its rows."""
    test = np.asarray(test_triples, np.int64).reshape(-1, 3)
    n = len(test)
    if n == 0:
        raise ValueError("link_prediction: no test triples")
    if filter_pad is None:
        # _filter_mask truncates rows longer than the pad, which would
        # overstate filtered metrics: take the exact bound from the CSR
        filter_pad = kg_filter.max_row_len()
    dev = kg_filter.hrt_tails.device
    tc = type_constraints is not None
    if tc:
        head_tc = torch.as_tensor(np.asarray(type_constraints[0]), device=dev)
        tail_tc = torch.as_tensor(np.asarray(type_constraints[1]), device=dev)
    triples = torch.as_tensor(test, device=dev)
    tails, heads = [], []
    with torch.no_grad():
        for i in range(0, n, chunk):
            h, r, t = triples[i:i + chunk].unbind(1)
            tails.append(torch.stack(_rank_chunk(predict_all_tails, params, kg_filter, h, r, t,
                                                 "tail", filter_pad, tail_tc[r] if tc else None,
                                                 shard)))
            heads.append(torch.stack(_rank_chunk(predict_all_heads, params, kg_filter, h, r, t,
                                                 "head", filter_pad, head_tc[r] if tc else None,
                                                 shard)))
    tails = torch.cat(tails, dim=1).cpu().numpy()
    heads = torch.cat(heads, dim=1).cpu().numpy()
    names = ("raw", "filter", "raw_tc", "filter_tc")
    out = {}
    for side, arr in (("tail", tails), ("head", heads)):
        for name, row in zip(names, arr):
            out[f"{side}_{name}"] = row
    return out


def link_prediction(predict_all_tails: Callable, predict_all_heads: Callable, params,
                    kg_filter: DeviceKG, test_triples, chunk: int = 256,
                    filter_pad: int | None = None,
                    type_constraints=None, shard=None) -> dict[str, RankResults]:
    """Head and tail link prediction over all test triples.

    ``kg_filter`` must index the UNION of the train / valid / test triples
    (Test.h filters against all splits; Reader.h:166-257), on the device the
    scorers run on. Returns 'raw' and 'filter' (and 'raw_tc' / 'filter_tc'
    when ``type_constraints``, a (head_masks [R, E], tail_masks [R, E])
    pair, is given), each averaging head and tail ranks like
    Test.h:232-327."""
    ranks = rank_arrays(predict_all_tails, predict_all_heads, params, kg_filter,
                        test_triples, chunk, filter_pad, type_constraints, shard)
    names = ("raw", "filter") + (("raw_tc", "filter_tc") if type_constraints is not None else ())
    return {name: _metrics(np.concatenate([ranks[f"tail_{name}"], ranks[f"head_{name}"]]))
            for name in names}


def _row_width(params) -> int:
    """The widest row of any parameter table (the broadcast scorer's
    intermediates are [queries, entities, up to this width])."""
    return max(int(np.prod(v.shape[1:])) for v in params.values() if v.dim() >= 2)


def make_predict_all(model, kg: DeviceKG, ent_chunk: int | None = None,
                     n_candidates: int | None = None):
    """(predict_all_tails, predict_all_heads): ``(params, anchor, r) →
    [B, E]`` lower-is-better scores.

    The model's matmul fast path where it has one; otherwise ``predict``
    broadcast over chunks of entities. ``ent_chunk`` None sizes each chunk
    so that one [B, chunk, row width] float32 intermediate takes at most
    ``ENT_CHUNK_BYTES``; the scores do not depend on the chunk.
    ``n_candidates`` scores only the first entity rows of ``params`` (E
    columns; all ``kg.n_entities`` when None)."""
    n_ent = kg.n_entities if n_candidates is None else n_candidates

    def chunked(params, anchor, r, tail: bool):
        B = anchor.shape[0]
        size = ent_chunk or max(1, ENT_CHUNK_BYTES // (4 * B * _row_width(params)))
        parts = []
        for e0 in range(0, n_ent, size):
            ents = torch.arange(e0, min(e0 + size, n_ent), device=anchor.device)[None, :]
            if tail:
                parts.append(model.predict(params, anchor[:, None], r[:, None], ents))
            else:
                parts.append(model.predict(params, ents, r[:, None], anchor[:, None]))
        return torch.cat(parts, dim=1)

    if model.score_all_tails is not None:
        def all_tails(params, h, r):
            return model.score_all_tails(params, h, r)[:, :n_ent]
    else:
        def all_tails(params, h, r):
            return chunked(params, h, r, True)

    if model.score_all_heads is not None:
        def all_heads(params, t, r):
            return model.score_all_heads(params, t, r)[:, :n_ent]
    else:
        def all_heads(params, t, r):
            return chunked(params, t, r, False)

    return all_tails, all_heads


def shard_predictors(predict_all_tails: Callable, predict_all_heads: Callable, shard):
    """Predictors for entity tables split by rows over ``shard.group``, from
    ``make_predict_all(..., n_candidates=shard.n_local)``: ``(params,
    anchor, r) → [B, n_local]`` scores of this rank's entities, ``params``
    holding this rank's rows of every entity table. The anchors' rows are
    looked up across the group and appended to each local table, so the
    model scores them against the local rows with its own arithmetic."""
    from mre_tpu_torch.models.kge import is_entity_table
    from mre_tpu_torch.parallel import mesh as pmesh

    def extend(predict_all):
        def fn(params, anchor, r):
            ext = {k: torch.cat([v, pmesh.lookup_rows(v, anchor, shard)])
                   if is_entity_table(k) else v for k, v in params.items()}
            idx = shard.n_local + torch.arange(anchor.shape[0], device=anchor.device)
            return predict_all(ext, idx, r)
        return fn

    return extend(predict_all_tails), extend(predict_all_heads)


def candidate_ranks(scores: torch.Tensor, cand_mask: torch.Tensor,
                    lower_is_better: bool = True) -> torch.Tensor:
    """Tie-aware ranks of candidate 0 within each padded candidate list.

    ``scores`` [Q, C] with the true candidate at column 0; ``cand_mask``
    [Q, C] marks real candidates. rank = #better + #ties//2 + 1 over
    candidates 1.. (reference: main.py:247-250)."""
    s = scores if lower_is_better else -scores
    true_s = s[:, :1]
    rest = cand_mask.to(torch.bool).clone()
    rest[:, 0] = False
    better = ((s < true_s) & rest).sum(dim=1)
    ties = ((s == true_s) & rest).sum(dim=1)
    return better + ties // 2 + 1


def triple_classification_threshold(pos_scores: np.ndarray, neg_scores: np.ndarray):
    """Best-accuracy score threshold search (OpenKE Tester.py:93-150).
    Scores are lower-is-better; returns (threshold, accuracy)."""
    scores = np.concatenate([pos_scores, neg_scores])
    labels = np.concatenate([np.ones_like(pos_scores), np.zeros_like(neg_scores)])
    order = np.argsort(scores)
    scores, labels = scores[order], labels[order]
    total = len(scores)
    n_pos = labels.sum()
    # predicting positive for score <= threshold: a threshold at scores[k]
    # classifies every tied score positive too, so each candidate cut is
    # evaluated at the rightmost index of its tie group
    tp = np.cumsum(labels)
    fp = np.cumsum(1 - labels)
    last = np.searchsorted(scores, scores, side="right") - 1
    acc = (tp[last] + (total - n_pos - fp[last])) / total
    k = int(np.argmax(acc))
    return float(scores[k]), float(acc[k])
