"""Zero-shot relation evaluation (port of mre_tpu/eval/zero_shot.py).

The host builds one padded query stream over every unseen relation; the
device ranks it chunk by chunk (the JAX ``lax.scan`` becomes a Python
loop). Scores are the cosine of each pair embedding against the mean of
the relation's unit-normalized generated vectors.

* ``evaluate_zero_shot`` — one candidate list per query, embedded pair by
  pair (``factored``) or one head per query (``head_shared``);
* ``evaluate_zero_shot_rel_shared`` — every query of a relation ranks the
  same shared candidate list (reference utils/gen_mode_candidates.py), so
  each chunk carries its relation's shared row and the candidate gather and
  the SupportEncoder's first matmul are computed once per chunk; under a
  process mesh the chunks are ranked data parallel.

Ranks are pessimistic, 1 + #greater + #tied; in the shared-list path a
duplicate candidate counts once per occurrence (zero_shot.py:28-47,
207-223, 280-286). A candidate whose entity id is the true tail's is a tie
by id: it counts whatever its float32 score says, on every path, since the
same entity can be scored through two different sums (the shared row and
the true tail's own embedding, or two rows of one batched product) that
differ in the last bit. An empty candidate file gives zeros with n = 0.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mre_tpu_torch.core.device import resolve_device


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


def _empty_result(return_ranks: bool) -> dict:
    """Zero evaluable queries (an empty or mis-pathed candidates file):
    zeros with n = 0, so a misloaded dataset never reads as a perfect score."""
    overall = dict(hits10=0.0, hits5=0.0, hits1=0.0, mrr=0.0, n=0)
    overall["per_relation"] = {}
    if return_ranks:
        overall["ranks"] = np.zeros(0, np.int64)
    return overall


def _print_metrics(name: str, m: dict):
    print(f"{name} Hits10:{m['hits10']:.3f}, Hits5:{m['hits5']:.3f}, "
          f"Hits1:{m['hits1']:.3f} MRR:{m['mrr']:.3f}")


def _overall(ranks: np.ndarray, per_relation: dict, return_ranks: bool,
             verbose: bool) -> dict:
    overall = metrics_from_ranks(ranks)
    if return_ranks:
        overall["ranks"] = np.asarray(ranks, np.int64)
    if verbose:
        print(f"OVERALL HITS10: {overall['hits10']:.3f}  HITS5: {overall['hits5']:.3f}  "
              f"HITS1: {overall['hits1']:.3f}  MRR: {overall['mrr']:.3f}")
    overall["per_relation"] = per_relation
    return overall


def _ranks_vs_first(scores, mask, ids=None):
    """1 + #(valid candidates scoring >= column 0, the true tail); with
    ``ids`` [Q, C] (column 0 = the true tail's), every valid candidate of
    the true tail's id counts as a tie."""
    valid = mask.clone()
    valid[:, 0] = False
    hit = scores >= scores[:, :1]
    if ids is not None:
        hit = hit | (ids == ids[:, :1])
    return (hit & valid).sum(1) + 1


@torch.no_grad()
def _score_and_rank(cand_emb, rel_vecs, cand_mask):
    """cand_emb [Q, C, D]; rel_vecs [S, D]; cand_mask [Q, C] bool (column 0
    = the true tail). Returns ranks [Q] (zero_shot.py:28-47): the mean of
    cosines folded into one mean relation vector."""
    vbar = _unit(rel_vecs).mean(0)
    scores = torch.einsum("qcd,d->qc", _unit(cand_emb), vbar)
    return _ranks_vs_first(scores, cand_mask)


@torch.no_grad()
def _rank_stream(embed_query_pairs: Callable, pairs, left, right, mask, vbar) -> np.ndarray:
    """pairs [nc, chunk, C, 2]; left/right [nc, chunk, C]; mask [nc, chunk,
    C] bool; vbar [nc, chunk, D]. ``embed_query_pairs(pairs [N, 2], left
    [N], right [N]) → [N, D]``. Returns ranks [nc·chunk] (host)."""
    nc, chunk, c_max = right.shape
    ranks = []
    for c in range(nc):
        emb = embed_query_pairs(pairs[c].reshape(-1, 2), left[c].reshape(-1),
                                right[c].reshape(-1)).float().reshape(chunk, c_max, -1)
        scores = torch.einsum("qcd,qd->qc", _unit(emb), vbar[c])
        ranks.append(_ranks_vs_first(scores, mask[c], right[c]))
    return torch.cat(ranks).cpu().numpy()


@torch.no_grad()
def _rank_stream_block(embed_query_block: Callable, heads, right, mask, vbar) -> np.ndarray:
    """Block variant of ``_rank_stream``, one head entity per query: heads
    [nc, chunk]; ``embed_query_block(heads [chunk], cands [chunk, C]) →
    [chunk, C, D]`` (``Extractor.embed_pairs_head_shared``)."""
    ranks = []
    for c in range(heads.shape[0]):
        emb = embed_query_block(heads[c], right[c]).float()
        scores = torch.einsum("qcd,qd->qc", _unit(emb), vbar[c])
        ranks.append(_ranks_vs_first(scores, mask[c], right[c]))
    return torch.cat(ranks).cpu().numpy()


@torch.no_grad()
def _rank_stream_rel_shared(embed_rel_block: Callable, embed_true: Callable,
                            heads, trues, shared, mask, vbar, mesh=None) -> np.ndarray:
    """heads/trues [nc, chunk]; shared [nc, C]; mask [nc, chunk, C]
    per-occurrence candidate counts; vbar [nc, chunk, D]. Returns ranks
    [nc·chunk] (host). A shared-row position holding the true tail's own
    id counts its multiplicity whatever the two float32 scores say. With ``mesh`` (the chunk count a multiple of its
    ``data`` axis) data rank d ranks chunks d, d + n_data, … (the JAX
    layout, zero_shot.py:157-167) and the integer ranks are summed over
    the data group into chunk order: no float crosses ranks."""
    nc = heads.shape[0]
    step, first = (1, 0) if mesh is None else (mesh.n_data, mesh.data_index)
    ranks = torch.zeros(heads.shape, dtype=torch.int64, device=heads.device)
    for c in range(first, nc, step):
        emb = _unit(embed_rel_block(heads[c], shared[c]).float())    # [chunk, C, D]
        te = _unit(embed_true(heads[c], trues[c]).float())           # [chunk, D]
        v = vbar[c]
        scores = torch.einsum("qcd,qd->qc", emb, v)
        true_s = torch.einsum("qd,qd->q", te, v)
        hit = (scores >= true_s[:, None]) | (shared[c][None, :] == trues[c][:, None])
        ranks[c] = torch.where(hit, mask[c], torch.zeros_like(mask[c])).sum(1) + 1
    if mesh is not None:
        from mre_tpu_torch.parallel import mesh as pmesh

        ranks = pmesh.all_reduce_sum(ranks, mesh.data_group)
    return ranks.reshape(-1).cpu().numpy()


def evaluate_zero_shot_rel_shared(test_candidates: dict, e2id: dict,
                                  embed_rel_block: Callable,
                                  embed_true: Callable,
                                  generate_relation_vecs: Callable,
                                  query_chunk: int = 64, verbose: bool = True,
                                  return_ranks: bool = False,
                                  device: torch.device | str | None = None,
                                  mesh=None) -> dict:
    """Zero-shot ranking via the relation-shared path.

    ``embed_rel_block(heads [Q], shared [C]) → [Q, C, D]``,
    ``embed_true(heads [Q], trues [Q]) → [Q, D]``,
    ``generate_relation_vecs(rel_name) → [S, D]``. Ranks on ``device``
    (default ``cuda``; the mesh's device under a mesh).

    ``mesh`` (a ``parallel.mesh.Mesh``) ranks the chunks data parallel over
    its ``data`` axis; the chunk count is padded to the axis with all-masked
    dummy chunks past every real one, and the ranks are identical to the
    single-device run's (zero_shot.py:300-330)."""
    device = resolve_device(mesh.device if device is None and mesh is not None else device)
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
        return _empty_result(return_ranks)
    if mesh is not None:
        # dummy chunks sit past every real (count, pad) offset below, so the
        # per-relation slicing never reads them
        for _ in range((-len(shared_rows)) % mesh.n_data):
            shared_rows.append(np.zeros(c_max, np.int32))
            heads_l += [0] * query_chunk
            trues_l += [0] * query_chunk
            mask_l += [np.zeros(c_max, np.int32)] * query_chunk
            vbar_l += [np.zeros(D, np.float32)] * query_chunk

    nc = len(shared_rows)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    ranks = _rank_stream_rel_shared(
        embed_rel_block, embed_true,
        put(np.asarray(heads_l).reshape(nc, query_chunk), torch.int64),
        put(np.asarray(trues_l).reshape(nc, query_chunk), torch.int64),
        put(np.stack(shared_rows), torch.int64),
        put(np.stack(mask_l).reshape(nc, query_chunk, c_max), torch.int64),
        put(np.stack(vbar_l).reshape(nc, query_chunk, -1), torch.float32), mesh)

    per_relation = {}
    real_ranks = []
    off = 0
    for rel, cnt, pad in zip(rel_order, counts, pads):
        r = ranks[off:off + cnt]
        real_ranks.append(r)
        per_relation[rel] = metrics_from_ranks(r)
        off += cnt + pad
        if verbose:
            _print_metrics(rel, per_relation[rel])
    return _overall(np.concatenate(real_ranks), per_relation, return_ranks, verbose)


def evaluate_zero_shot(test_candidates: dict, symbol2id: dict, e2id: dict,
                       rel2id: dict, embed_query_pairs: Callable,
                       generate_relation_vecs: Callable,
                       query_chunk: int = 64, verbose: bool = True,
                       embed_query_block: Callable | None = None,
                       return_ranks: bool = False,
                       device: torch.device | str | None = None) -> dict:
    """Zero-shot ranking over every unseen relation (zero_shot.py:354-470).

    ``embed_query_pairs(pairs [N, 2] symbol ids, left [N], right [N]) →
    [N, D]``; with ``embed_query_block(heads [Q], cands [Q, C]) → [Q, C,
    D]`` given, it is used instead (one head per query);
    ``generate_relation_vecs(rel_name) → [S, D]``. Ranks on ``device``
    (default ``cuda``)."""
    device = resolve_device(device)
    rel_order = list(test_candidates.keys())
    c_max = 1
    for rel in rel_order:
        for cands in test_candidates[rel].values():
            c_max = max(c_max, len(cands))

    block = embed_query_block is not None
    counts = []
    pairs_l, left_l, right_l, mask_l, vbar_l = [], [], [], [], []
    for rel in rel_order:
        queries = test_candidates[rel]
        rv = np.asarray(generate_relation_vecs(rel), np.float32)
        rv = rv / np.maximum(np.linalg.norm(rv, axis=-1, keepdims=True), 1e-12)
        vbar = rv.mean(0)
        counts.append(len(queries))
        for key, cands in queries.items():
            head, _, _ = key.split("\t")
            n = len(cands)
            r = np.zeros(c_max, np.int32)
            m = np.zeros(c_max, bool)
            r[:n] = [e2id[c] for c in cands]
            m[:n] = True
            if block:
                left_l.append(e2id[head])
            else:
                p = np.zeros((c_max, 2), np.int32)
                l = np.zeros(c_max, np.int32)
                p[:n, 0] = symbol2id[head]
                p[:n, 1] = [symbol2id[c] for c in cands]
                l[:n] = e2id[head]
                pairs_l.append(p)
                left_l.append(l)
            right_l.append(r)
            mask_l.append(m)
            vbar_l.append(vbar)

    n_q = len(right_l)
    if n_q == 0:
        return _empty_result(return_ranks)
    pad_q = -(-n_q // query_chunk) * query_chunk
    D = vbar_l[0].shape[0]
    for _ in range(pad_q - n_q):
        if block:
            left_l.append(0)
        else:
            pairs_l.append(np.zeros((c_max, 2), np.int32))
            left_l.append(np.zeros(c_max, np.int32))
        right_l.append(np.zeros(c_max, np.int32))
        mask_l.append(np.zeros(c_max, bool))
        vbar_l.append(np.zeros(D, np.float32))

    nc = pad_q // query_chunk

    def put(a, dtype, *shape):
        return torch.as_tensor(np.asarray(a).reshape(nc, query_chunk, *shape),
                               dtype=dtype, device=device)

    right = put(np.stack(right_l), torch.int64, c_max)
    mask = put(np.stack(mask_l), torch.bool, c_max)
    vbar = put(np.stack(vbar_l), torch.float32, D)
    if block:
        ranks = _rank_stream_block(embed_query_block, put(left_l, torch.int64),
                                   right, mask, vbar)[:n_q]
    else:
        ranks = _rank_stream(embed_query_pairs, put(np.stack(pairs_l), torch.int64, c_max, 2),
                             put(np.stack(left_l), torch.int64, c_max),
                             right, mask, vbar)[:n_q]

    per_relation = {}
    off = 0
    for rel, cnt in zip(rel_order, counts):
        per_relation[rel] = metrics_from_ranks(ranks[off:off + cnt])
        off += cnt
        if verbose:
            _print_metrics(rel, per_relation[rel])
    return _overall(ranks, per_relation, return_ranks, verbose)
