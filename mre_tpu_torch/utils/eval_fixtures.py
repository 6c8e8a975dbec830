"""Deterministic eval-fixture generation (numpy copy of
mre_tpu/utils/eval_fixtures.py).

Equivalents of the reference's reproducibility helpers: frozen sampled eval
subgraphs (``generate_fix_samples``, module/utils.py:404-451 →
``sub_<mode>_samples.json``) and their conversion into fixed candidate lists
(``transer_subgraph2candidates``, module/utils.py:453-477 →
``sample_candidates.json``).
"""

from __future__ import annotations

import json
import os

import numpy as np

from mre_tpu_torch.data.graph_sampler import NeighborSampler, edges_from_tasks


def generate_fix_samples(triples: np.ndarray, num_nodes: int, out_path: str,
                         sample_size: int = 4, batch_size: int = 12,
                         neg_ent: int = 1, seed: int = 0, max_batches: int | None = None):
    """Freeze neighbor-sampled eval batches with expanded negative lists to a
    JSON file with the reference's sub_<mode>_samples.json schema."""
    from mre_tpu_torch.data.kg import TripleTable

    rng = np.random.default_rng(seed)
    triples = np.asarray(triples)
    edge_index, edge_type = edges_from_tasks(triples)
    n_rel = int(triples[:, 1].max()) + 1 if len(triples) else 1
    table = TripleTable.build(triples, num_nodes, n_rel)
    sampler = NeighborSampler(edge_index, edge_type, num_nodes,
                              size=sample_size, batch_size=batch_size, seed=seed)
    saved = {}
    for step, batch in enumerate(sampler):
        if max_batches is not None and step >= max_batches:
            break
        valid_e = batch["edge_mask"].sum()
        src, dst = batch["edge_index"][0], batch["edge_index"][1]
        et = batch["edge_type"]
        n_valid = int(batch["node_mask"].sum())
        # expand with neg_ent corrupted heads/tails per edge, FILTERED like
        # the reference path (generate_eval_list routes through
        # NegativeSampling's np.in1d-filtered sampler): a negative must not
        # form a true triple, equal the true entity, or — for head
        # corruptions — collide with the true head (which would misroute
        # the head/tail branch in subgraph_to_candidates)
        g = np.asarray(batch["n_id"])
        src_v, dst_v, et_v = src[:valid_e], dst[:valid_e], et[:valid_e]
        src_g, dst_g = g[src_v], g[dst_v]
        exp_src, exp_dst, exp_et = [list(src_v)], [list(dst_v)], [list(et_v)]
        for _ in range(neg_ent):
            corrupt_tail = rng.random(valid_e) < 0.5
            rand = rng.integers(0, max(n_valid, 1), valid_e)
            for _ in range(20):
                cand_g = g[rand]
                bad = np.where(
                    corrupt_tail,
                    table.contains(src_g, et_v, cand_g) | (cand_g == dst_g),
                    table.contains(cand_g, et_v, dst_g) | (cand_g == src_g))
                if not bad.any():
                    break
                rand = np.where(bad, rng.integers(0, max(n_valid, 1), valid_e), rand)
            exp_src.append(list(np.where(corrupt_tail, src_v, rand)))
            exp_dst.append(list(np.where(corrupt_tail, rand, dst_v)))
            exp_et.append(list(et_v))
        saved[str(step)] = {
            "step": step,
            "batch_size": int(valid_e),
            "edge_index_expand": [
                [int(x) for row in exp_src for x in row],
                [int(x) for row in exp_dst for x in row]],
            "edge_type_expand": [int(x) for row in exp_et for x in row],
            "n_id": [int(x) for x in batch["n_id"][:n_valid]],
        }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(saved, f)
    return saved


def subgraph_to_candidates(samples: dict, out_path: str | None = None,
                           neg_length: int | None = None) -> dict:
    """Convert frozen subgraph samples into per-true-triple head/tail
    candidate lists (module/utils.py:453-477 semantics)."""
    pos_neg = {}
    for info in samples.values():
        n_id = info["n_id"]
        local2global = dict(enumerate(n_id))
        bs = info["batch_size"]
        if bs == 0:
            continue
        src, dst = info["edge_index_expand"]
        et = info["edge_type_expand"]
        n_blocks = len(src) // bs if neg_length is None else neg_length
        rows = [[local2global.get(h, h), r, local2global.get(t, t)]
                for h, r, t in zip(src, et, dst)]
        true_rows = rows[:bs]
        for idx, true in enumerate(true_rows):
            cands = [rows[idx + i * bs] for i in range(n_blocks) if idx + i * bs < len(rows)]
            head_cor, tail_cor = [], []
            for h, r, t in cands[1:]:
                if h == true[0]:
                    tail_cor.append(t)
                else:
                    head_cor.append(h)
            key = f"{true[0]}\t{true[1]}\t{true[2]}"
            pos_neg[key] = {"head": head_cor, "tail": tail_cor}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(pos_neg, f)
    return pos_neg
