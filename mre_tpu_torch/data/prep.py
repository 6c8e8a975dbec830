"""Offline dataset-preparation utilities (numpy copy of mre_tpu/data/prep.py).

Function-level equivalents of the reference's 12 `utils/` scripts
(SURVEY.md §2.1 "Offline prep scripts"): split construction, id maps,
candidate generation, and type-constraint files. All pure-python/numpy,
operating on in-memory structures with thin file wrappers.
"""

from __future__ import annotations

import json
import os
import random
from collections import defaultdict

import numpy as np


def seen_unseen_split(triples_by_rel: dict, n_unseen: int = 40, seed: int = 0):
    """Random unseen-relation split (utils/seen_unseen_split.py)."""
    rng = random.Random(seed)
    rels = sorted(triples_by_rel)
    unseen = set(rng.sample(rels, min(n_unseen, len(rels))))
    train = {r: v for r, v in triples_by_rel.items() if r not in unseen}
    test = {r: v for r, v in triples_by_rel.items() if r in unseen}
    return train, test


def frequency_split(triples_by_rel: dict, n_unseen: int = 40,
                    min_count: int = 50, max_count: int = 1000, seed: int = 0):
    """Frequency-based unseen split keeping entity coverage
    (utils/adjust_FB15K-237.py behavior): unseen relations are drawn from
    mid-frequency relations so that no entity appears only in test."""
    rng = random.Random(seed)
    candidates = [r for r, rows in triples_by_rel.items()
                  if min_count <= len(rows) <= max_count]
    rng.shuffle(candidates)
    seen_entities = set()
    for r, rows in triples_by_rel.items():
        if r not in candidates:
            for h, _, t in rows:
                seen_entities.add(h)
                seen_entities.add(t)
    # incremental coverage counts: cover[e] = #still-seen relations (fixed
    # seen set counts once, plus one per remaining candidate) covering e.
    # Accepting r decrements its entities; r is acceptable iff removing it
    # leaves every one of its entities covered. Same invariant as the
    # O(|candidates|²·triples) rebuild, in one pass over the triples.
    from collections import Counter

    cover: Counter = Counter()
    for e in seen_entities:
        cover[e] += 1
    cand_ents = {}
    for r in candidates:
        ents = {e for row in triples_by_rel[r] for e in (row[0], row[2])}
        cand_ents[r] = ents
        for e in ents:
            cover[e] += 1
    unseen = []
    for r in candidates:
        if len(unseen) >= n_unseen:
            break
        if all(cover[e] > 1 for e in cand_ents[r]):
            unseen.append(r)
            for e in cand_ents[r]:
                cover[e] -= 1
    unseen = set(unseen)
    train = {r: v for r, v in triples_by_rel.items() if r not in unseen}
    test = {r: v for r, v in triples_by_rel.items() if r in unseen}
    return train, test


def train_valid_split(tasks: dict, ratio: float = 0.95, seed: int = 0):
    """GLOBAL train/valid split (utils/splitdata.py:25-32): every relation's
    triples are pooled, shuffled once, and the last (1−ratio) fraction
    becomes valid — NOT a per-relation split (a small relation may land
    entirely on either side, exactly like the reference's global
    random.shuffle + 1/20 cut)."""
    rng = random.Random(seed)
    flat = [(r, list(row)) for r, rows in tasks.items() for row in rows]
    rng.shuffle(flat)
    split = int(len(flat) - len(flat) * (1.0 - ratio))
    train, valid = {}, {}
    for i, (r, row) in enumerate(flat):
        (train if i < split else valid).setdefault(r, []).append(row)
    return train, valid


def build_id_maps(tasks: dict):
    """Entity/relation id maps in first-seen order (utils/toid.py)."""
    e2id, r2id = {}, {}
    for r, rows in tasks.items():
        if r not in r2id:
            r2id[r] = len(r2id)
        for h, _, t in rows:
            if h not in e2id:
                e2id[h] = len(e2id)
            if t not in e2id:
                e2id[t] = len(e2id)
    return e2id, r2id


def gen_e1rel_e2(*task_dicts) -> dict:
    """"<head><rel>" → true tails, over all given splits
    (utils/gen_e1r_e2_all.py)."""
    out = defaultdict(list)
    for tasks in task_dicts:
        for r, rows in tasks.items():
            for h, rel, t in rows:
                out[h + rel].append(t)
    return dict(out)


def gen_rel2candidates(tasks: dict, entities: list, n: int = 300, seed: int = 0) -> dict:
    """Per relation, n random candidate entities (utils/gen_rel2candidates.py);
    type-aware variant: candidates drawn from observed tail entities of the
    relation when enough exist."""
    rng = random.Random(seed)
    out = {}
    for r, rows in tasks.items():
        tails = sorted({t for _, _, t in rows})
        pool = tails if len(tails) >= n else entities
        k = min(n, len(pool))
        out[r] = rng.sample(list(pool), k)
    return out


def gen_mode_candidates(tasks: dict, rel2candidates: dict, e1rel_e2: dict,
                        max_candidates: int | None = None) -> dict:
    """Filtered per-query candidate lists, true tail first at index 0
    (utils/gen_mode_candidates.py:16-38 → {mode}_candidates.json schema)."""
    out = {}
    for r, rows in tasks.items():
        per_rel = {}
        cands = rel2candidates.get(r, [])
        for h, rel, t in rows:
            known = set(e1rel_e2.get(h + rel, []))
            noise = [c for c in cands if c != t and c not in known]
            if max_candidates:
                noise = noise[:max_candidates]
            per_rel[f"{h}\t{rel}\t{t}"] = [t] + noise
        out[r] = per_rel
    return out


def type_constraints(triples: np.ndarray, n_relations: int):
    """Observed head/tail candidate sets per relation + 1-1/1-n/n-1/n-n
    classification (utils/n-n.py → type_constrain.txt semantics)."""
    triples = np.asarray(triples)
    head_type = {r: sorted(set(triples[triples[:, 1] == r, 0].tolist()))
                 for r in range(n_relations)}
    tail_type = {r: sorted(set(triples[triples[:, 1] == r, 2].tolist()))
                 for r in range(n_relations)}

    # average tails per head / heads per tail → relation category
    categories = {}
    for r in range(n_relations):
        rows = triples[triples[:, 1] == r]
        if len(rows) == 0:
            categories[r] = "1-1"
            continue
        tph = len(rows) / max(len(set(rows[:, 0].tolist())), 1)
        hpt = len(rows) / max(len(set(rows[:, 2].tolist())), 1)
        left = "1" if tph < 1.5 else "n"
        right = "1" if hpt < 1.5 else "n"
        categories[r] = f"{right}-{left}"
    return head_type, tail_type, categories


def embed_relation_texts(descriptions: list, out_path: str | None = None,
                         dim: int = 384, vocab_size: int = 30522) -> "np.ndarray":
    """Offline relation-text embeddings (utils/generate_text_pretrain.py
    equivalent). The reference uses a SentenceTransformer; here the hermetic
    fallback embeds via hashed bag-of-words with sin-cos positional mixing —
    pass the embeddings from the trained M3AE text encoder
    (FusionTrainer.generate_rel_embeddings) for learned embeddings instead.
    """
    from mre_tpu_torch.data.multimodal import HashingTokenizer
    from mre_tpu_torch.ops.pos_embed import get_1d_sincos_pos_embed

    tok = HashingTokenizer(vocab_size)
    rng = np.random.default_rng(0)
    table = rng.normal(scale=1.0 / np.sqrt(dim), size=(vocab_size, dim)).astype(np.float32)
    out = np.zeros((len(descriptions), dim), np.float32)
    max_len = 64
    pos = get_1d_sincos_pos_embed(dim, max_len)[0]
    for i, text in enumerate(descriptions):
        ids, mask = tok(text, max_len)
        valid = mask == 0.0
        if valid.any():
            out[i] = (table[ids[valid]] + pos[valid]).mean(0)
    if out_path:
        np.savez(out_path, embeddings=out)
    return out


def id_txt_to_json(txt_path: str, json_path: str | None = None) -> dict:
    """Convert an OpenKE ``*2id.txt`` map to the ``*2ids.json`` schema
    (utils/switch_txt_json.py)."""
    out = {}
    with open(txt_path) as f:
        for line in f.readlines()[1:]:
            name, idx = line.split()
            out[name] = int(idx)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f)
    return out


def ids_to_names(result_rows: list, ent2id: dict, rel2id: dict) -> list:
    """Map (h, r, t) id rows back to names (utils/gen_result.py semantics —
    id→name result rewriting)."""
    id2ent = {v: k for k, v in ent2id.items()}
    id2rel = {v: k for k, v in rel2id.items()}
    return [[id2ent[h], id2rel[r], id2ent[t]] for h, r, t in result_rows]


def read_clean_lines(path: str) -> list:
    """Strip-newline file reader (utils/assist.py)."""
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def write_type_constrain_file(path: str, head_type: dict, tail_type: dict):
    with open(path, "w") as f:
        f.write(f"{len(head_type)}\n")
        for r in sorted(head_type):
            hs = head_type[r]
            ts = tail_type[r]
            f.write(f"{r}\t{len(hs)}\t" + "\t".join(map(str, hs)) + "\n")
            f.write(f"{r}\t{len(ts)}\t" + "\t".join(map(str, ts)) + "\n")
