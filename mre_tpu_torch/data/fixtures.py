"""Synthetic dataset writers (port of mre_tpu/data/fixtures.py).

Same files, same schemas and the same rng streams as the JAX package's
writers, so a seed gives the same files byte for byte: entity images are
written by the port's own PNG encoder (``data/images.py``), which writes
the bytes PIL does, so the pickled ``MultiModalInfo_zsl.pkl`` is equal
too.

Schemas (with their reference readers):

* OpenKE benchmark dirs: ``{train,valid,test}2id.txt``, ``entity2id.txt``,
  ``relation2id.txt``, ``type_constrain.txt`` (base/Reader.h:52-317);
* ZSL dataset dirs: ``entity2ids_zsl.json``,
``relation2ids.json``, ``{train,test}_tasks_zsl.json``,
``rel_description_zsl``, ``rel2candidates_all.json``, ``e1rel_e2_all.json``,
``MultiModalInfo_zsl.pkl``, ``{mode}_candidates.json``
(module/utils.py:194-230, zsl_module.py:146-155, utils/gen_*.py).
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from mre_tpu_torch.data.images import encode_png

_WORDS = ("graph relation entity image text node edge link concept domain "
          "subject object property attribute class member part whole agent "
          "place event time person thing group unit").split()


def _sentence(rng: np.random.Generator, n: int) -> str:
    return " ".join(rng.choice(_WORDS, n))


def _png_bytes(rng: np.random.Generator, size: int = 16) -> bytes:
    arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    return encode_png(arr)


def random_triples(rng: np.random.Generator, n_ent, n_rel, n_tri) -> np.ndarray:
    tri = np.stack([rng.integers(0, n_ent, n_tri), rng.integers(0, n_rel, n_tri),
                    rng.integers(0, n_ent, n_tri)], 1)
    return np.unique(tri, axis=0).astype(np.int64)


def write_openke_benchmark(path: str, n_ent=60, n_rel=8, n_train=400,
                           n_valid=40, n_test=40, seed=0, with_types=True):
    """Write an OpenKE-format benchmark directory; returns the splits by
    file name, as [n, 3] (h, r, t) arrays."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    tri = random_triples(rng, n_ent, n_rel, n_train + n_valid + n_test + 50)
    rng.shuffle(tri)
    splits = {"train2id.txt": tri[:n_train],
              "valid2id.txt": tri[n_train:n_train + n_valid],
              "test2id.txt": tri[n_train + n_valid:n_train + n_valid + n_test]}
    for name, rows in splits.items():
        with open(os.path.join(path, name), "w") as f:
            f.write(f"{len(rows)}\n")
            # file column order: head tail rel
            f.write("".join(f"{h} {t} {r}\n" for h, r, t in rows.tolist()))
    for name, n, kind in (("entity2id.txt", n_ent, "ent"), ("relation2id.txt", n_rel, "rel")):
        with open(os.path.join(path, name), "w") as f:
            f.write(f"{n}\n" + "".join(f"/{kind}/{i}\t{i}\n" for i in range(n)))
    if with_types:
        # per relation: a line of observed head candidates, then of tails
        with open(os.path.join(path, "type_constrain.txt"), "w") as f:
            f.write(f"{n_rel}\n")
            for r in range(n_rel):
                mask = tri[:, 1] == r
                for ids in (np.unique(tri[mask, 0]), np.unique(tri[mask, 2])):
                    f.write(f"{r}\t{len(ids)}\t" + "\t".join(map(str, ids)) + "\n")
    return splits


def write_zsl_dataset(path: str, n_ent=80, n_rel=12, n_unseen=3,
                      triples_per_rel=30, image_ratio=0.7, n_candidates=20,
                      image_size=16, seed=0):
    """Write a ZSL dataset directory with the reference's exact schemas.

    Entities/relations get string names mapped by the id json files; train
    tasks hold the seen relations, test tasks the unseen ones. Returns the
    dict of in-memory structures for convenience.
    """
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    ents = [f"/m/ent{i:04d}" for i in range(n_ent)]
    rels = [f"/r/rel{i:03d}" for i in range(n_rel)]
    e2id = {e: i for i, e in enumerate(ents)}
    r2id = {r: i for i, r in enumerate(rels)}

    seen = rels[: n_rel - n_unseen]
    unseen = rels[n_rel - n_unseen:]

    def make_tasks(rel_names):
        tasks = {}
        for rname in rel_names:
            rows = []
            for _ in range(triples_per_rel):
                h, t = rng.integers(0, n_ent, 2)
                if h != t:
                    rows.append([ents[h], rname, ents[t]])
            tasks[rname] = rows
        return tasks

    train_tasks = make_tasks(seen)
    test_tasks = make_tasks(unseen)

    json.dump(e2id, open(os.path.join(path, "entity2ids_zsl.json"), "w"))
    json.dump(r2id, open(os.path.join(path, "relation2ids.json"), "w"))
    json.dump(train_tasks, open(os.path.join(path, "train_tasks_zsl.json"), "w"))
    json.dump(test_tasks, open(os.path.join(path, "test_tasks_zsl.json"), "w"))

    # one description line per relation, in relation-id order
    with open(os.path.join(path, "rel_description_zsl"), "w") as f:
        for rname in rels:
            f.write(f"{rname} {_sentence(rng, 12)}\n")

    # rel2candidates_all: per relation, a candidate entity-name list
    rel2candidates = {}
    for rname in rels:
        cands = rng.choice(ents, min(n_candidates + 10, n_ent), replace=False)
        rel2candidates[rname] = [str(c) for c in cands]
    json.dump(rel2candidates, open(os.path.join(path, "rel2candidates_all.json"), "w"))

    # e1rel_e2_all: "<head><rel>" → list of true tails (gen_e1r_e2_all.py schema)
    e1rel_e2 = {}
    for tasks in (train_tasks, test_tasks):
        for rname, rows in tasks.items():
            for h, r, t in rows:
                e1rel_e2.setdefault(h + r, []).append(t)
    json.dump(e1rel_e2, open(os.path.join(path, "e1rel_e2_all.json"), "w"))

    # multimodal info: per entity either [image_bytes, text] or [text]
    mm_info = []
    for i in range(n_ent):
        text = _sentence(rng, int(rng.integers(5, 20)))
        if rng.random() < image_ratio:
            mm_info.append([_png_bytes(rng, image_size), text])
        else:
            mm_info.append([text])
    with open(os.path.join(path, "MultiModalInfo_zsl.pkl"), "wb") as f:
        pickle.dump(mm_info, f)

    # test_candidates.json: per unseen relation, {"h\tr\ttrue": [true, …]}
    # filtered candidate lists with the true tail first (gen_mode_candidates.py)
    test_candidates = {}
    for rname, rows in test_tasks.items():
        per_rel = {}
        for h, r, t in rows[: max(4, len(rows) // 2)]:
            noise = [c for c in rel2candidates[rname]
                     if c != t and c not in e1rel_e2.get(h + r, [])][:n_candidates]
            per_rel[f"{h}\t{r}\t{t}"] = [t] + noise
        test_candidates[rname] = per_rel
    json.dump(test_candidates, open(os.path.join(path, "test_candidates.json"), "w"))

    return dict(e2id=e2id, r2id=r2id, train_tasks=train_tasks, test_tasks=test_tasks,
                rel2candidates=rel2candidates, e1rel_e2=e1rel_e2, mm_info=mm_info,
                test_candidates=test_candidates)


_TYPE_WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa "
               "lambda mu nu xi omicron pi").split()


def write_learnable_zsl_dataset(path: str, n_types=6, ents_per_type=20,
                                n_rel=14, n_unseen=3, triples_per_rel=40,
                                image_ratio=0.7, n_candidates=30,
                                image_size=16, seed=0):
    """A ZSL dataset with *learnable* zero-shot structure
    (mre_tpu/data/fixtures.py:178-275).

    Entities carry latent types named in their text; each relation links one
    source type to one target type, and its description names that type
    pair, so a model that grounds descriptions in entity text can rank
    candidates of the right type for relations it never saw. Unseen
    relations reuse type pairs of seen ones. Candidate lists mix right-type
    and wrong-type tails, so random ranking is uniform while a type-aware
    model does far better. Returns the in-memory structures.
    """
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_ent = n_types * ents_per_type
    ents = [f"/m/ent{i:04d}" for i in range(n_ent)]
    ent_type = np.repeat(np.arange(n_types), ents_per_type)
    rels = [f"/r/rel{i:03d}" for i in range(n_rel)]
    e2id = {e: i for i, e in enumerate(ents)}
    r2id = {r: i for i, r in enumerate(rels)}

    # (src_type, dst_type) per relation; unseen relations reuse seen pairs
    pairs = [(int(rng.integers(n_types)), int(rng.integers(n_types)))
             for _ in range(n_rel - n_unseen)]
    for _ in range(n_unseen):
        pairs.append(pairs[int(rng.integers(n_rel - n_unseen))])

    def sample_triples(rel_idx):
        src_t, dst_t = pairs[rel_idx]
        src_pool = np.nonzero(ent_type == src_t)[0]
        dst_pool = np.nonzero(ent_type == dst_t)[0]
        rows = []
        for _ in range(triples_per_rel):
            h = int(rng.choice(src_pool))
            t = int(rng.choice(dst_pool))
            if h != t:
                rows.append([ents[h], rels[rel_idx], ents[t]])
        return rows

    train_tasks = {rels[i]: sample_triples(i) for i in range(n_rel - n_unseen)}
    test_tasks = {rels[i]: sample_triples(i) for i in range(n_rel - n_unseen, n_rel)}

    json.dump(e2id, open(os.path.join(path, "entity2ids_zsl.json"), "w"))
    json.dump(r2id, open(os.path.join(path, "relation2ids.json"), "w"))
    json.dump(train_tasks, open(os.path.join(path, "train_tasks_zsl.json"), "w"))
    json.dump(test_tasks, open(os.path.join(path, "test_tasks_zsl.json"), "w"))

    with open(os.path.join(path, "rel_description_zsl"), "w") as f:
        for i in range(n_rel):
            src_t, dst_t = pairs[i]
            f.write(f"relation links {_TYPE_WORDS[src_t]} source to "
                    f"{_TYPE_WORDS[dst_t]} target {_sentence(rng, 6)}\n")

    # candidates: half right-type, half wrong-type entities
    rel2candidates = {}
    for i, rname in enumerate(rels):
        _, dst_t = pairs[i]
        right = rng.choice(np.nonzero(ent_type == dst_t)[0],
                           min(n_candidates // 2, ents_per_type), replace=False)
        wrong = rng.choice(np.nonzero(ent_type != dst_t)[0],
                           n_candidates - len(right), replace=False)
        rel2candidates[rname] = [ents[j] for j in np.concatenate([right, wrong])]
    json.dump(rel2candidates, open(os.path.join(path, "rel2candidates_all.json"), "w"))

    e1rel_e2 = {}
    for tasks in (train_tasks, test_tasks):
        for rname, rows in tasks.items():
            for h, r, t in rows:
                e1rel_e2.setdefault(h + r, []).append(t)
    json.dump(e1rel_e2, open(os.path.join(path, "e1rel_e2_all.json"), "w"))

    mm_info = []
    for i in range(n_ent):
        tname = _TYPE_WORDS[ent_type[i]]
        text = f"{tname} kind entity {tname} {_sentence(rng, 6)}"
        if rng.random() < image_ratio:
            mm_info.append([_png_bytes(rng, image_size), text])
        else:
            mm_info.append([text])
    with open(os.path.join(path, "MultiModalInfo_zsl.pkl"), "wb") as f:
        pickle.dump(mm_info, f)

    test_candidates = {}
    for rname, rows in test_tasks.items():
        per_rel = {}
        for h, r, t in rows[: max(8, len(rows) // 2)]:
            noise = [c for c in rel2candidates[rname]
                     if c != t and c not in e1rel_e2.get(h + r, [])]
            per_rel[f"{h}\t{r}\t{t}"] = [t] + noise
        test_candidates[rname] = per_rel
    json.dump(test_candidates, open(os.path.join(path, "test_candidates.json"), "w"))

    return dict(e2id=e2id, r2id=r2id, pairs=pairs, ent_type=ent_type,
                train_tasks=train_tasks, test_tasks=test_tasks)
