"""Synthetic ZSL dataset writer (port of mre_tpu/data/fixtures.py::write_zsl_dataset).

Same files, same schemas and the same rng stream as the JAX package's
writer, so a seed gives the same JSON and text files. Entity images are
written by the port's own PNG encoder (``data/images.py``): their bytes
differ from PIL's, their pixels are the same.

Schemas (with their reference readers): ``entity2ids_zsl.json``,
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
