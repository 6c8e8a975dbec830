"""ZSL dataset-directory loaders (copy of mre_tpu/data/loaders.py).

Equivalent of ``load_appendix_data`` (module/utils.py:194-230) plus the ZSL
module's extra files (module/zsl_module.py:146-155): id maps, task triples,
multimodal records, relation descriptions, candidate lists.
"""

from __future__ import annotations

import json
import os
import pickle


def load_tasks(path: str, mode: str) -> dict:
    with open(os.path.join(path, f"{mode}_tasks_zsl.json")) as f:
        return json.load(f)


def load_zsl_dataset(path: str, mode: str = "train") -> dict:
    with open(os.path.join(path, "entity2ids_zsl.json")) as f:
        e2id = json.load(f)
    with open(os.path.join(path, "relation2ids.json")) as f:
        r2id = json.load(f)
    tasks = load_tasks(path, mode)

    h, r, t = [], [], []
    for rel, rows in tasks.items():
        for head, rel_, tail in rows:
            h.append(e2id[head])
            r.append(r2id[rel_])
            t.append(e2id[tail])

    with open(os.path.join(path, "MultiModalInfo_zsl.pkl"), "rb") as f:
        mm_info = pickle.load(f)

    rel_des = []
    with open(os.path.join(path, "rel_description_zsl")) as f:
        for line in f:
            rel_des.append(line.rstrip("\n"))

    return dict(triples=[h, r, t], mm_info=mm_info, rel_des=rel_des,
                e2id=e2id, r2id=r2id, tasks=tasks)


def load_candidates(path: str, mode: str = "test") -> dict:
    """``{mode}_candidates.json`` — per relation, per "h\\tr\\ttrue" query,
    the candidate tail list with the true tail first."""
    with open(os.path.join(path, f"{mode}_candidates.json")) as f:
        return json.load(f)


def load_rel2candidates(path: str) -> dict:
    with open(os.path.join(path, "rel2candidates_all.json")) as f:
        return json.load(f)


def load_e1rel_e2(path: str) -> dict:
    with open(os.path.join(path, "e1rel_e2_all.json")) as f:
        return json.load(f)
