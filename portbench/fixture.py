"""The benchmark's traffic generator: a ZSL dataset directory drawn from a
seed, frozen here so that later changes to the program cannot move it.

A copy of ``write_zsl_dataset`` and of the PIL-equal PNG encoder of the
port's ``data/fixtures.py`` and ``data/images.py``: the same files, schemas
and rng streams. The directory holds what a user's dataset holds
(``entity2ids_zsl.json``, ``relation2ids.json``, ``{train,test}_tasks_zsl.json``,
``rel_description_zsl``, ``rel2candidates_all.json``, ``e1rel_e2_all.json``,
``MultiModalInfo_zsl.pkl``, ``test_candidates.json``); the program and the
reference both read these files.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import zlib

import numpy as np

_WORDS = ("graph relation entity image text node edge link concept domain "
          "subject object property attribute class member part whole agent "
          "place event time person thing group unit").split()
_SIG = b"\x89PNG\r\n\x1a\n"


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _filter_rows(img: np.ndarray) -> np.ndarray:
    """Scanlines [H, 1 + 3W] with their filter byte: per row the filter of
    least summed |signed byte| among None, Up, Sub and Paeth, ties to the
    first (PIL's ZipEncode.c)."""
    h, w, _ = img.shape
    cur = img.reshape(h, w * 3).astype(np.int32)
    up = np.concatenate([np.zeros((1, w * 3), np.int32), cur[:-1]])
    left = np.concatenate([np.zeros((h, 3), np.int32), cur[:, :-3]], axis=1)
    up_left = np.concatenate([np.zeros((h, 3), np.int32), up[:, :-3]], axis=1)
    types = np.array([0, 2, 1, 4], np.uint8)
    cands = np.stack([cur, cur - up, cur - left, cur - _paeth(left, up, up_left)]) & 0xFF
    cost = np.where(cands < 128, cands, 256 - cands).sum(-1)
    pick = np.argmin(cost, axis=0)
    rows = cands[pick, np.arange(h)].astype(np.uint8)
    return np.concatenate([types[pick][:, None], rows], axis=1)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] → the PNG bytes PIL writes (RGB, 8 bits, zlib memory
    level 9, ``Z_FILTERED``)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError("encode_png takes [H, W, 3] RGB")
    z = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = z.compress(_filter_rows(img).tobytes()) + z.flush()
    block = max(65536, 4 * w)
    idat = b"".join(_chunk(b"IDAT", data[i:i + block]) for i in range(0, len(data), block))
    return (_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + idat + _chunk(b"IEND", b""))


def _sentence(rng: np.random.Generator, n: int) -> str:
    return " ".join(rng.choice(_WORDS, n))


def _dump_json(path: str, obj) -> None:
    with open(path, "w") as f:
        f.write(json.dumps(obj))


def write_zsl_dataset(path: str, n_ent=80, n_rel=12, n_unseen=3, triples_per_rel=30,
                      image_ratio=0.7, n_candidates=20, image_size=16, seed=0) -> dict:
    """Write a ZSL dataset directory: ``n_rel`` relations of which the last
    ``n_unseen`` are unseen (test tasks), ``triples_per_rel`` drawn triples
    per relation (a drawn self-loop is dropped), ``image_ratio`` of the
    entities with a random ``image_size`` px PNG, ``n_candidates`` filtered
    candidates per test query with the true tail first. Returns the
    in-memory structures."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    ents = [f"/m/ent{i:04d}" for i in range(n_ent)]
    rels = [f"/r/rel{i:03d}" for i in range(n_rel)]
    e2id = {e: i for i, e in enumerate(ents)}
    r2id = {r: i for i, r in enumerate(rels)}
    seen, unseen = rels[: n_rel - n_unseen], rels[n_rel - n_unseen:]

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
    _dump_json(os.path.join(path, "entity2ids_zsl.json"), e2id)
    _dump_json(os.path.join(path, "relation2ids.json"), r2id)
    _dump_json(os.path.join(path, "train_tasks_zsl.json"), train_tasks)
    _dump_json(os.path.join(path, "test_tasks_zsl.json"), test_tasks)
    with open(os.path.join(path, "rel_description_zsl"), "w") as f:
        for rname in rels:
            f.write(f"{rname} {_sentence(rng, 12)}\n")

    rel2candidates = {}
    for rname in rels:
        cands = rng.choice(ents, min(n_candidates + 10, n_ent), replace=False)
        rel2candidates[rname] = [str(c) for c in cands]
    _dump_json(os.path.join(path, "rel2candidates_all.json"), rel2candidates)

    e1rel_e2 = {}
    for tasks in (train_tasks, test_tasks):
        for rname, rows in tasks.items():
            for h, r, t in rows:
                e1rel_e2.setdefault(h + r, []).append(t)
    _dump_json(os.path.join(path, "e1rel_e2_all.json"), e1rel_e2)

    mm_info = []
    for _ in range(n_ent):
        text = _sentence(rng, int(rng.integers(5, 20)))
        if rng.random() < image_ratio:
            arr = rng.integers(0, 255, (image_size, image_size, 3), dtype=np.uint8)
            mm_info.append([encode_png(arr), text])
        else:
            mm_info.append([text])
    with open(os.path.join(path, "MultiModalInfo_zsl.pkl"), "wb") as f:
        pickle.dump(mm_info, f)

    test_candidates = {}
    for rname, rows in test_tasks.items():
        per_rel = {}
        for h, r, t in rows[: max(4, len(rows) // 2)]:
            known = set(e1rel_e2.get(h + r, []))
            noise = [c for c in rel2candidates[rname] if c != t and c not in known][:n_candidates]
            per_rel[f"{h}\t{r}\t{t}"] = [t] + noise
        test_candidates[rname] = per_rel
    _dump_json(os.path.join(path, "test_candidates.json"), test_candidates)
    return dict(e2id=e2id, r2id=r2id, train_tasks=train_tasks, test_tasks=test_tasks,
                rel2candidates=rel2candidates, e1rel_e2=e1rel_e2, mm_info=mm_info,
                test_candidates=test_candidates)
