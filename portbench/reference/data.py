"""The reference's own reading of a dataset directory: plain numpy, no
import of the program.

It works out again what the program derives from the files: the token ids
of each text (the hashing tokenizer: whitespace words, FNV-1a, BERT-shaped
ids with 1.0 at PAD), the entity images (PNG decode with the scanline
filters undone here, PIL's bicubic resize, torchvision's random resized
crop, the 50% flip of a training slot, ImageNet normalisation, the
scaled-Xavier noise image of an entity without one), the image patches, the
training triples (deduplicated), the symbol table (relations, entities,
PAD) and the neighbour matrix.
"""

from __future__ import annotations

import functools
import json
import os
import pickle
import struct
import zlib

import numpy as np

IMAGENET_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
IMAGENET_STD = np.asarray((0.229, 0.224, 0.225), np.float32)
_PRECISION_BITS = 22


# -- files ---------------------------------------------------------------------


def load(path: str) -> dict:
    def js(name):
        with open(os.path.join(path, name)) as f:
            return json.load(f)

    with open(os.path.join(path, "MultiModalInfo_zsl.pkl"), "rb") as f:
        mm_info = pickle.load(f)
    with open(os.path.join(path, "rel_description_zsl")) as f:
        rel_des = [line.rstrip("\n") for line in f]
    return dict(e2id=js("entity2ids_zsl.json"), r2id=js("relation2ids.json"),
                train_tasks=js("train_tasks_zsl.json"), test_tasks=js("test_tasks_zsl.json"),
                test_candidates=js("test_candidates.json"), mm_info=mm_info, rel_des=rel_des)


def train_triples(d: dict) -> np.ndarray:
    """The training triples as unique (h, r, t) id rows."""
    rows = [(d["e2id"][h], d["r2id"][r], d["e2id"][t])
            for rows in d["train_tasks"].values() for h, r, t in rows]
    return np.unique(np.asarray(rows, np.int64).reshape(-1, 3), axis=0)


# -- text ----------------------------------------------------------------------


def tokenize(text: str, max_length: int, vocab_size: int = 30522):
    ids = np.zeros(max_length, np.int64)
    pad = np.ones(max_length, np.float32)
    for i, w in enumerate(text.split()[:max_length]):
        h = 2166136261
        for ch in w.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        ids[i] = 1 + h % (vocab_size - 1)
        pad[i] = 0.0
    return ids, pad


def texts(d: dict, max_length: int = 64):
    """Entity text ids and PAD masks, one row per entity id."""
    out = [tokenize(rec[-1], max_length) for rec in d["mm_info"]]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def descriptions(d: dict, max_length: int = 320):
    out = [tokenize(line, max_length) for line in d["rel_des"]]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


# -- PNG -----------------------------------------------------------------------


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return row
    if kind == 2:
        return (row.astype(np.int32) + prev).astype(np.uint8)
    if kind == 1:
        px = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    out = bytearray(len(row))
    up = prev.tolist()
    cur = row.tolist()
    for i in range(len(cur)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            out[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB non-interlaced PNG → uint8 [H, W, 3]."""
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    width, height, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"reference PNG reader: depth {depth}, colour {color}, "
                         f"interlace {interlace} not handled")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, 1 + 3 * width)
    rows, prev = [], np.zeros(3 * width, np.uint8)
    for y in range(height):
        prev = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, 3)
        rows.append(prev)
    return np.stack(rows).reshape(height, width, 3)


# -- PIL's bicubic resize (Resample.c) ----------------------------------------


def _cubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@functools.lru_cache(maxsize=256)
def _coeffs(in_size: int, out_size: int):
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_cubic((x + xmin - center + 0.5) / filterscale) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x in range(xmax):
            k = w[x] / ww if ww != 0.0 else w[x]
            scaled = k * (1 << _PRECISION_BITS)
            kk[xx, x] = int(-0.5 + scaled) if k < 0 else int(0.5 + scaled)
        xmins[xx] = xmin
    return xmins, kk


def _resample(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    xmins, kk = _coeffs(in_size, out_size)
    idx = np.minimum(xmins[:, None] + np.arange(kk.shape[1])[None, :], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.einsum("okpc,ok->opc", src[idx], kk) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, size: int) -> np.ndarray:
    out = img if img.shape[1] == size else _resample(img, size, 1)
    return out if out.shape[0] == size else _resample(out, size, 0)


def random_resized_crop(rng: np.random.Generator, img: np.ndarray, size: int,
                        scale=(0.2, 1.0), ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """torchvision's RandomResizedCrop: ten tries of area and log-ratio, then
    the clamped centre crop; resized bicubically."""
    h, w = img.shape[:2]
    for _ in range(10):
        target = h * w * rng.uniform(*scale)
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            top = rng.integers(0, h - ch + 1)
            left = rng.integers(0, w - cw + 1)
            return resize_bicubic(img[top:top + ch, left:left + cw], size)
    if w / h < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif w / h > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    top, left = (h - ch) // 2, (w - cw) // 2
    return resize_bicubic(img[top:top + ch, left:left + cw], size)


def entity_image(mm_record, seed: int, size: int, train: bool, cache: int = 0) -> np.ndarray:
    """One slot's float32 [size, size, 3] image from its seed: a decoded,
    cropped (and in training maybe flipped) normalised image, or the noise
    image U(±1/√size)·10 of an entity without one. With ``cache`` (the
    side of a pre-decoded image cache) the crop is a random ``size`` window
    of the image resized to ``cache``: its top, then its left."""
    rng = np.random.default_rng(seed)
    if len(mm_record) != 2:
        limit = 1.0 / np.sqrt(size)
        return (rng.uniform(-limit, limit, (size, size, 3)) * 10.0).astype(np.float32)
    if cache:
        full = resize_bicubic(decode_png(mm_record[0]), cache)
        span = cache - size
        top = int(rng.integers(0, span + 1)) if span > 0 else 0
        left = int(rng.integers(0, span + 1)) if span > 0 else 0
        img = full[top:top + size, left:left + size]
    else:
        img = random_resized_crop(rng, decode_png(mm_record[0]), size)
    if train and rng.random() < 0.5:
        img = img[:, ::-1]
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def eval_seeds(ids: np.ndarray, pipeline_seed: int = 0) -> np.ndarray:
    return np.asarray(ids, np.int64) * 2654435761 + pipeline_seed


def patches(images: np.ndarray, p: int) -> np.ndarray:
    """[B, H, W, C] → [B, (H/p)(W/p), p·p·C], row-major patches."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // p, p, w // p, p, c).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(x.reshape(b, (h // p) * (w // p), p * p * c))


# -- the ZSL symbol space ------------------------------------------------------


def symbols(d: dict):
    """(symbol id of each name, PAD id): relations, then entities."""
    names = [k for k in d["r2id"] if k not in ("", "OOV")]
    names += [k for k in d["e2id"] if k not in ("", "OOV")]
    return {k: i for i, k in enumerate(names)}, len(names)


def symbol_table(d: dict, ent: np.ndarray, rel: np.ndarray) -> np.ndarray:
    rows = [rel[d["r2id"][k]] for k in d["r2id"] if k not in ("", "OOV")]
    rows += [ent[d["e2id"][k]] for k in d["e2id"] if k not in ("", "OOV")]
    rows.append(np.zeros(rel.shape[1], rel.dtype))
    return np.stack(rows)


def neighbours(d: dict, max_neighbor: int):
    """(connections [E, K, 2] of (relation symbol, entity symbol), degrees
    [E]): both directions of every train and test triple, the first K in
    file order."""
    s2, pad = symbols(d)
    n = len(d["e2id"])
    lists = [[] for _ in range(n)]
    for tasks in (d["train_tasks"], d["test_tasks"]):
        for rows in tasks.values():
            for e1, r, e2 in rows:
                lists[d["e2id"][e1]].append((s2[r], s2[e2]))
                lists[d["e2id"][e2]].append((s2[r], s2[e1]))
    conn = np.full((n, max_neighbor, 2), pad, np.int64)
    deg = np.zeros(n, np.float32)
    for i, ns in enumerate(lists):
        ns = ns[:max_neighbor]
        deg[i] = len(ns)
        if ns:
            conn[i, :len(ns)] = ns
    return conn, deg
