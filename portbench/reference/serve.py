"""The zero-shot serving round in the reference: every entity's M3AE cls
token (evaluation images: each entity's crop drawn from a seed of its id),
the RGCN over the training triples, the relation embeddings of the
descriptions, each unseen relation's generated vectors from the test
noises, and the Extractor's scores of every test query's candidates on
the shared-list (``rel_shared``) ranking: cosine of the pair embedding
with the mean of the relation's unit generated vectors."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import data as rdata
from portbench.reference import model as rm


def _unit(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


def cls_tokens(m3ae, p, image_fn, text, pad, n: int, block: int, device):
    out = []
    for i in range(0, n, block):
        ids = np.arange(i, min(i + block, n))
        img = None if image_fn is None else torch.as_tensor(image_fn(ids), device=device)
        out.append(m3ae.representation(p, img, torch.as_tensor(text[ids], device=device),
                                       torch.as_tensor(pad[ids], device=device))[:, 0])
    return torch.cat(out)


@torch.no_grad()
def run(cfg: dict, p: dict, q: dict, d: dict, noises: torch.Tensor, pipeline_seed: int,
        device, block: int = 128) -> dict:
    """{ent, rel, generated (per test relation, in file order), scores (per
    query: true score, candidate scores, true id, candidate ids)}."""
    m3ae = rm.M3AE(cfg)
    ids, pads = rdata.texts(d, cfg["text_tokens"])
    rid, rpad = rdata.descriptions(d, cfg["description_tokens"])
    n_ent, n_rel = len(d["e2id"]), len(d["r2id"])

    def images(ent_ids):
        seeds = rdata.eval_seeds(ent_ids, pipeline_seed)
        imgs = np.stack([rdata.entity_image(d["mm_info"][e], s, cfg["image_size"], False)
                         for e, s in zip(ent_ids, seeds)])
        return rdata.patches(imgs, cfg["patch_size"])

    cls = cls_tokens(m3ae, p, images, ids, pads, n_ent, block, device)
    tri = torch.as_tensor(rdata.train_triples(d), device=device)
    ent = rm.rgcn(p, cls, tri[:, 0], tri[:, 2], tri[:, 1], n_rel)
    rel_cls = cls_tokens(m3ae, p, None, rid, rpad, n_rel, block, device)
    rel = rm.relation_embedding(p, rel_cls)

    sym = torch.as_tensor(rdata.symbol_table(d, ent.cpu().numpy(), rel.cpu().numpy()),
                          device=device)
    conn, deg = rdata.neighbours(d, cfg["max_neighbor"])
    conn, deg = torch.as_tensor(conn, device=device), torch.as_tensor(deg, device=device)
    s2, _ = rdata.symbols(d)
    e2id = d["e2id"]
    generated, scores = [], []
    for rname, queries in d["test_candidates"].items():
        r = d["r2id"][rname]
        g = rm.generate(p, rel_cls[r].expand(noises.shape[0], -1), noises)
        generated.append(g)
        vbar = _unit(g).mean(0)
        for key, cands in queries.items():
            head = key.split("\t")[0]
            h = e2id[head]
            c_ids = [e2id[c] for c in cands]
            pairs = torch.as_tensor([[s2[head], s2[c]] for c in cands], device=device)
            hh = torch.full((len(cands),), h, device=device)
            cc = torch.as_tensor(c_ids, device=device)
            emb = rm.extractor(q, sym, pairs, (conn[hh], deg[hh]), (conn[cc], deg[cc]))
            s = (_unit(emb) @ vbar).double().cpu().numpy()
            scores.append((float(s[0]), s[1:], c_ids[0], np.asarray(c_ids[1:])))
    return dict(ent=ent, rel=rel, generated=generated, scores=scores)
