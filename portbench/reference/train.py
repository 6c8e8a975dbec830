"""The fusion training step in the reference: the loss of the
multimodal relation-extrapolation model on a sampled subgraph, its
gradient by autograd over the reference's own graph, and Adam on a
cosine warm-restart rate.

Its inputs are the dataset files, the benchmark's weights, and what the
program's sampler and step drew: each batch's subgraph (node ids, local
edges, masks) and each step's draws (the two masking permutations and the
negative node ids). From those it works out again the images (the store's
training crop seeds are the ``integers(0, 2**63)`` draws of one
``default_rng(seed)``, one per node slot, batch after batch), the tokens,
the patches and every term of the loss.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import data as rdata
from portbench.reference import model as rm


def _contrastive(a, b, row_mask, temperature=0.05):
    a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=1e-12)
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-12)
    logits = (a @ b.T) / temperature
    w = row_mask.float()
    valid = row_mask[:, None] & row_mask[None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e9))

    def nce(m):
        return -(torch.diagonal(torch.log_softmax(m, 0)) * w).sum() / torch.clamp(w.sum(), min=1.0)

    return (nce(logits) + nce(logits.T)) / 2


def loss(cfg: dict, fus: dict, p: dict, batch: dict, draws: dict, n_rel: int):
    """The step's total loss; steps the relation map's spectral vectors in
    ``p``."""
    m3ae = rm.M3AE(dict(cfg, image_mask_ratio=fus["image_mask_ratio"],
                         text_mask_ratio=fus["text_mask_ratio"]))
    img, text, tpad = batch["patches"], batch["text"], batch["text_pad"]
    nm = batch["node_mask"]
    em = batch["edge_mask"]
    src, dst, et = batch["edge_index"][0], batch["edge_index"][1], batch["edge_type"]
    cls = m3ae.representation(p, img, text, tpad)[:, 0]
    x = rm.rgcn(p, cls, src, dst, et, n_rel, em)
    with torch.no_grad():
        rel_cls = m3ae.representation(p, None, batch["rel_ids"], batch["rel_pad"])[:, 0]
    rel = rm.relation_embedding(p, rel_cls, step=True)
    img_out, txt_out, img_mask, txt_mask, img_mean, txt_mean = m3ae.masked(
        p, img, text, tpad, draws["image_ids_shuffle"], draws["text_ids_shuffle"])

    w = em.float()
    pos = (x[src] + rel - x[dst]).abs().sum(-1)
    neg = (x[draws["neg_h"]] + rel[:, None] - x[draws["neg_t"]]).abs().sum(-1)
    diff = torch.clamp(pos[:, None] - neg, min=-fus["margin"])
    gcn = (diff * w[:, None]).sum() / torch.clamp(w.sum() * fus["neg_ent"], min=1.0) + fus["margin"]

    nmf = nm.float()
    valid = img_mask * nmf[:, None]
    per_patch = ((img - img_out) ** 2).mean(-1)
    ratio = torch.clamp(valid.sum(-1) / valid.shape[-1], min=1e-5)
    image_loss = ((per_patch * (valid > 0)).mean(-1) / ratio).mean()

    tvalid = ((txt_mask > 0) & (tpad == 0)).float() * nmf[:, None]
    logp = torch.log_softmax(txt_out, -1).gather(-1, text[..., None])[..., 0]
    text_loss = -((logp * (tvalid > 0)).sum(-1) / torch.clamp(tvalid.sum(-1), min=1e-5)).mean()

    con = _contrastive(img_mean, txt_mean, nm)
    # how near the margin's kink the closest real pair lies
    kink = float((pos[:, None] - neg + fus["margin"]).abs()[em].min().detach())
    return kink, (fus["image_loss_weight"] * image_loss + fus["text_loss_weight"] * text_loss
            + fus["gcn_loss_weight"] * gcn + fus["contrastive_loss_weight"] * con)


def batches(cfg: dict, d: dict, graphs: list, draws: list, pipeline_seed: int, device,
            cache: int = 0) -> list:
    """The reference's device batches of the program's sampled subgraphs;
    ``cache``: the side of the image cache the store crops from (0: none)."""
    ids, pads = rdata.texts(d, cfg["text_tokens"])
    rid, rpad = rdata.descriptions(d, cfg["description_tokens"])
    rng = np.random.default_rng(pipeline_seed)
    out = []
    for g, dr in zip(graphs, draws):
        n_id = np.asarray(g["n_id"], np.int64)
        seeds = rng.integers(0, 2 ** 63, size=len(n_id))
        imgs = np.stack([rdata.entity_image(d["mm_info"][i], s, cfg["image_size"], True,
                                            cache) for i, s in zip(n_id, seeds)])

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        et = np.asarray(g["edge_type"], np.int64)
        out.append(dict(
            patches=t(rdata.patches(imgs, cfg["patch_size"])),
            text=t(ids[n_id], torch.int64), text_pad=t(pads[n_id]),
            rel_ids=t(rid[et], torch.int64), rel_pad=t(rpad[et]),
            node_mask=t(g["node_mask"], torch.bool), edge_mask=t(g["edge_mask"], torch.bool),
            edge_index=t(g["edge_index"], torch.int64), edge_type=t(et, torch.int64)))
        out[-1]["draws"] = {k: torch.as_tensor(v).to(device).long()
                            for k, v in dr.items() if k != "neg_failed"}
    return out


def run(cfg: dict, fus: dict, p0: dict, d: dict, graphs: list, draws: list,
        pipeline_seed: int, steps_per_epoch: int, device) -> dict:
    """The first ``len(graphs)`` steps from ``p0``: each step's loss, the
    first step's gradient per leaf, and the parameters after the last."""
    p = {k: v.detach().clone() for k, v in p0.items()}
    leaves = [k for k in p if not k.endswith((".u", ".v"))]
    lr = rm.cosine_restarts(fus["lr_maximum"], fus["lr_minimum"],
                            max(fus["lr_warmup_epochs"] * steps_per_epoch, 1))
    opt = rm.Adam(p, lr, betas=(0.9, 0.999), eps=1e-8)
    losses, first, kinks = [], None, []
    n_rel = len(d["r2id"])
    cache = int(round(cfg["image_size"] * 1.15)) if fus.get("image_cache") else 0
    for b in batches(cfg, d, graphs, draws, pipeline_seed, device, cache):
        for k in leaves:
            p[k] = p[k].detach().requires_grad_()
        kink, total = loss(cfg, fus, p, b, b["draws"], n_rel)
        kinks.append(kink)
        used = [k for k in leaves]
        grads = torch.autograd.grad(total, [p[k] for k in used], allow_unused=True)
        g = {k: gr for k, gr in zip(used, grads) if gr is not None}
        if first is None:
            first = {k: v.detach() for k, v in g.items()}
        losses.append(float(total.detach()))
        for k in leaves:
            p[k] = p[k].detach()
        opt.step(g)
    return dict(losses=losses, grads=first, params={k: p[k] for k in first}, kinks=kinks)
