"""The ZSL adversarial epochs in the reference: WGAN-GP critic steps and
generator steps of the relation generator head, with hinge class losses
against the per-relation centroids and the visual-pivot term.

Its inputs are the dataset files, the benchmark's weights and symbol
embeddings, and what the program's episode sampler and generator drew:
each step's batch (relations, query and false pairs, labels, row mask),
its noise, the gradient penalty's α and the Extractor's dropout masks.
From those it works out again the symbol table, the neighbour matrix, the
centroids, the frozen description encoding and every term of both losses.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import data as rdata
from portbench.reference import model as rm

G_LEAVES = ("generate_fc_layer.weight", "generate_fc_layer.bias", "des_rel_map_layer1.weight",
            "des_rel_map_layer1.bias", "des_rel_map_layer2.weight", "des_rel_map_layer2.bias",
            "layer_norm.a_2", "layer_norm.b_2")


def centroids(q, sym, d, conn, deg, s2, device) -> torch.Tensor:
    """Per seen relation (sorted by name), the mean Extractor embedding of
    its training pairs."""
    rows = []
    for rel in sorted(d["train_tasks"]):
        tri = d["train_tasks"][rel]
        pairs = torch.as_tensor([[s2[h], s2[t]] for h, _, t in tri], device=device)
        left = torch.as_tensor([d["e2id"][h] for h, _, _ in tri], device=device)
        right = torch.as_tensor([d["e2id"][t] for _, _, t in tri], device=device)
        rows.append(rm.extractor(q, sym, pairs, (conn[left], deg[left]),
                                 (conn[right], deg[right])).mean(0))
    return torch.stack(rows)


def run(cfg: dict, zcfg: dict, p0: dict, q0: dict, c0: dict, d: dict, ent, rel, steps: list,
        device) -> dict:
    """``steps``: per step in program order (D, G, D, G, ...), dict(kind,
    batch, noise, alpha, masks). Returns each step's total loss, the first
    D and G gradients and the D and G leaves after the last step."""
    p = {k: v.detach().clone() for k, v in p0.items()}
    c = {k: v.detach().clone() for k, v in c0.items()}
    sym = torch.as_tensor(rdata.symbol_table(d, np.asarray(ent), np.asarray(rel)), device=device)
    conn, deg = rdata.neighbours(d, cfg["max_neighbor"])
    conn, deg = torch.as_tensor(conn, device=device), torch.as_tensor(deg, device=device)
    s2, _ = rdata.symbols(d)
    with torch.no_grad():
        centroid = centroids(q0, sym, d, conn, deg, s2, device)
        rid, rpad = rdata.descriptions(d, cfg["description_tokens"])
        rel_cls = rm.M3AE(cfg).representation(p, None, torch.as_tensor(rid, device=device),
                                              torch.as_tensor(rpad, device=device))[:, 0]
    c_leaves = [k for k in c if not k.endswith((".u", ".v"))]
    opt_d = rm.Adam(c, lambda t: zcfg["lr_D"] * (0.2 if t >= 20000 else 1.0), betas=(0.5, 0.9))
    opt_g = rm.Adam(p, lambda t: zcfg["lr_G"] * (0.2 if t >= 4000 else 1.0), betas=(0.5, 0.9))
    margin = zcfg["pretrain_margin"]
    losses, first = [], {}

    def meta(ids):
        ids = torch.as_tensor(np.asarray(ids), device=device)
        return conn[ids], deg[ids]

    for st in steps:
        rel_ids, query, q_l, q_r, false, f_l, f_r, labels, mask = st["batch"]
        w = torch.as_tensor(mask, dtype=torch.float32, device=device)
        wsum = torch.clamp(w.sum(), min=1.0)
        idx = torch.arange(len(w), device=device)
        lab = torch.as_tensor(np.asarray(labels), device=device)
        cond = rel_cls[torch.as_tensor(np.asarray(rel_ids), device=device)]
        false_t = torch.as_tensor(np.asarray(false), device=device)
        if st["kind"] == "D":
            with torch.no_grad():
                fake = rm.generate(p, cond, st["noise"])
                real = rm.extractor(q0, sym, torch.as_tensor(np.asarray(query), device=device),
                                    meta(q_l), meta(q_r), st["masks"][:10])
                neg = rm.extractor(q0, sym, false_t, meta(f_l), meta(f_r), st["masks"][10:])
            for k in c_leaves:
                c[k] = c[k].detach().requires_grad_()
            real_logit, real_cls = rm.critic(c, real, centroid, step=True)
            fake_logit, fake_cls = rm.critic(c, fake, centroid)
            _, neg_cls = rm.critic(c, neg, centroid)
            loss_real = -(real_logit[:, 0] * w).sum() / wsum
            loss_fake = (fake_logit[:, 0] * w).sum() / wsum
            rs, fs, ns = (x[idx, lab] for x in (real_cls, fake_cls, neg_cls))
            real_c = (F.relu(margin - (rs - ns)) * w).sum() / wsum
            fake_c = (F.relu(margin - (fs - ns)) * w).sum() / wsum
            alpha = st["alpha"]
            inter = (alpha * real + (1 - alpha) * fake).requires_grad_()
            inter_logit, _ = rm.critic(c, inter, centroid)
            g_in, = torch.autograd.grad(inter_logit.sum(), inter, create_graph=True)
            gp = ((torch.linalg.norm(g_in, dim=1) - 1.0) ** 2 * w).sum() / wsum
            gp = gp * zcfg["gp_lambda"]
            total = loss_real + loss_fake + 0.5 * real_c + 0.5 * fake_c + gp
            grads = dict(zip(c_leaves, torch.autograd.grad(total, [c[k] for k in c_leaves])))
            for k in c_leaves:
                c[k] = c[k].detach()
            first.setdefault("D", {f"D.{k}": g.detach() for k, g in grads.items()})
            opt_d.step(grads)
        else:
            with torch.no_grad():
                neg = rm.extractor(q0, sym, false_t, meta(f_l), meta(f_r), st["masks"])
                _, neg_cls = rm.critic(c, neg, centroid)
            for k in G_LEAVES:
                p[k] = p[k].detach().requires_grad_()
            sample = rm.generate(p, cond, st["noise"], step=True)
            g_logit, g_cls = rm.critic(c, sample, centroid)
            loss_fake = -(g_logit[:, 0] * w).sum() / wsum
            loss_cls = (F.relu(margin - (g_cls[idx, lab] - neg_cls[idx, lab])) * w).sum() / wsum
            n_lab = centroid.shape[0]
            onehot = F.one_hot(lab, n_lab).float() * w[:, None]
            cnt = onehot.sum(0)
            means = (onehot.T @ sample) / torch.clamp(cnt, min=1.0)[:, None]
            dist = torch.sqrt(torch.clamp(((means - centroid) ** 2).sum(1), min=1e-12))
            vp = torch.where(cnt > 0, dist, torch.zeros_like(dist)).sum() / zcfg["gan_batch_rela"]
            total = loss_fake + loss_cls + zcfg["vp_weight"] * vp
            grads = dict(zip(G_LEAVES, torch.autograd.grad(total, [p[k] for k in G_LEAVES])))
            for k in G_LEAVES:
                p[k] = p[k].detach()
            first.setdefault("G", {f"G.{k}": g.detach() for k, g in grads.items()})
            opt_g.step(grads)
        losses.append(float(total.detach()))
    params = {f"D.{k}": c[k] for k in c_leaves}
    params.update({f"G.{k}": p[k] for k in G_LEAVES})
    return dict(losses=losses, grads={**first.get("D", {}), **first.get("G", {})}, params=params)
