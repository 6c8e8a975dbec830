"""ZSL subsystem orchestrator (port of mre_tpu/zsl/module.py).

* symbol table + neighbor-connection matrix built once on the host
  (zsl/episodes.py); the symbol embedding matrix is refreshed from the
  fusion learner with ``update_embed``;
* Extractor pretraining: episodic margin ranking, adam at ``lr_E``
  (``pretrain_step``, ``pretrain_extractor``; zsl_module.py:289-348);
* per-relation centroids of the Extractor's embeddings (``compute_centroids``);
* adversarial training (``train_gan``): WGAN-GP critic steps (``d_step``;
  the gradient penalty through ``torch.autograd.grad(create_graph=True)``)
  and generator steps (``g_step``) with hinge class losses against the
  centroid matrix and the visual-pivot segment mean. The generator is the
  fusion model's head: only ``G_PARAM_KEYS`` get gradients and G's adam,
  and they are updated in place in the fusion model (the fusion trainer's
  own adam state is left alone);
* evaluation on the ``rel_shared``, ``head_shared`` and ``factored`` paths
  (eval/zero_shot.py).

Random draws (the generator noise, the gradient penalty's α and the
dropout masks) come from one ``torch.Generator`` on the module's device,
seeded with ``cfg.seed``; each step also takes them as ``draws`` (how the
tests feed the JAX step's draws in). ``evaluate(predict_unseen=...)``
takes the unseen relation vectors from the distill predictor
(``FusionTrainer.train_distill``) instead of the generator. ``save`` /
``load`` write the Extractor, the Discriminator (with its spectral vectors)
and the generator (the fusion parameters) as flax-named checkpoints
(core/checkpoint.py). ``evaluate(compute_dtype="bfloat16")`` ranks with
the L/R tables and a bfloat16 copy of the Extractor, as JAX does.

Data parallel (``mesh=``, a ``parallel.mesh.Mesh``): ``d_step``,
``g_step`` and ``train_gan`` split the GAN batch's rows over ``data``.
Every rank draws the full batch's noise, α and dropout masks and keeps its
rows; the gradient penalty stays per sample; the hinge and class terms
become this rank's sum over the global row count; the visual pivot's
per-class sums and counts are summed over the data group (with their
gradient); the gradients are SUMmed before every rank steps its optimizer.
``evaluate(mesh=)`` ranks the ``rel_shared`` chunks data parallel (the JAX
package's only mesh path; any other path raises its ``ValueError``).
"""

from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from mre_tpu_torch.core import checkpoint as ckpt
from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.data import loaders
from mre_tpu_torch.eval.zero_shot import evaluate_zero_shot, evaluate_zero_shot_rel_shared
from mre_tpu_torch.interop import load_flax, module_to_flax
from mre_tpu_torch.models.extractor import Discriminator, Extractor
from mre_tpu_torch.models.initializers import init_weights
from mre_tpu_torch.models.transformer import DropoutMasks, compute_dtype as torch_dtype
from mre_tpu_torch.ops.segment import segment_sum
from mre_tpu_torch.parallel import mesh as pmesh
from mre_tpu_torch.zsl.episodes import EpisodeSampler, SymbolTable, build_connections

G_PARAM_KEYS = ("generate_fc_layer", "des_rel_map_layer1",
                "des_rel_map_layer2", "layer_norm")
EVAL_PATHS = ("rel_shared", "head_shared", "factored")


@dataclasses.dataclass
class ZSLConfig:
    emb_dim: int = 200
    noise_dim: int = 15
    test_sample: int = 20
    max_neighbor: int = 50
    pretrain_margin: float = 3.0
    pretrain_times: int = 10000
    pretrain_batch_size: int = 64
    pretrain_few: int = 8
    pretrain_subepoch: int = 10
    pretrain_loss_every: int = 500
    train_times: int = 1000
    D_epoch: int = 1
    G_epoch: int = 1
    # kept for args.py parity: one G_batch_size generator feeds both the D
    # and the G loops (zsl_module.py:401-409), so D_batch_size is inert
    D_batch_size: int = 256
    G_batch_size: int = 256
    gan_batch_rela: int = 2
    lr_D: float = 1e-4
    lr_E: float = 1e-4
    lr_G: float = 1e-4            # args.lr_maximum in the reference
    loss_every: int = 50
    gp_lambda: float = 10.0
    vp_weight: float = 3.0
    seed: int = 0


def piecewise_constant_schedule(init_value: float, boundaries_and_scales: dict):
    """Step count → rate, as ``optax.piecewise_constant_schedule``: the
    scale of a boundary applies from ``count >= boundary`` on."""
    steps = sorted(boundaries_and_scales.items())

    def schedule(count: int) -> float:
        value = init_value
        for boundary, scale in steps:
            if count >= boundary:
                value *= scale
        return value

    return schedule


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _global_info(info: dict, rows) -> dict:
    """Detached step terms; a data-parallel rank's (its share of each) are
    summed over the data group, so every rank returns the global values."""
    info = {k: v.detach() for k, v in info.items()}
    if rows is None:
        return info
    total = pmesh.all_reduce_sum(torch.stack(list(info.values())), rows.group)
    return dict(zip(info, total.unbind()))


def _history(hist: list) -> list:
    """Per-step dicts of 0-d device tensors → dicts of floats, one fetch."""
    if not hist:
        return []
    keys = list(hist[0])
    rows = torch.stack([torch.stack([h[k] for k in keys]) for h in hist]).cpu().numpy()
    return [dict(zip(keys, map(float, row))) for row in rows]


class ZSLModule:
    def __init__(self, data_path: str, r2id: dict, e2id: dict, cfg: ZSLConfig,
                 device: str | torch.device | None = None, test_noises=None):
        """``test_noises`` [test_sample, noise_dim] may be given (e.g. the JAX
        module's draws); by default they are 0.1·N(0, 1) from a generator
        seeded with ``cfg.seed``."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.data_path = data_path
        self.r2id, self.e2id = r2id, e2id

        self.train_tasks = loaders.load_tasks(data_path, "train")
        self.test_tasks = loaders.load_tasks(data_path, "test")
        self.rel2candidates = loaders.load_rel2candidates(data_path)
        self.e1rel_e2 = loaders.load_e1rel_e2(data_path)

        self.symbols = SymbolTable(r2id, e2id)
        self.episodes = EpisodeSampler(self.train_tasks, self.rel2candidates,
                                       self.e1rel_e2, self.symbols, seed=cfg.seed)
        self.label_num = self.episodes.label_num
        conns, degs = build_connections(
            [self.train_tasks, self.test_tasks], self.symbols.symbol2id,
            e2id, len(e2id), self.symbols.pad_id, cfg.max_neighbor)
        self.connections = torch.as_tensor(conns, device=self.device)
        self.degrees = torch.as_tensor(degs, device=self.device)

        if test_noises is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            test_noises = 0.1 * torch.randn(cfg.test_sample, cfg.noise_dim, generator=gen)
        self.test_noises = torch.tensor(_host(test_noises), dtype=torch.float32,
                                        device=self.device)
        self.symbol_table = torch.zeros(self.symbols.num_symbols + 1, cfg.emb_dim,
                                        device=self.device)
        self.extractor = init_weights(Extractor(cfg.emb_dim), cfg.seed + 1).to(self.device)
        self.discriminator = init_weights(Discriminator(cfg.emb_dim),
                                          cfg.seed + 2).to(self.device)

        # optax.adam(lr_E) defaults for E; D and G: adam(b1 0.5, b2 0.9) on a
        # piecewise-constant rate (zsl/module.py:116-120, :442-443). E's and
        # D's state persist across train_gan calls, G's is made anew in each.
        self.opt_E = torch.optim.Adam(self.extractor.parameters(), lr=cfg.lr_E,
                                      betas=(0.9, 0.999), eps=1e-8)
        self.d_schedule = piecewise_constant_schedule(cfg.lr_D, {20000: 0.2})
        self.opt_D = torch.optim.Adam(self.discriminator.parameters(), lr=self.d_schedule(0),
                                      betas=(0.5, 0.9), eps=1e-8)
        self.d_steps = 0
        self.g_schedule = piecewise_constant_schedule(cfg.lr_G, {4000: 0.2})
        self.opt_G, self.g_params, self.g_steps = None, [], 0

        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.centroid_matrix = torch.zeros(self.label_num, cfg.emb_dim, device=self.device)

    # ------------------------------------------------------------------

    def _put(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _meta(self, left, right):
        left, right = self._put(left), self._put(right)
        return (self.connections[left], self.degrees[left],
                self.connections[right], self.degrees[right])

    def _dropout(self, draws: dict | None, rows=None) -> DropoutMasks:
        if draws is not None and "dropout" in draws:
            return DropoutMasks(masks=draws["dropout"], rows=rows)
        return DropoutMasks(generator=self._gen, rows=rows)

    def _draw(self, draws: dict | None, key: str, shape, sample=torch.randn,
              rows=None) -> torch.Tensor:
        """``draws[key]`` if given, else ``sample(shape)`` from the module's
        generator; with ``rows`` (a ``RowShard``) the rank's rows of it."""
        if draws is not None and key in draws:
            x = self._put(_host(draws[key]), torch.float32)
        else:
            x = sample(shape, generator=self._gen, device=self.device)
        return x if rows is None else rows.local(x)

    def _gan_rows(self, batch, mesh):
        """The rank's ``RowShard`` of a GAN batch and the batch cut to it
        (None and the batch itself without a data-parallel mesh)."""
        if mesh is None or mesh.n_data == 1:
            return None, batch
        rows = pmesh.row_shard(mesh, len(batch[1]))
        return rows, tuple(np.asarray(a)[rows.rows] for a in batch)

    def _weights(self, mask, rows=None):
        """Row weights and their global sum (at least 1; summed over the
        data group, without a gradient, for a data-parallel rank)."""
        w = self._put(mask, torch.float32)
        total = w.sum() if rows is None else pmesh.all_reduce_sum(w.sum(), rows.group)
        return w, torch.clamp(total, min=1.0)

    def update_embed(self, ent_embs, rel_embs):
        """Refresh the frozen symbol table from fusion-learner embeddings
        (zsl_module.py:209-237)."""
        table = self.symbols.build_embedding(_host(ent_embs), _host(rel_embs))
        self.symbol_table = torch.as_tensor(table, dtype=torch.float32,
                                            device=self.device)

    # -- Extractor pretraining (zsl_module.py:289-348) ----------------------

    def _padded_episode(self):
        """An episode padded to fixed shapes: padded rows repeat the last
        row (they enter the support mean, as in JAX); ``q_mask`` keeps
        padded queries out of the loss."""
        cfg = self.cfg
        S = cfg.pretrain_few * cfg.pretrain_subepoch
        Q = cfg.pretrain_batch_size * cfg.pretrain_subepoch
        (support, query, false, s_l, s_r, q_l, q_r, f_l, f_r) = \
            self.episodes.extractor_episode(cfg.pretrain_batch_size,
                                            cfg.pretrain_few, cfg.pretrain_subepoch)

        def pad_rows(a, n, cols=None):
            shape = (n,) if cols is None else (n, cols)
            a = np.asarray(a, np.int64).reshape((-1,) if cols is None else (-1, cols))
            if len(a) == 0:
                return np.zeros(shape, np.int64)
            reps = np.repeat(a[-1:], n - len(a), axis=0) if len(a) < n else a[:0]
            return np.concatenate([a[:n], reps])

        q_mask = np.zeros(Q, np.float32)
        q_mask[:min(len(query), Q)] = 1.0
        return (pad_rows(support, S, 2), pad_rows(query, Q, 2), pad_rows(false, Q, 2),
                pad_rows(s_l, S), pad_rows(s_r, S), pad_rows(q_l, Q),
                pad_rows(q_r, Q), pad_rows(f_l, Q), pad_rows(f_r, Q), q_mask)

    def pretrain_step(self, episode=None, draws: dict | None = None) -> torch.Tensor:
        """One Extractor step (zsl/module.py:149-167) on ``episode`` (default:
        the next padded episode). The support is encoded once per Extractor
        call, each with its own dropout masks; ``draws["dropout"]`` may give
        all 20 masks in call order. Returns the loss as a 0-d device tensor."""
        cfg = self.cfg
        support, query, false, s_l, s_r, q_l, q_r, f_l, f_r, q_mask = (
            self._padded_episode() if episode is None else episode)
        support = self._put(support)
        s_meta = self._meta(s_l, s_r)
        drop = self._dropout(draws)
        _, q_scores = self.extractor(self.symbol_table, self._put(query), support,
                                     self._meta(q_l, q_r), s_meta, False, drop)
        _, f_scores = self.extractor(self.symbol_table, self._put(false), support,
                                     self._meta(f_l, f_r), s_meta, False, drop)
        drop.check_all_used()
        q_mask = self._put(q_mask, torch.float32)
        hinge = F.relu(cfg.pretrain_margin - (q_scores - f_scores))
        loss = (hinge * q_mask).sum() / torch.clamp(q_mask.sum(), min=1.0)
        self.opt_E.zero_grad(set_to_none=True)
        loss.backward()
        self.opt_E.step()
        return loss.detach()

    def pretrain_extractor(self, steps: int | None = None,
                           log_every: int | None = None) -> float:
        cfg = self.cfg
        steps = steps or cfg.pretrain_times
        log_every = log_every or cfg.pretrain_loss_every
        losses = []
        for i in range(steps):
            # device scalars, fetched once per log window
            losses.append(self.pretrain_step())
            if (i + 1) % log_every == 0:
                w = torch.stack(losses[-log_every:]).mean().item()
                print(f"Step: {i + 1}, Extractor pretraining loss: {w:.3f}")
        if not losses:
            return 0.0
        return float(torch.stack(losses[-min(len(losses), 100):]).mean())

    # -- centroid matrix (zsl_module.py:371-383) -----------------------------

    @torch.no_grad()
    def compute_centroids(self, pad_to: int = 256) -> torch.Tensor:
        """Per-relation mean of the Extractor's (eval) embeddings over every
        training triple, in chunks of ``pad_to``; the chunk means are
        count-weighted into the full mean in float64 on the host."""
        P = max(pad_to, 1)
        chunks = []                                   # (label, k, device mean)
        for rel in self.train_tasks:
            query, left, right, label = self.episodes.centroid_batch(rel)
            n = len(query)
            for off in range(0, max(n, 1), P):
                q, l, r = query[off:off + P], left[off:off + P], right[off:off + P]
                k = len(q)
                pad = P - k
                q = self._put(np.pad(q, ((0, pad), (0, 0))))
                meta = self._meta(np.pad(l, (0, pad)), np.pad(r, (0, pad)))
                q_g, _ = self.extractor(self.symbol_table, q, q, meta, meta, True)
                w = (torch.arange(P, device=self.device) < k).to(torch.float32)[:, None]
                chunks.append((label, k, (q_g * w).sum(0) / torch.clamp(w.sum(), min=1.0)))
        means = torch.stack([c for _, _, c in chunks]).cpu().numpy().astype(np.float64)
        acc = np.zeros((self.label_num, self.cfg.emb_dim), np.float64)
        tot = np.zeros(self.label_num, np.float64)
        for (label, k, _), c in zip(chunks, means):
            acc[label] += c * k
            tot[label] += k
        centroid = (acc / np.maximum(tot, 1.0)[:, None]).astype(np.float32)
        self.centroid_matrix = torch.as_tensor(centroid, device=self.device)
        return self.centroid_matrix

    # -- adversarial training (zsl_module.py:350-633) ------------------------

    def _padded_gan_batch(self):
        cfg = self.cfg
        Q = cfg.gan_batch_rela * cfg.G_batch_size
        rel_ids, query, q_l, q_r, false, f_l, f_r, labels = \
            self.episodes.gan_batch(cfg.G_batch_size, cfg.gan_batch_rela, self.r2id)

        def pad(a, cols=None):
            shape = (Q,) if cols is None else (Q, cols)
            a = np.asarray(a, np.int64).reshape((-1,) if cols is None else (-1, cols))
            if len(a) >= Q:
                return a[:Q]
            if len(a) == 0:
                return np.zeros(shape, np.int64)
            return np.concatenate([a, np.repeat(a[-1:], Q - len(a), axis=0)])

        mask = np.zeros(Q, bool)
        mask[:min(len(labels), Q)] = True
        return (pad(rel_ids), pad(query, 2), pad(q_l), pad(q_r), pad(false, 2),
                pad(f_l), pad(f_r), pad(labels), mask)

    def d_step(self, fusion_trainer, batch, draws: dict | None = None,
               mesh: pmesh.Mesh | None = None) -> dict:
        """One critic step (zsl/module.py:186-236, :422-435). ``draws`` may
        give ``noise`` [B, noise_dim], ``alpha`` [B, 1] and ``dropout`` (the
        20 masks of the real and the negative Extractor passes), each for
        the whole batch. With ``mesh`` the batch's rows are split over
        ``data``. Returns ``info`` (global values) as 0-d device tensors."""
        cfg = self.cfg
        B = len(batch[1])
        rows, batch = self._gan_rows(batch, mesh)
        rel_ids, query, q_l, q_r, false, f_l, f_r, labels, mask = batch
        noise = self._draw(draws, "noise", (B, cfg.noise_dim), rows=rows)
        with torch.no_grad():
            fake = fusion_trainer.generate(rel_ids, noise)
            drop = self._dropout(draws, rows)
            query, false = self._put(query), self._put(false)
            q_meta, f_meta = self._meta(q_l, q_r), self._meta(f_l, f_r)
            real, _ = self.extractor(self.symbol_table, query, query, q_meta, q_meta,
                                     False, drop)
            neg, _ = self.extractor(self.symbol_table, false, false, f_meta, f_meta,
                                    False, drop)
            drop.check_all_used()
        alpha = self._draw(draws, "alpha", (B, 1), torch.rand, rows=rows)
        w, wsum = self._weights(mask, rows)
        idx = torch.arange(len(query), device=self.device)
        labels = self._put(labels)
        D, centroid = self.discriminator, self.centroid_matrix

        # the real pass steps u/v; every later pass uses the stepped buffers
        _, real_logit, real_cls = D(real, centroid, update_sn=True)
        _, fake_logit, fake_cls = D(fake, centroid)
        _, _, neg_cls = D(neg, centroid)
        loss_real = -(real_logit[:, 0] * w).sum() / wsum
        loss_fake = (fake_logit[:, 0] * w).sum() / wsum
        real_s, fake_s, neg_s = (c[idx, labels] for c in (real_cls, fake_cls, neg_cls))
        loss_real_cls = (F.relu(cfg.pretrain_margin - (real_s - neg_s)) * w).sum() / wsum
        loss_fake_cls = (F.relu(cfg.pretrain_margin - (fake_s - neg_s)) * w).sum() / wsum

        # WGAN-GP (module/utils.py:692-707): the critic's input gradient on
        # interpolates, kept in the graph for the parameter gradient
        inter = (alpha * real + (1 - alpha) * fake).requires_grad_()
        _, inter_logit, _ = D(inter, centroid)
        grad_inter, = torch.autograd.grad(inter_logit.sum(), inter, create_graph=True)
        gp = (((torch.linalg.norm(grad_inter, dim=1) - 1.0) ** 2) * w).sum() / wsum
        gp = gp * cfg.gp_lambda

        total = loss_real + loss_fake + 0.5 * loss_real_cls + 0.5 * loss_fake_cls + gp
        for group in self.opt_D.param_groups:
            group["lr"] = self.d_schedule(self.d_steps)
        self.opt_D.zero_grad(set_to_none=True)
        total.backward(inputs=list(D.parameters()))
        if rows is not None:
            pmesh.allreduce_grads(D.parameters(), rows.group)
        self.opt_D.step()
        self.d_steps += 1
        info = dict(loss_D=total, D_real=loss_real, D_fake=loss_fake,
                    D_real_class=loss_real_cls, D_fake_class=loss_fake_cls, gp=gp)
        return _global_info(info, rows)

    def reset_g_optimizer(self, fusion_trainer):
        """A fresh adam over the generator head of ``fusion_trainer``'s
        model (``G_PARAM_KEYS``), as each JAX ``train_gan`` makes one."""
        model = fusion_trainer.model
        self.g_params = [p for k in G_PARAM_KEYS for p in getattr(model, k).parameters()]
        self.opt_G = torch.optim.Adam(self.g_params, lr=self.g_schedule(0),
                                      betas=(0.5, 0.9), eps=1e-8)
        self.g_steps = 0

    def g_step(self, fusion_trainer, batch, draws: dict | None = None,
               mesh: pmesh.Mesh | None = None) -> dict:
        """One generator step (zsl/module.py:437-521) on the head that
        ``reset_g_optimizer`` took. ``draws`` may give ``noise`` and
        ``dropout`` (the 10 masks of the negative Extractor pass). The
        description encoding builds no graph; the power step runs on the
        head's three SN layers. With ``mesh`` the batch's rows are split
        over ``data`` (the description pass encodes the rank's rows only).
        Returns ``info`` (global values) as 0-d device tensors."""
        if self.opt_G is None:
            raise RuntimeError("g_step: call reset_g_optimizer(fusion_trainer) first")
        cfg = self.cfg
        B = len(batch[1])
        rows, batch = self._gan_rows(batch, mesh)
        rel_ids, query, q_l, q_r, false, f_l, f_r, labels, mask = batch
        noise = self._draw(draws, "noise", (B, cfg.noise_dim), rows=rows)
        D, centroid = self.discriminator, self.centroid_matrix
        with torch.no_grad():
            drop = self._dropout(draws, rows)
            false = self._put(false)
            f_meta = self._meta(f_l, f_r)
            neg, _ = self.extractor(self.symbol_table, false, false, f_meta, f_meta,
                                    False, drop)
            drop.check_all_used()
            _, _, neg_cls = D(neg, centroid)
        w, wsum = self._weights(mask, rows)
        idx = torch.arange(len(query), device=self.device)
        labels = self._put(labels)

        sample = fusion_trainer.generate(rel_ids, noise, update_sn=True)
        _, g_logit, g_cls = D(sample, centroid)
        loss_fake = -(g_logit[:, 0] * w).sum() / wsum
        loss_cls = (F.relu(cfg.pretrain_margin - (g_cls[idx, labels] - neg_cls[idx, labels]))
                    * w).sum() / wsum

        # visual pivot: per-label mean of the generated samples vs the centroid
        L = self.label_num
        seg = torch.where(self._put(mask, torch.bool), labels, L)
        sums = segment_sum(sample * w[:, None], seg, L + 1)
        cnts = segment_sum(w, seg, L + 1)
        if rows is not None:
            sums = pmesh.all_reduce_sum(sums, rows.group)
            cnts = pmesh.all_reduce_sum(cnts, rows.group)
        means = sums[:L] / torch.clamp(cnts[:L, None], min=1.0)
        dist = torch.sqrt(torch.clamp(((means - centroid) ** 2).sum(1), min=1e-12))
        loss_vp = torch.where(cnts[:L] > 0, dist, torch.zeros_like(dist)).sum()
        loss_vp = loss_vp / cfg.gan_batch_rela

        # the pivot term is computed alike on every rank: each takes a
        # 1/n_data share, and the summed gradients give the global one
        n_data = 1 if rows is None else mesh.n_data
        total = loss_fake + loss_cls + cfg.vp_weight * loss_vp / n_data
        grads = torch.autograd.grad(total, self.g_params)
        for p, g in zip(self.g_params, grads):
            p.grad = g
        if rows is not None:
            pmesh.allreduce_grads(self.g_params, rows.group)
        for group in self.opt_G.param_groups:
            group["lr"] = self.g_schedule(self.g_steps)
        self.opt_G.step()
        self.opt_G.zero_grad(set_to_none=True)
        self.g_steps += 1
        info = dict(loss_G=total, G_fake=loss_fake, G_class=loss_cls,
                    G_VP=loss_vp / n_data)
        return _global_info(info, rows)

    def train_gan(self, fusion_trainer, train_times: int | None = None,
                  log_every: int | None = None, pretrain_steps: int | None = None,
                  skip_pretrain: bool = False, skip_centroids: bool = False, draws=None,
                  mesh: pmesh.Mesh | None = None):
        """Pretrain the Extractor, compute the centroids, then alternate D
        and G steps; the generator head is trained in place in the fusion
        model. ``skip_centroids`` keeps the centroids of the last
        ``compute_centroids`` call (so the loop can be timed alone). ``draws``, if given, yields each step's draws in step order
        (D steps, then G steps, per epoch). With ``mesh`` the D and G
        steps split each GAN batch over ``data`` (pretraining and the
        centroids run alike on every rank). Returns (D history, G history),
        lists of dicts of floats; the histories stay on the device until a
        log window or the end."""
        cfg = self.cfg
        train_times = train_times or cfg.train_times
        log_every = log_every or cfg.loss_every
        if not skip_pretrain:
            self.pretrain_extractor(steps=pretrain_steps)
        if not skip_centroids:
            self.compute_centroids()
        self.reset_g_optimizer(fusion_trainer)
        draws = None if draws is None else iter(draws)

        d_hist, g_hist = [], []
        for epoch in range(train_times):
            for _ in range(cfg.D_epoch):
                batch = self._padded_gan_batch()
                d_hist.append(self.d_step(fusion_trainer, batch,
                                          None if draws is None else next(draws), mesh))
            for _ in range(cfg.G_epoch):
                batch = self._padded_gan_batch()
                g_hist.append(self.g_step(fusion_trainer, batch,
                                          None if draws is None else next(draws), mesh))
            if log_every and (epoch + 1) % log_every == 0:
                dw = torch.stack([h["loss_D"] for h in d_hist[-log_every:]]).mean().item()
                gw = torch.stack([h["loss_G"] for h in g_hist[-log_every:]]).mean().item()
                print(f"Epoch: {epoch + 1}, D_loss: {dw:.2f}, G_loss: {gw:.2f}")
        return _history(d_hist), _history(g_hist)

    # -- analysis helper (zsl_module.py:757-790) ------------------------------

    @torch.no_grad()
    def generate_entity_pair_emb(self, relations):
        """Per-relation Extractor embeddings of each test triple's entity
        pair: (list of [n_i, D] arrays, flat relation labels, []).

        Reference quirk kept: the right meta uses the HEAD too
        (zsl_module.py:776-777), so the neighbor meta is head-sided twice."""
        s2 = self.symbols.symbol2id
        out_embs, out_rels = [], []
        for rel in relations:
            triples = self.test_tasks.get(rel, [])
            if not triples:
                continue
            pairs = self._put([[s2[t[0]], s2[t[2]]] for t in triples])
            heads = [self.e2id[t[0]] for t in triples]
            meta = self._meta(heads, heads)
            emb, _ = self.extractor(self.symbol_table, pairs, pairs, meta, meta, True)
            out_embs.append(_host(emb))
            out_rels += [rel] * len(triples)
        return out_embs, out_rels, []

    # -- persistence (zsl_module.py:205-207, 751-755) -------------------------

    def save(self, save_path: str, fusion_trainer=None):
        """Write Extractor, Discriminator (``{"params", "spectral"}``) and,
        given the fusion trainer, Generator (its parameters, the generator
        head included) under ``save_path``, as the reference's Embed_used."""
        ckpt.save_checkpoint(f"{save_path}/Extractor", module_to_flax(self.extractor)[0])
        d_params, d_spectral = module_to_flax(self.discriminator)
        ckpt.save_checkpoint(f"{save_path}/Discriminator",
                             {"params": d_params, "spectral": d_spectral})
        if fusion_trainer is not None:
            ckpt.save_checkpoint(f"{save_path}/Generator", fusion_trainer.params_tree())

    def load(self, save_path: str, fusion_trainer=None):
        ex = ckpt.load_checkpoint(f"{save_path}/Extractor", module_to_flax(self.extractor)[0])
        load_flax(self.extractor, ex)
        d_params, d_spectral = module_to_flax(self.discriminator)
        d = ckpt.load_checkpoint(f"{save_path}/Discriminator",
                                 {"params": d_params, "spectral": d_spectral})
        load_flax(self.discriminator, d["params"], d["spectral"])
        gen_path = f"{save_path}/Generator"
        if fusion_trainer is not None and os.path.exists(gen_path):
            fusion_trainer.load_params(ckpt.load_checkpoint(gen_path,
                                                            fusion_trainer.params_tree()))

    # -- evaluation (zsl_module.py:635-745) ----------------------------------

    def _entity_symbols(self) -> torch.Tensor:
        ent_sym = np.full(self.connections.shape[0], self.symbols.pad_id, np.int64)
        for name in self.symbols.ent_names:
            ent_sym[self.e2id[name]] = self.symbols.symbol2id[name]
        return torch.as_tensor(ent_sym, device=self.device)

    @torch.no_grad()
    def evaluate(self, fusion_trainer, mode: str = "test", verbose: bool = True,
                 query_chunk: int = 64, predict_unseen=None,
                 compute_dtype: str = "float32", eval_path: str = "head_shared",
                 return_ranks: bool = False, mesh=None) -> dict:
        """Zero-shot ranking of the ``mode`` candidates on ``eval_path``:
        'rel_shared' (one shared candidate list per relation), 'head_shared'
        (one head gather per query) or 'factored' (per-pair gathers). All
        three give the same ranks up to float32 summation order.
        ``predict_unseen(rel_ids) → [len(rel_ids), D]`` (the distill
        predictor), if given, supplies each relation's vectors: one row
        where the generator gives ``test_sample``.

        ``compute_dtype="bfloat16"`` (zsl/module.py:629-650): the L/R tables
        are computed in float32 and cast, every Extractor parameter is cast
        (the LayerNorm's too) and the pair embeddings go back to float32
        before ranking, on all three paths. The generator's text pass runs
        in the fusion model's own dtype.

        ``mesh`` (``rel_shared`` only, as in JAX) ranks the query chunks
        data parallel over the mesh's ``data`` axis: identical ranks."""
        if eval_path not in EVAL_PATHS:
            raise ValueError(f"eval_path {eval_path!r} not in {EVAL_PATHS}")
        if mesh is not None and eval_path != "rel_shared":
            raise ValueError("mesh-sharded evaluation is supported for "
                             "eval_path='rel_shared' only")
        if mesh is not None and not isinstance(mesh, pmesh.Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not {type(mesh).__name__}")
        cdt = torch_dtype(compute_dtype)
        test_candidates = loaders.load_candidates(self.data_path, mode)
        ex = self.extractor
        nbr = ex.encode_neighbors(self.symbol_table, self.connections, self.degrees)
        L, R = ex.precompute_pair_tables(self.symbol_table, nbr, self._entity_symbols())
        if cdt != torch.float32:
            L, R, ex = L.to(cdt), R.to(cdt), copy.deepcopy(ex).to(cdt)

        if predict_unseen is not None:
            def gen_rel_vecs(rel_name):
                return _host(predict_unseen([self.r2id[rel_name]]))
        else:
            def gen_rel_vecs(rel_name):
                rel_ids = np.full(self.cfg.test_sample, self.r2id[rel_name])
                return _host(fusion_trainer.generate(rel_ids, self.test_noises))

        if eval_path == "rel_shared":
            return evaluate_zero_shot_rel_shared(
                test_candidates, self.e2id,
                lambda heads, shared: ex.embed_pairs_rel_shared(L, R, heads, shared),
                lambda heads, trues: ex.embed_pairs_factored(L, R, heads, trues),
                gen_rel_vecs, query_chunk=query_chunk, verbose=verbose,
                return_ranks=return_ranks, device=self.device, mesh=mesh)
        block = None
        if eval_path == "head_shared":
            def block(heads, cands):
                return ex.embed_pairs_head_shared(L, R, heads, cands)
        return evaluate_zero_shot(
            test_candidates, self.symbols.symbol2id, self.e2id, self.r2id,
            lambda pairs, left, right: ex.embed_pairs_factored(L, R, left, right),
            gen_rel_vecs, query_chunk=query_chunk, verbose=verbose,
            embed_query_block=block, return_ranks=return_ranks, device=self.device)
