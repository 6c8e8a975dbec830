"""Joint fusion training (port of mre_tpu/train/fusion.py).

One training step (``_build_step``, fusion.py:168-261):

  M3AE representation → RGCN over the sampled subgraph → relation-
  description encoding with the spectral-norm power step → masked encoder
  → decoder → subgraph-local filtered negative sampling → TransE margin
  loss + masked image MSE + masked text CE + contrastive → adam on a
  cosine-warm-restart schedule.

Host work per step: neighbor-sampled indices, image decode and crop
(``data/graph_sampler.py``, ``data/multimodal.py``), patch extraction; text
is pre-tokenized. ``train_epoch`` assembles batches in a producer thread so
that host work overlaps the device step.

The step's random parts (the two masking permutations and the negative
draws) come from one ``torch.Generator`` seeded from ``cfg.seed``; a caller
may pass them instead (``train_step(graph_batch, draws=...)``), which is
how the tests feed the JAX step's draws in.

Faithfulness notes kept from the JAX package: the reference trains on the
un-regularized gcn loss and only logs ``struct_loss`` (``regul_in_loss``
repairs it); padded rows (the sampler repeats a real node) stay out of
every loss mean through ``node_mask`` and ``edge_mask``.

Serving (module/utils.py:479-546): ``generate_ent_embeddings`` (an M3AE cls
pass over every entity in chunks, then one full-graph RGCN sweep),
``generate_rel_embeddings`` and ``generate`` (the generator head). The
distill predictor (``train_distill``, ``generate_rel_embeddings_unseen``)
maps relation descriptions to relation embeddings through a small MLP over
the frozen text embeddings (models/distill.py).

Data parallel (``mesh=``, a ``parallel.mesh.Mesh``; the JAX
``_shard_batch`` rules, fusion.py:288-309): every rank holds the same full
device batch and the same draws (the identically seeded generator), runs
the M3AE passes on its own node rows (and the description pass on its own
edge rows), and gathers the cls and mean-token reps into the full node
table; the RGCN, the TransE margin, the regulariser and the contrastive
loss run replicated. The row-mean losses (patch MSE, token CE) become this
rank's sum over the global row count, the replicated terms are scaled by
``1 / n_data`` (the gather's backward sums every rank's copy), and the
gradients are SUMmed over the data group before every rank steps adam. A
row count that the data axis does not divide runs replicated, as in JAX.
``generate_ent_embeddings(mesh=)`` splits each entity batch over ``data``
and the FFNs over ``model`` (tensor parallel), gathers the reps in entity
order and runs the RGCN sweep replicated.

Weights are the seeded port init, or carried from the JAX package with
``interop.load_flax(trainer.model, params, spectral)``. An LFM2 model type
(``core/config.py``'s ``ENCODER_PRESETS``) is built on the trainer's device,
so its encoder draws its weights there (``models/lfm2.py``), and serves
only: its training steps raise. ``FusionConfig.encoder`` overrides the
encoder preset's keys (a cut LFM2 ``layer_types`` and ``num_dense_layers``).
``compute_dtype="bfloat16"`` runs the M3AE transformers' Dense layers and
the attention kernel in bfloat16 over float32 parameters; parameters, adam
state and checkpoints stay float32. ``image_cache`` decodes every entity
image once at construction (``MultimodalStore.precompute_image_cache``).
``train_state`` / ``load_train_state`` carry everything a step reads
(parameters, spectral vectors, adam, the generator, the step count), for a
resume that continues bit for bit.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import math
import queue
import threading

import numpy as np
import torch

from mre_tpu_torch.core.config import transformer_preset
from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.core.profiling import count, span, spanned
from mre_tpu_torch.data.graph_sampler import NeighborSampler, edges_from_tasks
from mre_tpu_torch.data.kg import DeviceKG, TripleTable
from mre_tpu_torch.data.multimodal import MultimodalStore
from mre_tpu_torch.interop import load_flax, module_to_flax
from mre_tpu_torch.models.initializers import init_weights
from mre_tpu_torch.models.unified import UnifiedModel, unified_config
from mre_tpu_torch.ops import losses as L
from mre_tpu_torch.ops import sampling
from mre_tpu_torch.ops.patches import extract_patches
from mre_tpu_torch.ops.segment import gather_rows
from mre_tpu_torch.parallel import mesh as pmesh

INFO_KEYS = ("loss", "gcn_loss", "struct_loss", "image_loss", "text_loss",
             "contrastive_loss", "text_accuracy", "neg_fail_frac")


def _check_mesh(mesh):
    if mesh is not None and not isinstance(mesh, pmesh.Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, not {type(mesh).__name__}")
    return mesh


def cosine_warm_restarts(lr_max: float, lr_min: float, t0: int, t_mult: int = 2,
                         total_steps: int = 1_000_000):
    """Step → learning rate of torch CosineAnnealingWarmRestarts
    (main.py:105-110), equal step for step to the JAX package's optax
    ``join_schedules`` of ``cosine_decay_schedule`` periods t0, t0·t_mult, …
    (the last period holds its floor past its end)."""
    periods, boundaries = [], []
    t, start = t0, 0
    while start < total_steps:
        periods.append(max(t, 1))
        start += t
        boundaries.append(start)
        t *= t_mult
    boundaries = boundaries[:-1]
    alpha = lr_min / max(lr_max, 1e-12)

    def schedule(step: int) -> float:
        i = bisect.bisect_right(boundaries, step)
        count = min(step - (boundaries[i - 1] if i else 0), periods[i])
        cosine = 0.5 * (1 + math.cos(math.pi * count / periods[i]))
        return lr_max * ((1 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass
class FusionConfig:
    model_type: str = "small"
    emb_dim: int = 200
    noise_dim: int = 15
    patch_size: int = 16
    image_mask_ratio: float = 0.75
    text_mask_ratio: float = 0.75
    batch_size: int = 12          # seed nodes per step
    sample_size: int = 4          # sampled incident edges per seed
    neg_ent: int = 10
    margin: float = 3.0
    regul_rate: float = 0.5
    regul_in_loss: bool = False
    image_loss_weight: float = 0.7
    text_loss_weight: float = 0.5
    gcn_loss_weight: float = 0.7
    contrastive_loss_weight: float = 0.5
    image_all_token_loss: bool = False
    text_all_token_loss: bool = False
    lr_maximum: float = 1e-4
    lr_minimum: float = 0.0
    lr_warmup_epochs: int = 5
    # enters the warm-restart period like the reference (main.py:107:
    # T_0 = lr_warmup_epochs * steps_per_epoch // accumulate_grad_steps)
    accumulate_grad_steps: int = 1
    epochs: int = 200
    seed: int = 192
    text_only: bool = False
    compute_dtype: str = "float32"   # the M3AE transformers' dtype ("bfloat16")
    image_cache: bool = False        # pre-decode every image once
    attention_impl: str = "auto"     # auto | kernel | torch
    encoder: dict | None = None      # encoder preset overrides (models/unified.py)


class FusionTrainer:
    def __init__(self, table: TripleTable, store: MultimodalStore,
                 cfg: FusionConfig, device: str | torch.device | None = None,
                 mesh: pmesh.Mesh | None = None):
        """``device`` defaults to the mesh's (``cuda`` without one)."""
        self.mesh = _check_mesh(mesh)
        self.device = resolve_device(mesh.device if device is None and mesh else device)
        self.table = table
        self.store = store
        self.cfg = cfg
        if cfg.image_cache and not cfg.text_only:
            secs = store.precompute_image_cache()
            print(f"[fusion] image cache: {store.num_nodes} entities "
                  f"pre-decoded in {secs:.1f}s", flush=True)
        self.serving_only = transformer_preset(cfg.model_type).get("encoder") == "lfm2"
        with torch.device(self.device) if self.serving_only else contextlib.nullcontext():
            model = UnifiedModel(
                text_vocab_size=store.vocab_size,
                num_relations=table.n_relations,
                config=unified_config(cfg.model_type, dict(
                    emb_dim=cfg.emb_dim, noise_dim=cfg.noise_dim,
                    patch_size=cfg.patch_size,
                    image_mask_ratio=cfg.image_mask_ratio,
                    text_mask_ratio=cfg.text_mask_ratio,
                    contrastive=cfg.contrastive_loss_weight > 0 and not cfg.text_only,
                    compute_dtype=cfg.compute_dtype, attention_impl=cfg.attention_impl,
                    encoder=cfg.encoder)))
        self.model = init_weights(model, cfg.seed).to(self.device).eval()
        self.kg = DeviceKG.from_table(table, self.device)

        edge_index, edge_type = edges_from_tasks(table.triples)
        self.sampler = NeighborSampler(edge_index, edge_type, table.n_entities,
                                       size=cfg.sample_size, batch_size=cfg.batch_size,
                                       seed=cfg.seed)
        self.steps_per_epoch = len(self.sampler)
        self.schedule = cosine_warm_restarts(
            cfg.lr_maximum, cfg.lr_minimum,
            t0=max(cfg.lr_warmup_epochs * self.steps_per_epoch
                   // max(cfg.accumulate_grad_steps, 1), 1),
            total_steps=cfg.epochs * self.steps_per_epoch + 1)
        # optax.adam's defaults; the rate is set from the schedule each step
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.schedule(0),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.steps = 0
        self._gen = torch.Generator().manual_seed(cfg.seed)

    def _put(self, a, dtype=None):
        a = np.asarray(a)
        count("h2d.bytes", a.nbytes)
        with span("fusion.put"):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

    # -- training ------------------------------------------------------------

    @spanned("fusion.prepare_batch")
    def prepare_device_batch(self, graph_batch: dict) -> dict:
        """The device batch of a sampled subgraph: training images (decoded,
        cropped, flipped) as patches, pre-tokenized text and descriptions."""
        n_id = graph_batch["n_id"]
        mm = self.store.generate_batch(n_id, graph_batch["edge_type"], train=True)
        batch = {k: self._put(graph_batch[k]) for k in
                 ("n_id", "node_mask", "edge_index", "edge_type", "edge_mask")}
        for k in ("text", "text_padding_mask", "rel_des", "rel_des_padding_mask"):
            batch[k] = self._put(mm[k])
        if "image" in mm:
            batch["image_patches"] = self._put(extract_patches(mm["image"], self.cfg.patch_size))
        return batch

    def draw(self, batch: dict) -> dict:
        """The step's random parts from the trainer's generator: the image
        and text masking permutations, then the negatives."""
        gen = self._gen
        draws = {}
        if "image_patches" in batch:
            draws["image_ids_shuffle"] = torch.randperm(batch["image_patches"].shape[1],
                                                        generator=gen)
        draws["text_ids_shuffle"] = torch.randperm(batch["text"].shape[1], generator=gen)
        edge_index = batch["edge_index"]
        draws["neg_h"], draws["neg_t"], draws["neg_failed"] = sampling.corrupt_within_nodes(
            self.kg, batch["n_id"], edge_index[0], batch["edge_type"], edge_index[1],
            self.cfg.neg_ent, generator=gen)
        return draws

    def loss(self, batch: dict, draws: dict):
        """(total loss, info) of one step: every term of the JAX
        ``loss_fn`` (fusion.py:173-250). Steps the spectral norms."""
        cfg = self.cfg
        keys = ("text", "text_padding_mask", "rel_des", "rel_des_padding_mask", "image_patches")
        model_batch = {k: batch[k] for k in keys if k in batch}
        edge_index, edge_mask, node_mask = (batch["edge_index"], batch["edge_mask"],
                                            batch["node_mask"])
        node_shard, edge_shard = self._shards(node_mask.shape[0], edge_mask.shape[0])
        x_gcn, rel_emb, out = self.model.forward_train(
            edge_index, batch["edge_type"], model_batch,
            draws.get("image_ids_shuffle"), draws["text_ids_shuffle"],
            edge_mask=edge_mask, update_sn=True, node_mask=node_mask,
            node_shard=node_shard, edge_shard=edge_shard)

        h_l, t_l = edge_index[0].long(), edge_index[1].long()
        neg_h, neg_t = draws["neg_h"].long(), draws["neg_t"].long()

        def transe(hh, rr, tt):
            return (hh + rr - tt).abs().sum(dim=-1)

        x_h, x_t = gather_rows(x_gcn, h_l), gather_rows(x_gcn, t_l)
        pos = transe(x_h, rel_emb, x_t)                                     # [E]
        neg = transe(gather_rows(x_gcn, neg_h), rel_emb[:, None, :],
                     gather_rows(x_gcn, neg_t))                             # [E, n_neg]
        diff = torch.clamp(pos[:, None] - neg, min=-cfg.margin)
        w = edge_mask.to(torch.float32)
        n_pairs = torch.clamp(w.sum() * cfg.neg_ent, min=1.0)
        gcn_loss = (diff * w[:, None]).sum() / n_pairs + cfg.margin

        nm = node_mask.to(torch.float32)

        def wmean_sq(x, mask_w):
            return (((x * x).sum(dim=-1) * mask_w).sum()
                    / torch.clamp(mask_w.sum() * x.shape[-1], min=1.0))

        regul = (wmean_sq(x_h, w) + wmean_sq(x_t, w)
                 + wmean_sq(rel_emb, w)) / 3
        struct_loss = gcn_loss + cfg.regul_rate * regul

        # the M3AE outputs are this rank's node rows under a node shard
        local = (lambda x: x) if node_shard is None else node_shard.local
        nm_l = local(nm)
        image = model_batch.get("image_patches")
        if image is not None:
            img_valid = (nm_l[:, None].expand_as(out["image_mask"])
                         if cfg.image_all_token_loss else out["image_mask"] * nm_l[:, None])
            image_loss = L.patch_mse_loss(out["image_output"], local(image), img_valid)
        else:
            image_loss = torch.zeros((), device=x_gcn.device)
        text_mask = out["text_mask"]
        text_valid = L.mask_intersection(
            torch.ones_like(text_mask) if cfg.text_all_token_loss else text_mask,
            L.mask_not(local(model_batch["text_padding_mask"]))) * nm_l[:, None]
        text_loss, text_acc = L.cross_entropy_loss_and_accuracy(
            out["text_output"], local(model_batch["text"]), text_valid)

        struct_term = struct_loss if cfg.regul_in_loss else gcn_loss
        if self.mesh is None:
            total = (cfg.image_loss_weight * image_loss
                     + cfg.text_loss_weight * text_loss
                     + cfg.gcn_loss_weight * struct_term
                     + cfg.contrastive_loss_weight * out["contrastive_loss"])
            loss = total.detach()
        else:
            share, rep_share = self._shares(node_shard)
            rest = (cfg.gcn_loss_weight * struct_term
                    + cfg.contrastive_loss_weight * out["contrastive_loss"])
            total = ((cfg.image_loss_weight * image_loss + cfg.text_loss_weight * text_loss)
                     * share + rest * rep_share)
            if node_shard is not None:
                image_loss, text_loss, text_acc = pmesh.all_reduce_sum(
                    torch.stack([image_loss, text_loss, text_acc]).detach() * share,
                    node_shard.group).unbind()
            loss = (cfg.image_loss_weight * image_loss + cfg.text_loss_weight * text_loss
                    + rest.detach())
        # real edges whose rejection rounds all hit true triples (their
        # negatives equal the positive): observable, not silent
        neg_fail_frac = (draws["neg_failed"].to(torch.float32) * w[:, None]).sum() / n_pairs
        info = dict(loss=loss, gcn_loss=gcn_loss, struct_loss=struct_loss,
                    image_loss=image_loss, text_loss=text_loss,
                    contrastive_loss=out["contrastive_loss"], text_accuracy=text_acc,
                    neg_fail_frac=neg_fail_frac)
        return total, {k: v.detach() for k, v in info.items()}

    def _shares(self, node_shard) -> tuple[float, float]:
        """(weight of this rank's row-mean losses, weight of the terms every
        rank computes alike) in a data-parallel step: the row means become
        the rank's share of the global mean, the replicated terms a
        1/n_data share (the gather's backward sums every rank's copy), so
        the ranks' gradients SUM to the global one."""
        n_data = self.mesh.n_data
        if node_shard is None:
            return 1.0 / n_data, 1.0 / n_data
        return node_shard.n_local / node_shard.n, 1.0 / n_data

    def _shards(self, n_nodes: int, n_edges: int):
        """(node, edge) ``RowShard``s of a data-parallel step: an axis the
        data ranks do not divide runs replicated (None), as JAX replicates
        it (fusion.py:303-309)."""
        if self.mesh is None or self.mesh.n_data == 1:
            return None, None
        n = self.mesh.n_data
        return tuple(pmesh.row_shard(self.mesh, k) if k % n == 0 else None
                     for k in (n_nodes, n_edges))

    def _check_trainable(self):
        if self.serving_only:
            raise NotImplementedError(f"model type {self.cfg.model_type!r}: training the "
                                      "LFM2 encoder is not supported (it serves only)")

    @spanned("fusion.step")
    def step(self, batch: dict, draws: dict | None = None) -> dict:
        """One optimizer step on a device batch; returns ``info`` as 0-d
        tensors on the device (no host sync)."""
        self._check_trainable()
        if draws is None:
            with span("fusion.draw"):
                draws = self.draw(batch)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.steps)
        self.optimizer.zero_grad(set_to_none=True)
        with span("fusion.loss"):
            total, info = self.loss(batch, draws)
        with span("fusion.backward"):
            total.backward()
            if self.mesh is not None:
                pmesh.allreduce_grads(self.model.parameters(), self.mesh.data_group)
        with span("fusion.adam"):
            self.optimizer.step()
        self.steps += 1
        return info

    def train_step(self, graph_batch: dict, draws: dict | None = None) -> dict:
        info = self.step(self.prepare_device_batch(graph_batch), draws)
        return {k: float(v) for k, v in info.items()}

    def train_epoch(self, prefetch: int = 2, on_step=None) -> dict:
        """One epoch, batches assembled by a producer thread (image decode
        and host→device copies overlap the device step); returns the mean
        of each ``info`` term, or ``{}`` for an epoch with no batch.
        ``on_step``, if given, gets each step's ``info`` (0-d tensors on the
        device) as the step is queued."""
        self._check_trainable()
        q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        stop = object()
        halt = threading.Event()
        err: list = []

        def producer():
            # the stop sentinel goes in even when batch assembly raises, or
            # the consumer would wait in q.get() forever
            try:
                for graph_batch in self.sampler:
                    if halt.is_set():
                        break
                    q.put(self.prepare_device_batch(graph_batch))
            except BaseException as e:  # re-raised in the training thread
                err.append(e)
            finally:
                q.put(stop)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        agg, n = None, 0
        try:
            while True:
                with span("fusion.wait_batch"):
                    batch = q.get()
                if batch is stop:
                    break
                info = self.step(batch)
                if on_step is not None:
                    on_step(info)
                # summed on the device: one host sync per epoch, not per step
                agg = info if agg is None else {k: agg[k] + info[k] for k in agg}
                n += 1
        finally:
            halt.set()                    # a failed step stops the producer early
            while thread.is_alive():      # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
        if err:
            raise err[0]
        if agg is None:
            return {}
        return {k: float(v) / n for k, v in agg.items()}

    # -- checkpoints ---------------------------------------------------------

    def train_state(self) -> dict:
        """Everything a step reads that training changes, as a tree of CPU
        tensors for ``core/checkpoint.py``: the model's parameters and
        spectral vectors (``state_dict`` names), adam's state, the draws'
        generator and the step count."""
        opt = self.optimizer.state_dict()["state"]
        return {
            "model": {k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()},
            "adam": {str(i): {k: torch.as_tensor(v).detach().cpu().clone()
                              for k, v in st.items()} for i, st in opt.items()},
            "generator": self._gen.get_state(),
            "steps": torch.tensor(self.steps),
        }

    def load_train_state(self, tree: dict) -> None:
        """Restore a ``train_state`` tree (e.g. from ``load_checkpoint``);
        the next steps then continue the saved run bit for bit."""
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict({
            "state": {int(i): dict(st) for i, st in tree["adam"].items()},
            "param_groups": self.optimizer.state_dict()["param_groups"]})
        self._gen.set_state(tree["generator"])
        self.steps = int(tree["steps"])

    def params_tree(self) -> dict:
        """The parameters as the flax-named tree of the JAX trainer's
        ``params`` (numpy leaves; the spectral vectors are not in it)."""
        return module_to_flax(self.model)[0]

    def load_params(self, params: dict) -> None:
        """Load a flax-named parameter tree (a checkpoint's). The spectral
        vectors stay the running trainer's, as a JAX ``fusion.params = ...``
        leaves ``fusion.spectral``; adam's state is left alone."""
        load_flax(self.model, params, module_to_flax(self.model)[1])

    # -- serving -------------------------------------------------------------

    @staticmethod
    def _padded_ids(i: int, n: int, batch_size: int):
        ids = np.arange(i, min(i + batch_size, n))
        return ids, np.pad(ids, (0, batch_size - len(ids)), constant_values=ids[-1])

    @torch.no_grad()
    @spanned("fusion.ent_sweep")
    def generate_ent_embeddings(self, batch_size: int = 512,
                                mesh: pmesh.Mesh | None = None) -> torch.Tensor:
        """All-entity M3AE cls pass (chunked) + one full-graph RGCN sweep.

        With a mesh (``mesh`` or the trainer's), each padded batch is split
        over ``data`` (replicated when ``data`` does not divide it, as in
        JAX) and the FFNs are tensor parallel over ``model``
        (``parallel.mesh.shard_transformer_ffn``); the reps are gathered in
        entity order and every rank runs the RGCN sweep."""
        mesh = _check_mesh(mesh) or self.mesh
        m3ae = self.model.M3AEmodel
        shard = None
        if mesh is not None and mesh.n_data > 1 and batch_size % mesh.n_data == 0:
            shard = pmesh.row_shard(mesh, batch_size)
        n = self.table.n_entities
        reps = []
        with (pmesh.shard_transformer_ffn(m3ae, mesh) if mesh is not None
              else contextlib.nullcontext()):
            for i in range(0, n, batch_size):
                ids, ids_p = self._padded_ids(i, n, batch_size)
                mm = self.store.generate_batch(
                    ids_p if shard is None else shard.local(ids_p), [], train=False)
                patches = (self._put(extract_patches(mm["image"], self.cfg.patch_size))
                           if "image" in mm else None)
                text, text_mask = self._put(mm["text"]), self._put(mm["text_padding_mask"])
                with span("m3ae.cls_pass"):
                    cls_x, _ = m3ae.forward_representation(patches, text, text_mask)
                cls_x = cls_x[:, 0, :]
                reps.append((cls_x if shard is None else shard.gather(cls_x))[:len(ids)])
        edge_index, edge_type = edges_from_tasks(self.table.triples)
        edge_index = self._put(edge_index, torch.int64)
        edge_type = self._put(edge_type, torch.int64)
        with span("rgcn.sweep"):
            return self.model.gcn_forward_encoder(torch.cat(reps), edge_index, edge_type)

    @torch.no_grad()
    @spanned("fusion.rel_sweep")
    def generate_rel_embeddings(self, batch_size: int = 64) -> torch.Tensor:
        n = self.table.n_relations
        out = []
        for i in range(0, n, batch_size):
            ids, ids_p = self._padded_ids(i, n, batch_size)
            out.append(self.model.forward_relation_emb(
                self._put(self.store.rel_ids[ids_p]),
                self._put(self.store.rel_mask[ids_p]))[:len(ids)])
        return torch.cat(out)

    # -- the distill predictor (utils.py:529-546, rel_type='unseen';
    # module/DistillModel.py) -------------------------------------------------

    def train_distill(self, teacher_rel_embs, steps: int = 2000, lr: float = 1e-4,
                      batch_size: int = 32, seed: int = 0, init_params: dict | None = None):
        """Distill description → embedding into a small MLP over the frozen
        text embeddings; returns (predict_unseen, model). Batches are drawn
        as the JAX package draws them (``default_rng(seed).integers`` per
        step). ``init_params``, a flax-named tree, replaces the seeded init
        (how the tests carry JAX's in)."""
        from mre_tpu_torch.models.distill import embed_tokens, make_distill_trainer

        # every relation's token embeddings, once: predict_unseen indexes
        # them, so later training of the text embedding does not reach it
        token_embs = embed_tokens(self.model.M3AEmodel, self._put(self.store.rel_ids))
        if not isinstance(teacher_rel_embs, torch.Tensor):
            teacher_rel_embs = torch.from_numpy(np.array(teacher_rel_embs, np.float32))
        teacher = teacher_rel_embs.to(self.device, torch.float32)
        n = token_embs.shape[0]
        model, step, predict = make_distill_trainer(
            self.cfg.emb_dim, token_embs.shape[-1], lr=lr, seed=seed, device=self.device)
        if init_params is not None:
            load_flax(model, init_params)
        rng = np.random.default_rng(seed)
        # the draws of every step, copied to the device at once
        idx = self._put(np.reshape([rng.integers(0, n, batch_size) for _ in range(steps)],
                                   (steps, batch_size)), torch.int64)
        for i in range(steps):
            step(token_embs[idx[i]], teacher[idx[i]])

        def predict_unseen(rel_ids):
            return predict(token_embs[self._put(np.asarray(rel_ids), torch.int64)])

        return predict_unseen, model

    def generate_rel_embeddings_unseen(self, predict_unseen) -> torch.Tensor:
        """All-relation embeddings through the distilled predictor
        (generate_rel_embed(..., rel_type='unseen'))."""
        return predict_unseen(np.arange(self.table.n_relations))

    def generate(self, rel_ids: np.ndarray, noise: torch.Tensor,
                 update_sn: bool = False) -> torch.Tensor:
        """Generator head: relation descriptions ⊕ noise → embeddings. The
        head builds a graph unless the caller is under ``no_grad`` (the ZSL
        G step trains it); ``update_sn`` steps its three SN layers.

        The frozen text pass gives rows of one relation one vector, so it
        encodes each distinct id once (a GAN batch holds two relations over
        hundreds of rows, an evaluation one relation) and the head runs on
        every row."""
        rel_ids = np.asarray(rel_ids)
        with span("zsl.generate"):
            ids, inv = np.unique(rel_ids, return_inverse=True)
            if len(ids) == len(rel_ids):      # all distinct: one row each, as given
                ids = rel_ids
            count("zsl.generate.rows", len(rel_ids))
            count("zsl.generate.encoded", len(ids))
            tokens = self._put(self.store.rel_ids[ids])
            mask = self._put(self.store.rel_mask[ids])
            # one description needs no index: the model expands it to every row
            rows = self._put(inv.reshape(-1), torch.int64) if 1 < len(ids) < len(rel_ids) else None
            return self.model.generate(tokens, mask, noise.to(self.device),
                                       update_sn=update_sn, rows=rows)
