"""Structure-only KGE training (port of mre_tpu/train/kge.py): the OpenKE
Trainer with the sampler on the device.

One step draws uniform positives and their filtered Bernoulli corruptions
on the device (``ops/sampling.py``), scores them, takes the ranking loss
with optional self-adversarial weights and L2 / L3 regularisation, and
steps the optimizer: no host round trip. An epoch keeps its loss and the
sampler's truncation counter on the device and reads them once.

With a mesh (``mesh=``, a ``parallel.mesh.Mesh``; the JAX trainer's
batch constraint over ``data``, kge.py:146-163): every rank draws the same
batch from the identically seeded generator and scores its own rows over
``data``; the ranking loss becomes this rank's share of the batch mean,
the regularisers (computed alike on every rank over the whole batch or
table) a ``1 / n_data`` share, and the gradients are SUMmed over the data
group. With more than one ``model`` rank the entity tables (every key that
starts with ``ent``) are split by rows over ``model``: a lookup is a masked
local gather summed over the model group (vocab parallel), its gradient
lands in the owner's rows only, and the optimizer's state is per shard.
Filtered link prediction then scores each model rank's own entities and
sums the counts of candidates that beat the true entity's score
(``ops/ranking.py``), so the ranks are the replicated ones.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings

import numpy as np
import torch

from mre_tpu_torch.core import checkpoint as ckpt
from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.core.metrics import MetricLogger
from mre_tpu_torch.data.kg import DeviceKG, TripleTable
from mre_tpu_torch.models import kge as kge_models
from mre_tpu_torch.ops import losses as L
from mre_tpu_torch.ops import ranking, sampling
from mre_tpu_torch.parallel import mesh as pmesh


def make_optimizer(params, opt_method: str, lr: float, lr_decay: float = 0.0,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """The optimizer of an OpenKE recipe over ``params`` (the tensors to
    train; RotatE's constants are buffers, so never decayed).

    ``torch.optim.Adagrad(lr, lr_decay, eps=1e-10,
    initial_accumulator_value=0)`` is the semantics the JAX package's
    ``torch_adagrad`` was written to reproduce (the accumulator starts at 0,
    eps is added outside the square root, the step's rate is
    lr / (1 + (step − 1)·lr_decay)). The others are optax's: adam (0.9,
    0.999, eps 1e-8), adadelta (rho 0.9, eps 1e-6) and sgd, each with
    ``weight_decay`` added to the gradient first (``add_decayed_weights``)."""
    opt_method = opt_method.lower()
    params = list(params)
    if opt_method == "adagrad":
        return torch.optim.Adagrad(params, lr=lr, lr_decay=lr_decay, eps=1e-10,
                                   initial_accumulator_value=0.0,
                                   weight_decay=weight_decay)
    if lr_decay:
        # only torch.optim.Adagrad consumes lr_decay in the reference
        # (OpenKE config/Trainer.py): ignoring it would train another schedule
        raise ValueError(f"lr_decay is only supported for adagrad, not {opt_method}")
    if opt_method == "adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6,
                                    weight_decay=weight_decay)
    if opt_method == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    return torch.optim.SGD(params, lr=lr, weight_decay=weight_decay)


@dataclasses.dataclass
class KGETrainerConfig:
    model: str = "transe"
    dim: int = 200
    p_norm: int = 1
    norm_flag: bool = True
    margin: float = 5.0
    # OpenKE margin_flag (TransE.py:24-33): distance models train on
    # margin − distance ONLY when the recipe passed a margin to the MODEL
    # (e.g. train_transe_WN18_adv_sigmoidloss.py); opt-in, so a sigmoid /
    # softplus run without it trains on the raw distance
    margin_flag: bool = False
    loss: str = "margin"            # margin | sigmoid | softplus
    adv_temperature: float | None = None
    neg_ent: int = 25
    batch_size: int = 1024
    bern: bool = True
    opt_method: str = "sgd"
    alpha: float = 1.0              # learning rate (OpenKE naming)
    regul_rate: float = 0.0
    l3_regul_rate: float = 0.0
    train_times: int = 1000         # epochs
    nbatches: int = 100             # steps per epoch (OpenKE TrainDataLoader)
    seed: int = 0
    lr_decay: float = 0.0           # torch.optim.Adagrad lr_decay
    init_kwargs: dict = dataclasses.field(default_factory=dict)  # extra model.init kwargs


class KGETrainer:
    """End-to-end structure-only KGE trainer.

    The parameters are initialized on the CPU from ``config.seed`` (so a
    seed gives the same tables on every device) and trained on ``device``
    (``cuda`` when None); batches are drawn from a generator on that device
    seeded with ``config.seed + 1``."""

    def __init__(self, table: TripleTable, config: KGETrainerConfig,
                 mesh: pmesh.Mesh | None = None, device: str | torch.device | None = None):
        if mesh is not None and not isinstance(mesh, pmesh.Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not {type(mesh).__name__}")
        self.mesh = mesh
        self.device = resolve_device(mesh.device if device is None and mesh else device)
        self.table = table
        self.cfg = config
        self.model = kge_models.get(config.model)
        self.kg = DeviceKG.from_table(table, device=self.device)
        tree = self.model.init(torch.Generator().manual_seed(config.seed), table.n_entities,
                               table.n_relations, dim=config.dim, **config.init_kwargs)
        # this rank's rows of the entity tables over ``model`` (None: whole)
        self.ent_shard = (pmesh.table_shard(mesh, table.n_entities)
                          if mesh is not None and mesh.n_model > 1 else None)
        self.module = kge_models.Params(self._local(tree)).to(self.device)
        self.optimizer = make_optimizer(self.module.parameters(), config.opt_method,
                                        config.alpha, config.lr_decay)
        self.generator = torch.Generator(self.device).manual_seed(config.seed + 1)
        self._filter_cache = None

    @property
    def params(self) -> dict:
        """name → tensor (this rank's rows of the entity tables under a
        model axis)."""
        return self.module.tree()

    def _local(self, tree: dict) -> dict:
        """This rank's part of a whole parameter dict."""
        if self.ent_shard is None:
            return tree
        return {k: self.ent_shard.local(v) if kge_models.is_entity_table(k) else v
                for k, v in tree.items()}

    def sharded_params(self) -> dict:
        """``params`` with each split entity table as a
        ``parallel.mesh.ShardedTable``: indexed with global ids, as the
        models index a whole table."""
        if self.ent_shard is None:
            return self.params
        return {k: pmesh.ShardedTable(v, self.ent_shard) if kge_models.is_entity_table(k)
                else v for k, v in self.params.items()}

    def full_params(self) -> dict:
        """Every parameter whole (split tables gathered over ``model``)."""
        return {k: v.full() if isinstance(v, pmesh.ShardedTable) else v
                for k, v in self.sharded_params().items()}

    def load_params(self, tree: dict) -> None:
        """Copy a whole parameter dict (tensors or arrays under the model's
        keys) into the trainer, in place (this rank's rows of a split
        table)."""
        own = self.params
        if set(tree) != set(own):
            raise ValueError(f"parameter keys {sorted(tree)} vs the model's {sorted(own)}")
        tree = self._local({k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
                            for k, v in tree.items()})
        with torch.no_grad():
            for k, v in tree.items():
                own[k].copy_(v)

    def _score_kwargs(self) -> dict:
        cfg = self.cfg
        if cfg.model in kge_models.DISTANCE_MODELS:
            return {"p_norm": cfg.p_norm, "norm_flag": cfg.norm_flag}
        return {}

    def loss_value(self, params: dict, batch: sampling.NegativeBatch) -> torch.Tensor:
        """The training loss of ``batch`` under ``params``."""
        cfg = self.cfg
        value = self._ranking_loss(params, batch)
        if cfg.regul_rate:
            value = value + cfg.regul_rate * self._regularization(params, batch)
        if cfg.l3_regul_rate and cfg.model in ("distmult", "hole"):
            value = value + cfg.l3_regul_rate * kge_models.distmult_l3_regularization(params)
        return value

    def _ranking_loss(self, params: dict, batch: sampling.NegativeBatch) -> torch.Tensor:
        """The ranking loss alone: a mean over the batch's rows (plus a
        constant), whatever the loss and its adversarial weights."""
        cfg, model = self.cfg, self.model
        kw = self._score_kwargs()
        if model.score_pos_neg is not None:
            p, n = model.score_pos_neg(params, batch, **kw)
            p = p[:, None]
        else:
            p = model.score(params, batch.h, batch.r, batch.t, **kw)[:, None]
            n = model.score(params, batch.neg_h, batch.r[:, None].expand_as(batch.neg_h),
                            batch.neg_t, **kw)
        kwargs = {}
        if cfg.loss == "margin":
            kwargs["margin"] = cfg.margin
        if cfg.adv_temperature:
            kwargs["adv_temperature"] = cfg.adv_temperature
        loss_fn = L.LOSSES[cfg.loss]
        # MarginLoss in the reference receives (p, n) in forward orientation:
        # similarity models feed the negated scores to it; distance models
        # with margin_flag train sigmoid / softplus on margin − distance
        # (TransE.py:60-89), and predict still ranks by plain distance
        if model.higher_is_better and cfg.loss == "margin":
            return loss_fn(-p, -n, **kwargs)
        if not model.higher_is_better and cfg.margin_flag \
                and cfg.loss in ("sigmoid", "softplus"):
            return loss_fn(cfg.margin - p, cfg.margin - n, **kwargs)
        return loss_fn(p, n, **kwargs)

    def _regularization(self, params: dict, batch: sampling.NegativeBatch):
        all_h = torch.cat([batch.h[:, None], batch.neg_h], 1)
        all_t = torch.cat([batch.t[:, None], batch.neg_t], 1)
        all_r = batch.r[:, None].expand_as(all_h)
        return self.model.regularization(params, all_h, all_r, all_t)

    def _mesh_loss(self, batch: sampling.NegativeBatch):
        """(this rank's share of the step's loss, the global loss): the
        ranking loss of the rank's rows over ``data`` weighted by their
        share of the batch (it is a row mean), the regularisers over the
        whole batch and table weighted by ``1 / n_data`` (TransR squares its
        regulariser, so no row split would sum to it)."""
        cfg, mesh = self.cfg, self.mesh
        params = self.sharded_params()
        n = batch.h.shape[0]
        share = pmesh.row_shard(mesh, n).n_local / n
        value = self._ranking_loss(params, pmesh.shard_batch(mesh, batch, n)) * share
        extra = torch.zeros((), device=self.device)
        if cfg.regul_rate:
            extra = extra + cfg.regul_rate * self._regularization(params, batch)
        if cfg.l3_regul_rate and cfg.model in ("distmult", "hole"):
            extra = extra + cfg.l3_regul_rate * self._l3_split()
        value = value + extra / mesh.n_data
        return value, pmesh.all_reduce_sum(value.detach(), mesh.data_group)

    def _l3_split(self):
        """``distmult_l3_regularization`` with the entity table's rows split
        over ``model``: each rank's cube sum, summed over the group."""
        ent, rel = self.params["ent"], self.params["rel"]
        cubes = (ent.abs() ** 3).sum()
        if self.ent_shard is not None:
            cubes = pmesh.all_reduce_sum(cubes, self.ent_shard.group, replicated_grad=True)
        return cubes + (rel.abs() ** 3).sum()

    def step_with_batch(self, batch: sampling.NegativeBatch) -> torch.Tensor:
        """One optimizer step on a given batch (the whole batch, on every
        rank of a mesh); returns the loss (0-dim, on the device, detached;
        the global loss under a mesh)."""
        self.optimizer.zero_grad(set_to_none=True)
        if self.mesh is None:
            value = self.loss_value(self.params, batch)
            reported = value.detach()
        else:
            value, reported = self._mesh_loss(batch)
        value.backward()
        if self.mesh is not None:
            pmesh.allreduce_grads(self.module.parameters(), self.mesh.data_group)
        self.optimizer.step()
        return reported

    def sample(self) -> sampling.NegativeBatch:
        cfg = self.cfg
        return sampling.sample_training_batch(self.kg, cfg.batch_size, cfg.neg_ent, cfg.bern,
                                              generator=self.generator)

    def train_step(self) -> dict:
        """One step on a freshly drawn batch: {"loss", "overflow_truncated"}
        as 0-dim device tensors."""
        batch = self.sample()
        return {"loss": self.step_with_batch(batch),
                "overflow_truncated": batch.overflow_truncated}

    def train_epoch(self, n_steps: int | None = None) -> dict:
        """``n_steps`` (default ``nbatches``) steps; the summed loss and
        truncation count as 0-dim device tensors (nothing is read here)."""
        loss = trunc = None
        for _ in range(n_steps or self.cfg.nbatches):
            out = self.train_step()
            loss = out["loss"] if loss is None else loss + out["loss"]
            trunc = out["overflow_truncated"] if trunc is None else trunc + out["overflow_truncated"]
        return {"loss": loss, "overflow_truncated": trunc}

    def run(self, log_every: int = 50, logger: MetricLogger | None = None,
            save_steps: int | None = None, checkpoint_dir: str | None = None) -> float:
        """``train_times`` epochs; returns the last epoch's summed loss."""
        cfg = self.cfg
        last = 0.0
        for epoch in range(cfg.train_times):
            stats = self.train_epoch()
            last = float(stats["loss"])              # one read per epoch
            if logger and (epoch % log_every == 0 or epoch == cfg.train_times - 1):
                logger.log({"epoch": epoch, "loss": last,
                            "overflow_truncated": int(stats["overflow_truncated"])},
                           step=epoch)
            if save_steps and checkpoint_dir and (epoch + 1) % save_steps == 0:
                ckpt.save_checkpoint(f"{checkpoint_dir}/{cfg.model}-{epoch}.ckpt",
                                     self.full_params(), mesh=self.mesh)
        return last

    # -- evaluation ------------------------------------------------------

    def predictors(self, filt: DeviceKG):
        """(predict_all_tails, predict_all_heads) of the trained model."""
        model, kw = self.model, self._score_kwargs()
        if kw:
            model = dataclasses.replace(model, predict=functools.partial(model.predict, **kw))
            if self.cfg.model == "transr":
                # the broadcast fallback would gather [B, chunk, de, dr]
                # relation matrices per entity chunk: project the whole table
                model = dataclasses.replace(
                    model,
                    score_all_tails=functools.partial(kge_models.transr_all_tails, **kw),
                    score_all_heads=functools.partial(kge_models.transr_all_heads, **kw))
        if self.ent_shard is None:
            return ranking.make_predict_all(model, filt)
        return ranking.shard_predictors(
            *ranking.make_predict_all(model, filt, n_candidates=self.ent_shard.n_local),
            self.ent_shard)

    def filter_kg(self, filter_table: TripleTable | None) -> DeviceKG:
        if filter_table is None:
            return self.kg
        if self._filter_cache is None or self._filter_cache[0] is not filter_table:
            # periodic evaluations reuse one table: upload its CSR once
            self._filter_cache = (filter_table, DeviceKG.from_table(filter_table,
                                                                    device=self.device))
        return self._filter_cache[1]

    def link_prediction(self, test_triples: np.ndarray, filter_table: TripleTable | None = None,
                        type_constraints=None, chunk: int = 256):
        """Filtered link prediction. ``filter_table`` must be the
        train+valid+test UNION for the standard protocol (Test.h filters
        against all splits); with None only TRAIN triples are excluded and
        filtered metrics are understated."""
        if filter_table is None:
            warnings.warn(
                "link_prediction without filter_table: filtered ranks only "
                "exclude TRAIN triples — pass the train+valid+test union "
                "for the standard protocol (OpenKE Test.h).", stacklevel=2)
        filt = self.filter_kg(filter_table)
        all_tails, all_heads = self.predictors(filt)
        return ranking.link_prediction(all_tails, all_heads, self.params, filt, test_triples,
                                       chunk=chunk, type_constraints=type_constraints,
                                       shard=self.ent_shard)
