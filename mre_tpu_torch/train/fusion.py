"""Fusion learner, serving form (port of mre_tpu/train/fusion.py).

``FusionTrainer`` builds the ``UnifiedModel`` and runs what the zero-shot
serving path asks of it (module/utils.py:479-546):

* ``generate_ent_embeddings`` — an M3AE cls pass over every entity in
  chunks of ``batch_size`` (the last chunk padded with the last id), then
  one full-graph RGCN sweep over the training triples;
* ``generate_rel_embeddings`` — the relation-description encoder;
* ``generate`` — the generator head: description ⊕ noise → embedding.

The training step (masking, decoder, losses, negative sampling, optimizer)
comes with the training slice. Weights are the seeded port init, or carried
from the JAX package with ``interop.load_flax(trainer.model, params,
spectral)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.data.graph_sampler import edges_from_tasks
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.multimodal import MultimodalStore
from mre_tpu_torch.models.initializers import init_weights
from mre_tpu_torch.models.unified import UnifiedModel, unified_config
from mre_tpu_torch.ops.patches import extract_patches


@dataclasses.dataclass
class FusionConfig:
    model_type: str = "small"
    emb_dim: int = 200
    noise_dim: int = 15
    patch_size: int = 16
    seed: int = 192
    attention_impl: str = "auto"     # auto | kernel | torch


class FusionTrainer:
    def __init__(self, table: TripleTable, store: MultimodalStore,
                 cfg: FusionConfig, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.table = table
        self.store = store
        self.cfg = cfg
        model = UnifiedModel(
            text_vocab_size=store.vocab_size,
            num_relations=table.n_relations,
            config=unified_config(cfg.model_type, dict(
                emb_dim=cfg.emb_dim, noise_dim=cfg.noise_dim,
                patch_size=cfg.patch_size, attention_impl=cfg.attention_impl)))
        self.model = init_weights(model, cfg.seed).to(self.device).eval()

    def _put(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    @staticmethod
    def _padded_ids(i: int, n: int, batch_size: int):
        ids = np.arange(i, min(i + batch_size, n))
        return ids, np.pad(ids, (0, batch_size - len(ids)), constant_values=ids[-1])

    @torch.no_grad()
    def generate_ent_embeddings(self, batch_size: int = 512) -> torch.Tensor:
        """All-entity M3AE cls pass (chunked) + one full-graph RGCN sweep."""
        m3ae = self.model.M3AEmodel
        n = self.table.n_entities
        reps = []
        for i in range(0, n, batch_size):
            ids, ids_p = self._padded_ids(i, n, batch_size)
            mm = self.store.generate_batch(ids_p, [])
            patches = (self._put(extract_patches(mm["image"], self.cfg.patch_size))
                       if "image" in mm else None)
            cls_x, _ = m3ae.forward_representation(
                patches, self._put(mm["text"]), self._put(mm["text_padding_mask"]))
            reps.append(cls_x[:len(ids), 0, :])
        edge_index, edge_type = edges_from_tasks(self.table.triples)
        return self.model.gcn_forward_encoder(
            torch.cat(reps), self._put(edge_index, torch.int64),
            self._put(edge_type, torch.int64))

    @torch.no_grad()
    def generate_rel_embeddings(self, batch_size: int = 64) -> torch.Tensor:
        n = self.table.n_relations
        out = []
        for i in range(0, n, batch_size):
            ids, ids_p = self._padded_ids(i, n, batch_size)
            out.append(self.model.forward_relation_emb(
                self._put(self.store.rel_ids[ids_p]),
                self._put(self.store.rel_mask[ids_p]))[:len(ids)])
        return torch.cat(out)

    @torch.no_grad()
    def generate(self, rel_ids: np.ndarray, noise: torch.Tensor) -> torch.Tensor:
        """Generator head: relation descriptions ⊕ noise → embeddings."""
        rel_ids = np.asarray(rel_ids)
        return self.model.generate(self._put(self.store.rel_ids[rel_ids]),
                                   self._put(self.store.rel_mask[rel_ids]),
                                   noise.to(self.device))
