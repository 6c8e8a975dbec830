"""ZSL subsystem, serving form (port of mre_tpu/zsl/module.py).

* symbol table + neighbor-connection matrix built once on the host
  (zsl/episodes.py); the symbol embedding matrix is refreshed from the
  fusion learner with ``update_embed``;
* ``evaluate(eval_path="rel_shared")`` — per-entity Extractor tables, the
  relation vectors from the generator head at ``test_sample`` fixed noises,
  and the relation-shared ranking of eval/zero_shot.py.

Extractor pretraining, the WGAN-GP loop, centroids, save/load and the
``factored``/``head_shared`` eval paths come with later slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.data import loaders
from mre_tpu_torch.eval.zero_shot import evaluate_zero_shot_rel_shared
from mre_tpu_torch.models.extractor import Extractor
from mre_tpu_torch.models.initializers import init_weights
from mre_tpu_torch.zsl.episodes import SymbolTable, build_connections


@dataclasses.dataclass
class ZSLConfig:
    emb_dim: int = 200
    noise_dim: int = 15
    test_sample: int = 20
    max_neighbor: int = 50
    seed: int = 0


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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
        self.symbols = SymbolTable(r2id, e2id)
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
        self.extractor = init_weights(Extractor(cfg.emb_dim), cfg.seed + 1
                                      ).to(self.device).eval()

    def update_embed(self, ent_embs, rel_embs):
        """Refresh the frozen symbol table from fusion-learner embeddings
        (zsl_module.py:209-237)."""
        table = self.symbols.build_embedding(_host(ent_embs), _host(rel_embs))
        self.symbol_table = torch.as_tensor(table, dtype=torch.float32,
                                            device=self.device)

    def _entity_symbols(self) -> torch.Tensor:
        ent_sym = np.full(self.connections.shape[0], self.symbols.pad_id, np.int64)
        for name in self.symbols.ent_names:
            ent_sym[self.e2id[name]] = self.symbols.symbol2id[name]
        return torch.as_tensor(ent_sym, device=self.device)

    @torch.no_grad()
    def evaluate(self, fusion_trainer, mode: str = "test", verbose: bool = True,
                 query_chunk: int = 64, eval_path: str = "rel_shared",
                 return_ranks: bool = False) -> dict:
        """Zero-shot ranking of the ``mode`` candidates (zsl_module.py:635-745)."""
        if eval_path != "rel_shared":
            raise ValueError(f"eval_path {eval_path!r}: this port ranks with "
                             "'rel_shared' only")
        test_candidates = loaders.load_candidates(self.data_path, mode)
        ex = self.extractor
        nbr = ex.encode_neighbors(self.symbol_table, self.connections, self.degrees)
        L, R = ex.precompute_pair_tables(self.symbol_table, nbr, self._entity_symbols())

        def gen_rel_vecs(rel_name):
            rel_ids = np.full(self.cfg.test_sample, self.r2id[rel_name])
            return _host(fusion_trainer.generate(rel_ids, self.test_noises))

        return evaluate_zero_shot_rel_shared(
            test_candidates, self.e2id,
            lambda heads, shared: ex.embed_pairs_rel_shared(L, R, heads, shared),
            lambda heads, trues: ex.embed_pairs_factored(L, R, heads, trues),
            gen_rel_vecs, query_chunk=query_chunk, verbose=verbose,
            return_ranks=return_ranks, device=self.device)
