"""TrainDataLoader / TestDataLoader, the OpenKE data layer (port of
mre_tpu/openke/data.py).

The reference's ``openke/data`` package is missing from its tree; its
behaviour is fixed by the Base.so ABI (Base.cpp's sampling layout, Test.h's
head / tail batch enumeration). Two interchangeable training backends give
numpy batches in the OpenKE layout (positives first, then negative blocks
at offsets ``batch + k·batch_size``):

* ``backend="native"`` — ctypes into the port's own ``sampler.so``
  (``csrc/sampler.cpp``): multi-threaded host sampling with exact filtered
  corruption;
* ``backend="torch"`` — the device sampler (``ops/sampling.py``) on
  ``device`` (``cuda`` when None), flattened to the same layout. Training
  straight through :class:`mre_tpu_torch.train.kge.KGETrainer` skips the
  host copies; this path keeps OpenKE training scripts working as they are.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.data.kg import DeviceKG, TripleTable
from mre_tpu_torch.ops import sampling


def read_benchmark(in_path: str):
    """Read an OpenKE benchmark directory (train/valid/test 2id.txt)."""

    def read(file):
        path = os.path.join(in_path, file)
        if not os.path.exists(path):
            return np.zeros((0, 3), np.int32)
        with open(path) as f:
            n = int(f.readline())
            rows = np.loadtxt(f, dtype=np.int64, max_rows=n).reshape(n, -1)
        # columns are (head, tail, relation) → reorder to (h, r, t)
        return np.stack([rows[:, 0], rows[:, 2], rows[:, 1]], 1).astype(np.int32)

    def count(file):
        with open(os.path.join(in_path, file)) as f:
            return int(f.readline())

    return dict(n_entities=count("entity2id.txt"), n_relations=count("relation2id.txt"),
                train=read("train2id.txt"), valid=read("valid2id.txt"), test=read("test2id.txt"))


def read_type_constraints(in_path: str, n_relations: int, n_entities: int):
    """type_constrain.txt as dense [R, E] bool masks (head_mask, tail_mask),
    or None without the file."""
    path = os.path.join(in_path, "type_constrain.txt")
    if not os.path.exists(path):
        return None
    head = np.zeros((n_relations, n_entities), bool)
    tail = np.zeros((n_relations, n_entities), bool)
    with open(path) as f:
        tokens = f.read().split()
    i, row = 1, 0                     # skip the count
    while i < len(tokens):
        rel, cnt = int(tokens[i]), int(tokens[i + 1])
        ids = [int(x) for x in tokens[i + 2:i + 2 + cnt]]
        (head if row % 2 == 0 else tail)[rel, ids] = True
        i += 2 + cnt
        row += 1
    return head, tail


class TrainDataLoader:
    """OpenKE-compatible training batch iterator."""

    def __init__(self, in_path="./", nbatches=100, threads=8, sampling_mode="normal",
                 bern_flag=0, filter_flag=1, neg_ent=1, neg_rel=0,
                 batch_size=None, backend="native", seed=None, p=False,
                 p_temp=1.0, device: str | torch.device | None = None):
        if backend not in ("native", "torch"):
            raise ValueError(f"backend {backend!r}: 'native' or 'torch'")
        self.in_path = in_path
        self.nbatches = nbatches
        self.sampling_mode = sampling_mode
        self.bern = bool(bern_flag)
        self.filter = bool(filter_flag)
        self.neg_ent = neg_ent
        self.neg_rel = neg_rel
        self.backend = backend
        self.p = bool(p)      # kl_prob-weighted relation corruption (importProb)
        self._cross_flag = 0

        for required in ("entity2id.txt", "relation2id.txt", "train2id.txt"):
            if not os.path.exists(os.path.join(in_path, required)):
                raise FileNotFoundError(f"benchmark file missing: {os.path.join(in_path, required)}")

        if backend == "native":
            from mre_tpu_torch.openke import native

            self.lib = native.load()
            self.lib.setInPath(in_path.encode())
            self.lib.setWorkThreads(threads)
            self.lib.setBern(1 if self.bern else 0)
            self.lib.importTrainFiles()
            if self.p:
                # the softmax table of <in_path>/kl_prob.txt (Reader.h:25-50)
                self.lib.importProb(p_temp)
            if seed is not None:
                self.lib.setSeed(seed)
            else:
                self.lib.randReset()
            self.ent_total = int(self.lib.getEntityTotal())
            self.rel_total = int(self.lib.getRelationTotal())
            self.train_total = int(self.lib.getTrainTotal())
        else:
            self.device = resolve_device(device)
            bench = read_benchmark(in_path)
            self.table = TripleTable.build(bench["train"], bench["n_entities"],
                                           bench["n_relations"])
            self.kg = DeviceKG.from_table(self.table, device=self.device)
            self.ent_total = bench["n_entities"]
            self.rel_total = bench["n_relations"]
            self.train_total = self.table.n_triples
            self.generator = torch.Generator(self.device).manual_seed(seed or 0)
            self._prob = None
            if self.p:
                kl = np.loadtxt(os.path.join(in_path, "kl_prob.txt"), dtype=np.float32)
                self._prob = sampling.relation_prob_table(
                    kl.reshape(self.rel_total, self.rel_total - 1), p_temp).to(self.device)

        self.batch_size = batch_size or self.train_total // nbatches
        n_per = self.batch_size * (1 + neg_ent + neg_rel)
        self._h = np.zeros(n_per, np.int64)
        self._t = np.zeros(n_per, np.int64)
        self._r = np.zeros(n_per, np.int64)
        self._y = np.zeros(n_per, np.float32)

    def get_ent_tot(self):
        return self.ent_total

    def get_rel_tot(self):
        return self.rel_total

    def get_batch_size(self):
        return self.batch_size

    def _mode_for_step(self):
        if self.sampling_mode == "normal":
            return 0, "normal"
        # "cross": alternate head_batch / tail_batch like upstream OpenKE
        self._cross_flag = 1 - self._cross_flag
        return (-1, "head_batch") if self._cross_flag else (1, "tail_batch")

    def _sample_native(self):
        mode, mode_name = self._mode_for_step()
        self.lib.sampling(
            self._h.ctypes.data, self._t.ctypes.data, self._r.ctypes.data,
            self._y.ctypes.data, self.batch_size, self.neg_ent, self.neg_rel,
            mode, self.filter, self.p, False)
        return {"batch_h": self._h.copy(), "batch_t": self._t.copy(),
                "batch_r": self._r.copy(), "batch_y": self._y.copy(), "mode": mode_name}

    def _sample_torch(self):
        _, mode_name = self._mode_for_step()
        B, n = self.batch_size, self.neg_ent
        nb = sampling.sample_training_batch(self.kg, B, n, self.bern, generator=self.generator)
        # [B] positives, then the n negative blocks: columns of [B, n]
        h = torch.cat([nb.h, nb.neg_h.T.reshape(-1)])
        t = torch.cat([nb.t, nb.neg_t.T.reshape(-1)])
        r = nb.r.repeat(1 + n)
        if self.neg_rel:
            # Base.cpp quirk (Base.cpp:91, 104-146): the reference's sampler
            # reads filter_flag but never passes it to the corrupt_* calls, so
            # batch corruption is ALWAYS filtered and p always honoured; the
            # standalone corruptRel hook still honours filter_flag
            if self.p:
                neg_r = sampling.corrupt_relations_prob(self.kg, nb.h, nb.t, nb.r, self._prob,
                                                        self.neg_rel, generator=self.generator)
            else:
                neg_r = sampling.corrupt_relations(self.kg, nb.r, self.neg_rel, h=nb.h, t=nb.t,
                                                   filter_flag=True, generator=self.generator)
            h = torch.cat([h, nb.h.repeat(self.neg_rel)])
            t = torch.cat([t, nb.t.repeat(self.neg_rel)])
            r = torch.cat([r, neg_r.T.reshape(-1)])
        y = np.concatenate([np.ones(B, np.float32), -np.ones(B * (n + self.neg_rel), np.float32)])
        h, t, r = torch.stack([h, t, r]).cpu().numpy()          # one copy to the host
        return {"batch_h": h, "batch_t": t, "batch_r": r, "batch_y": y, "mode": mode_name}

    def sample(self):
        return self._sample_native() if self.backend == "native" else self._sample_torch()

    def __iter__(self):
        for _ in range(self.nbatches):
            yield self.sample()

    def __len__(self):
        return self.nbatches


class TestDataLoader:
    """OpenKE-compatible test iterator: per test triple, head and tail
    batches enumerating every entity as candidate (Test.h:36-53 layout).
    The batched ranker (``ops/ranking.py``) is the fast path; this loader
    serves the native accumulators."""

    def __init__(self, in_path="./", sampling_mode="link", type_constrain=False):
        self.in_path = in_path
        self.sampling_mode = sampling_mode
        self.type_constrain = type_constrain
        bench = read_benchmark(in_path)
        self.test = bench["test"]
        self.ent_total = bench["n_entities"]
        self.rel_total = bench["n_relations"]

    def set_sampling_mode(self, mode):
        self.sampling_mode = mode

    def get_ent_tot(self):
        return self.ent_total

    def get_triple_tot(self):
        return len(self.test)

    def __len__(self):
        return len(self.test)

    def __iter__(self):
        ents = np.arange(self.ent_total, dtype=np.int64)
        for h, r, t in self.test:
            data_head = {"batch_h": ents, "batch_t": np.full_like(ents, t),
                         "batch_r": np.full_like(ents, r), "mode": "head_batch"}
            data_tail = {"batch_h": np.full_like(ents, h), "batch_t": ents,
                         "batch_r": np.full_like(ents, r), "mode": "tail_batch"}
            yield [data_head, data_tail]
