"""OpenKE-style Trainer / Tester (port of mre_tpu/openke/config.py).

The API mirrors the reference toolkit (OpenKE/openke/config/{Trainer,
Tester}.py): the Trainer takes one optimizer step per host batch, and
link-prediction evaluation runs the batched device ranker
(``ops/ranking.py``) or, with ``use_native_test``, the ctypes sampler.so
accumulators, for cross-checks between the two.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.data.kg import DeviceKG, TripleTable
from mre_tpu_torch.openke.data import TestDataLoader, read_benchmark, read_type_constraints
from mre_tpu_torch.ops import ranking, sampling
from mre_tpu_torch.train.kge import make_optimizer


class Trainer:
    """Trains a ``NegativeSampling`` strategy's model on ``device`` (``cuda``
    when None). ``epochs`` keeps one record per epoch: the summed ``loss``,
    the ``steps``, the wall ``seconds`` and their host split into drawing
    batches (``sample_s``) and stepping (``step_s``, which includes the one
    device wait of the epoch)."""

    def __init__(self, model=None, data_loader=None, train_times=1000, alpha=0.5,
                 opt_method="sgd", save_steps=None, checkpoint_dir=None,
                 log_every=100, use_gpu=None, device: str | torch.device | None = None):
        self.strategy = model                  # a NegativeSampling wrapper
        self.data_loader = data_loader
        self.train_times = train_times
        self.alpha = alpha
        self.opt_method = opt_method
        self.save_steps = save_steps
        self.checkpoint_dir = checkpoint_dir
        self.log_every = log_every
        self.device = resolve_device(device)
        self.optimizer = None
        self.epochs: list[dict] = []

    def step(self, data) -> torch.Tensor:
        """One optimizer step on a host batch; returns the loss (0-dim,
        detached, on the device)."""
        model = self.strategy.model
        if self.optimizer is None:
            model.to(self.device)
            self.optimizer = make_optimizer(model.parameters(), self.opt_method, self.alpha)
        batch = {k: torch.from_numpy(data[k]).to(self.device)
                 for k in ("batch_h", "batch_t", "batch_r")}
        self.optimizer.zero_grad(set_to_none=True)
        value = self.strategy.loss_value(model.params, batch)
        value.backward()
        self.optimizer.step()
        return value.detach()

    def run(self) -> float:
        model = self.strategy.model
        res = 0.0
        for epoch in range(self.train_times):
            # the epoch's loss accumulates on the device and is read once
            total, steps, sample_s, step_s = None, 0, 0.0, 0.0
            t0 = t_epoch = time.perf_counter()
            for data in self.data_loader:
                t1 = time.perf_counter()
                sample_s += t1 - t0
                value = self.step(data)
                total = value if total is None else total + value
                steps += 1
                t0 = time.perf_counter()
                step_s += t0 - t1
            res = float(total) if total is not None else 0.0
            now = time.perf_counter()
            self.epochs.append(dict(loss=res, steps=steps, seconds=now - t_epoch,
                                    sample_s=sample_s, step_s=step_s + now - t0))
            if self.log_every and epoch % self.log_every == 0:
                print(f"Epoch {epoch} | loss: {res:f}")
            if self.save_steps and self.checkpoint_dir and (epoch + 1) % self.save_steps == 0:
                model.save_checkpoint(f"{self.checkpoint_dir}-{epoch}.ckpt")
        return res


def _predictors(model, kg: DeviceKG):
    fn = model._fn
    if model._score_kwargs:
        fn = dataclasses.replace(fn, predict=functools.partial(fn.predict,
                                                               **model._score_kwargs))
    return ranking.make_predict_all(fn, kg)


class Tester:
    """Evaluates a model on ``device`` (``cuda`` when None)."""

    def __init__(self, model=None, data_loader: TestDataLoader | None = None,
                 use_gpu=None, use_native_test=False,
                 device: str | torch.device | None = None):
        self.model = model
        self.data_loader = data_loader
        self.use_native_test = use_native_test
        self.device = resolve_device(device)

    def _filter_kg(self, bench) -> DeviceKG:
        all_triples = np.concatenate([bench["train"], bench["valid"], bench["test"]])
        table = TripleTable.build(all_triples, bench["n_entities"], bench["n_relations"])
        return DeviceKG.from_table(table, device=self.device)

    def run_link_prediction(self, type_constrain=False):
        """(MRR, MR, Hits@10, Hits@3, Hits@1) of the filtered ranks, or of the
        type-constrained filtered ranks with ``type_constrain``."""
        in_path = self.data_loader.in_path
        self.model.to(self.device)
        if self.use_native_test:
            return self._run_native(type_constrain)
        bench = read_benchmark(in_path)
        tc = (read_type_constraints(in_path, bench["n_relations"], bench["n_entities"])
              if type_constrain else None)
        if type_constrain and tc is None:
            # fail BEFORE the ranking pass, not on a KeyError afterwards
            raise FileNotFoundError(
                f"type_constrain=True but {in_path}type_constrain.txt is "
                "missing (generate it with data/prep.py::write_type_constrain)")
        kg = self._filter_kg(bench)
        all_tails, all_heads = _predictors(self.model, kg)
        res = ranking.link_prediction(all_tails, all_heads, self.model.params, kg,
                                      bench["test"], type_constraints=tc)
        m = res["filter_tc" if type_constrain else "filter"]
        print(f"MRR: {m.mrr:.6f}  MR: {m.mr:.1f}  Hits@10: {m.hits10:.6f}  "
              f"Hits@3: {m.hits3:.6f}  Hits@1: {m.hits1:.6f}")
        return m.mrr, m.mr, m.hits10, m.hits3, m.hits1

    def _run_native(self, type_constrain):
        from mre_tpu_torch.openke import native

        lib = native.load()
        lib.setInPath(self.data_loader.in_path.encode())
        lib.importTrainFiles()
        lib.importTestFiles()
        if type_constrain:
            lib.importTypeFiles()
            if not lib.hasTypes():
                raise FileNotFoundError(
                    f"type_constrain=True but {self.data_loader.in_path}"
                    "type_constrain.txt is missing or malformed "
                    "(sampler.so rejected it)")
        lib.initTest()
        for index, (data_head, data_tail) in enumerate(self.data_loader):
            score = np.ascontiguousarray(self.model.predict(data_head), np.float32)
            lib.testHead(score.ctypes.data, index, type_constrain)
            score = np.ascontiguousarray(self.model.predict(data_tail), np.float32)
            lib.testTail(score.ctypes.data, index, type_constrain)
        lib.test_link_prediction(type_constrain)
        flag = 1 if type_constrain else 0
        return (lib.getTestLinkMRR(flag), lib.getTestLinkMR(flag),
                lib.getTestLinkHit10(flag), lib.getTestLinkHit3(flag),
                lib.getTestLinkHit1(flag))

    def run_triple_classification(self, threshold=None):
        """Triple classification with a best-threshold search
        (OpenKE Tester.py:93-150); returns (accuracy, threshold)."""
        self.model.to(self.device)
        bench = read_benchmark(self.data_loader.in_path)
        kg = self._filter_kg(bench)

        def scores_of(triples):
            return self.model.predict({"batch_h": triples[:, 0], "batch_t": triples[:, 2],
                                       "batch_r": triples[:, 1], "mode": "normal"})

        def negatives_of(triples, seed):
            gen = torch.Generator(self.device).manual_seed(seed)
            tri = torch.as_tensor(triples, dtype=torch.int64, device=self.device)
            batch = sampling.corrupt_batch(kg, tri[:, 0], tri[:, 1], tri[:, 2], n_neg=1,
                                           generator=gen)
            return np.stack([batch.neg_h[:, 0].cpu().numpy(), triples[:, 1],
                             batch.neg_t[:, 0].cpu().numpy()], 1)

        valid, test = bench["valid"], bench["test"]
        if threshold is None:
            if len(valid):
                # deliberate deviation from Tester.py:114-133, which fits the
                # threshold on the same test scores it reports: fit on valid
                fp, fn_ = scores_of(valid), scores_of(negatives_of(valid, 0))
            else:
                fp, fn_ = scores_of(test), scores_of(negatives_of(test, 1))
            threshold, _ = ranking.triple_classification_threshold(fp, fn_)
        tp = scores_of(test)
        tn = scores_of(negatives_of(test, 1))
        acc = (np.sum(tp <= threshold) + np.sum(tn > threshold)) / (len(tp) + len(tn))
        print(f"Triple classification accuracy: {acc:.6f} (threshold {threshold:.4f})")
        return float(acc), float(threshold)
