"""The program's spans and its counters (``core/profiling.py``), on the
CPU at a tiny size.

Off (the default): a training epoch, a serving round and a GAN epoch
record nothing and enter no ``record_function``. On (between ``enable()``
and ``disable()``): every span of the training thread, the producer
thread, the serving round and the GAN steps sits under the parent that
``PERF.md`` names, on its thread, once per unit where it is per unit;
``h2d.bytes`` is the bytes handed to both ``_put``s, and
``zsl.generate.rows`` / ``zsl.generate.encoded`` the rows asked of
``FusionTrainer.generate`` and the distinct ones it encoded. Under a profiler
session the training thread's spans and ``zsl.generate`` are annotations
of its trace, and ``trace`` writes the producer thread's spans too.
"""

from __future__ import annotations

import glob
import json
import sys
import threading

import numpy as np
import pytest
import torch

from mre_tpu_torch.core import profiling
from mre_tpu_torch.data.fixtures import write_zsl_dataset
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.loaders import load_zsl_dataset
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer
from mre_tpu_torch.zsl.module import ZSLConfig, ZSLModule

PIPE = dict(image_size=16, vocab_size=100, tokenizer_max_length=6,
            unpaired_tokenizer_max_length=10)
MODEL = dict(model_type="tiny", emb_dim=12, noise_dim=4, patch_size=8, batch_size=4,
             sample_size=2, neg_ent=2, image_mask_ratio=0.5, text_mask_ratio=0.5)
ZSL = dict(emb_dim=12, noise_dim=4, test_sample=5, max_neighbor=10, G_batch_size=8,
           gan_batch_rela=2)

TRAIN_THREAD = {"fusion.step": None, "fusion.draw": "fusion.step", "fusion.loss": "fusion.step",
                "fusion.backward": "fusion.step", "fusion.adam": "fusion.step",
                "fusion.wait_batch": None, "attention.fwd": "fusion.loss"}
PRODUCER = {"fusion.prepare_batch": None, "data.generate_batch": "fusion.prepare_batch",
            "fusion.put": "fusion.prepare_batch"}
SERVE = {"fusion.ent_sweep": None, "data.generate_batch": "fusion.ent_sweep",
         "fusion.put": "fusion.ent_sweep", "m3ae.cls_pass": "fusion.ent_sweep",
         "rgcn.sweep": "fusion.ent_sweep", "attention.fwd": "m3ae.cls_pass",
         "fusion.rel_sweep": None, "zsl.update_embed": None, "zsl.evaluate": None,
         "zsl.pair_tables": "zsl.evaluate", "zsl.generate": "zsl.evaluate"}
GAN = {"zsl.gan_batch": None, "zsl.d_step": None, "zsl.g_step": None,
       "zsl.put": "zsl.d_step", "zsl.generate": "zsl.g_step"}


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tracing"))
    write_zsl_dataset(path, n_ent=30, n_rel=6, n_unseen=2, triples_per_rel=12,
                      image_size=8, n_candidates=22, seed=3)
    data = load_zsl_dataset(path, mode="train")
    table = TripleTable.build(np.asarray(data["triples"]).T, len(data["e2id"]),
                              len(data["r2id"]))
    store = MultimodalStore(data["mm_info"], data["rel_des"], MultimodalPipelineConfig(**PIPE))
    trainer = FusionTrainer(table, store, FusionConfig(**MODEL), device="cpu")
    zsl = ZSLModule(path, data["r2id"], data["e2id"], ZSLConfig(**ZSL), device="cpu")
    return trainer, zsl


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _train(trainer, zsl):
    steps = trainer.steps
    trainer.train_epoch()
    return trainer.steps - steps


def _serve(trainer, zsl):
    ent = trainer.generate_ent_embeddings(batch_size=16)
    rel = trainer.generate_rel_embeddings(batch_size=4)
    zsl.update_embed(ent, rel)
    zsl.evaluate(trainer, verbose=False, eval_path="rel_shared", query_chunk=8)
    return 1


def _gan(trainer, zsl):
    zsl.update_embed(torch.randn(trainer.table.n_entities, 12, generator=torch.Generator()
                                 .manual_seed(0)),
                     torch.randn(trainer.table.n_relations, 12, generator=torch.Generator()
                                 .manual_seed(1)))
    zsl.train_gan(trainer, train_times=2, skip_pretrain=True)
    return 2


UNITS = {"train": _train, "serve": _serve, "gan": _gan}


def _put_bytes(monkeypatch, *owners) -> list:
    """Wrap each owner's ``_put``; the list gets the nbytes of every array
    handed to one."""
    got: list = []
    for owner in owners:
        inner = owner._put

        def put(a, *args, _inner=inner, **kw):
            got.append(np.asarray(a).nbytes)
            return _inner(a, *args, **kw)

        monkeypatch.setattr(owner, "_put", put)
    return got


def _generate_ids(monkeypatch, trainer) -> list:
    """Wrap ``trainer.generate``; the list gets the ids of every call."""
    got: list = []
    inner = trainer.generate

    def generate(rel_ids, *args, **kw):
        got.append(np.asarray(rel_ids).copy())
        return inner(rel_ids, *args, **kw)

    monkeypatch.setattr(trainer, "generate", generate)
    return got


def _by_name(snap: dict) -> dict:
    """name → {(parent, thread id): count}."""
    out: dict = {}
    for (name, parent, thread), (n, ns) in snap["spans"].items():
        assert n > 0 and ns >= 0
        out.setdefault(name, {})[(parent, thread)] = n
    return out


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_off_records_nothing_and_enters_no_record_function(pipeline, monkeypatch, unit):
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **k):
        entered.append(a[0] if a else k.get("name"))
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    UNITS[unit](*pipeline)
    assert entered == []
    assert profiling.snapshot() == {"spans": {}, "counts": {}}
    assert profiling.span("fusion.step") is profiling.span("zsl.generate")


def test_training_spans_nest_per_step_on_their_threads(pipeline, monkeypatch):
    trainer, zsl = pipeline
    puts = _put_bytes(monkeypatch, trainer, zsl)
    profiling.enable()
    steps = _train(trainer, zsl)
    profiling.disable()
    snap = profiling.snapshot()
    spans = _by_name(snap)
    main = threading.get_ident()
    assert steps > 1
    for name, parent in TRAIN_THREAD.items():
        assert set(spans[name]) == {(parent, main)}, name
    for name in ("fusion.step", "fusion.draw", "fusion.loss", "fusion.backward", "fusion.adam"):
        assert spans[name][(TRAIN_THREAD[name], main)] == steps, name
    assert spans["fusion.wait_batch"][(None, main)] == steps + 1      # the last get is the stop
    producer = {t for _, t in spans["fusion.prepare_batch"]}
    assert len(producer) == 1 and main not in producer
    for name, parent in PRODUCER.items():
        assert set(spans[name]) == {(parent, t) for t in producer}, name
    assert sum(spans["fusion.prepare_batch"].values()) == steps
    assert snap["counts"] == {"h2d.bytes": sum(puts)} and sum(puts) > 0


def test_serving_round_spans_and_copies(pipeline, monkeypatch):
    trainer, zsl = pipeline
    puts = _put_bytes(monkeypatch, trainer, zsl)
    calls = _generate_ids(monkeypatch, trainer)
    profiling.enable()
    _serve(trainer, zsl)
    profiling.disable()
    snap = profiling.snapshot()
    spans = _by_name(snap)
    main = threading.get_ident()
    for name, parent in SERVE.items():
        assert (parent, main) in spans[name], name
    for name in ("fusion.ent_sweep", "fusion.rel_sweep", "zsl.update_embed", "zsl.evaluate",
                 "zsl.pair_tables", "rgcn.sweep"):
        assert spans[name] == {(SERVE[name], main): 1}, name
    assert set(spans["zsl.put"]) == {("zsl.update_embed", main), ("zsl.pair_tables", main)}
    assert ("zsl.generate", main) in spans["fusion.put"]
    assert {t for v in spans.values() for _, t in v} == {main}
    # evaluate asks for test_sample rows of one unseen relation per call
    assert calls and all(len(ids) == ZSL["test_sample"] and len(set(ids)) == 1 for ids in calls)
    assert snap["counts"] == {"h2d.bytes": sum(puts),
                              "zsl.generate.rows": ZSL["test_sample"] * len(calls),
                              "zsl.generate.encoded": len(calls)} and sum(puts) > 0


def test_gan_epoch_spans_and_copies(pipeline, monkeypatch):
    trainer, zsl = pipeline
    puts = _put_bytes(monkeypatch, trainer, zsl)
    calls = _generate_ids(monkeypatch, trainer)
    profiling.enable()
    epochs = _gan(trainer, zsl)
    profiling.disable()
    snap = profiling.snapshot()
    spans = _by_name(snap)
    main = threading.get_ident()
    for name, parent in GAN.items():
        assert (parent, main) in spans[name], name
    assert spans["zsl.d_step"] == {(None, main): epochs}
    assert spans["zsl.g_step"] == {(None, main): epochs}
    assert spans["zsl.gan_batch"] == {(None, main): 2 * epochs}
    assert spans["zsl.generate"] == {("zsl.d_step", main): epochs, ("zsl.g_step", main): epochs}
    # a D and a G step per epoch, each of Q rows; each call encodes its
    # distinct ids, and puts ids and mask, and the row index where it
    # holds more than one relation
    Q = ZSL["gan_batch_rela"] * ZSL["G_batch_size"]
    assert [len(ids) for ids in calls] == [Q] * 2 * epochs
    distinct = [len(np.unique(ids)) for ids in calls]
    assert all(1 <= d <= ZSL["gan_batch_rela"] for d in distinct)
    assert spans["fusion.put"] == {("zsl.generate", main):
                                   sum(2 + (d > 1) for d in distinct)}
    assert snap["counts"] == {"h2d.bytes": sum(puts), "zsl.generate.rows": 2 * epochs * Q,
                              "zsl.generate.encoded": sum(distinct)} and sum(puts) > 0


def _annotations(prof) -> dict:
    """record_function name → thread ids, from a profiler session's events."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().split(".")[0] in ("fusion", "zsl", "data", "m3ae", "rgcn", "attention"):
            out.setdefault(e.name(), set()).add(e.start_thread_id())
    return out


def test_profiler_session_holds_the_training_threads_spans(pipeline):
    from torch.profiler import ProfilerActivity, profile

    trainer, zsl = pipeline
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(trainer, zsl)
        zsl.update_embed(torch.zeros(trainer.table.n_entities, 12),
                         torch.zeros(trainer.table.n_relations, 12))
        zsl.train_gan(trainer, train_times=1, skip_pretrain=True)
    profiling.disable()
    names = _annotations(prof)
    for name in list(TRAIN_THREAD) + ["zsl.generate", "zsl.d_step", "zsl.g_step"]:
        assert name in names, name
    assert len(names["fusion.step"]) == 1
    # the producer started inside the session, which records its own thread only
    assert "fusion.prepare_batch" not in names


def test_profiler_session_without_tracing_gets_annotations_only(pipeline):
    """``generate_share.gan`` reads ``zsl.generate`` from a profiler session
    that never calls ``enable()``; the host aggregates stay empty."""
    from torch.profiler import ProfilerActivity, profile

    trainer, zsl = pipeline
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _gan(trainer, zsl)
    names = _annotations(prof)
    assert {"zsl.generate", "zsl.d_step", "zsl.g_step", "zsl.gan_batch"} <= set(names)
    assert profiling.snapshot() == {"spans": {}, "counts": {}}


def test_operator_trace_holds_every_threads_spans(pipeline, tmp_path, monkeypatch):
    trainer, zsl = pipeline
    puts = _put_bytes(monkeypatch, trainer, zsl)
    profiling.enable()
    with profiling.span("before"):                    # reset at the trace's start
        profiling.count("h2d.bytes", 1)
    with profiling.trace(str(tmp_path)):
        steps = _train(trainer, zsl)
    assert not profiling._on
    (path,) = glob.glob(str(tmp_path / "trace_*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tids: dict = {}
    for e in events:
        if e.get("ph") == "X" and e["name"] in ("fusion.step", "fusion.prepare_batch"):
            tids.setdefault(e["name"], set()).add(e["tid"])
    assert tids["fusion.step"] and tids["fusion.prepare_batch"]
    assert not tids["fusion.step"] & tids["fusion.prepare_batch"]
    # beside it, the host aggregates of the traced epoch and the copy counter
    (side,) = glob.glob(str(tmp_path / "trace_*.spans.json"))
    assert side == path.replace(".pt.trace.json", ".spans.json")
    with open(side) as f:
        spans = json.load(f)
    assert spans["counts"] == {"h2d.bytes": sum(puts)} and sum(puts) > 0
    main = threading.get_ident()
    rows = {(r["name"], r["parent"], r["thread"] == main): r for r in spans["spans"]}
    assert ("before", None, True) not in rows
    assert rows[("fusion.step", None, True)]["count"] == steps
    put = rows[("fusion.put", "fusion.prepare_batch", False)]
    prepare = rows[("fusion.prepare_batch", None, False)]
    assert put["count"] == 10 * steps                 # five graph arrays, four text, patches
    assert 0 < put["total_ns"] <= prepare["total_ns"]
    assert prepare["count"] == steps


def test_spanned_checks_per_call_and_keeps_the_function():
    @profiling.spanned("d")
    def work(x, y=1):
        """Doc."""
        return x + y

    assert work.__name__ == "work" and work.__doc__ == "Doc."
    assert work(1, y=2) == 3
    assert profiling.snapshot() == {"spans": {}, "counts": {}}
    profiling.enable()
    with profiling.span("c"):
        assert work(2) == 3
    with pytest.raises(TypeError):
        work()
    profiling.disable()
    work(0)
    me = threading.get_ident()
    assert {k: v[0] for k, v in profiling.snapshot()["spans"].items()} == {
        ("c", None, me): 1, ("d", "c", me): 1, ("d", None, me): 1}   # the raising call counts


def test_span_keys_nesting_counts_and_reset():
    profiling.count("h2d.bytes", 5)
    with profiling.span("a"):
        pass
    assert profiling.snapshot() == {"spans": {}, "counts": {}}
    profiling.enable()
    with profiling.span("a"):
        with profiling.span("b"):
            pass
        with profiling.span("b"):
            profiling.count("h2d.bytes", 7)
    with pytest.raises(KeyError):
        with profiling.span("a"):
            raise KeyError("x")
    profiling.count("h2d.bytes", 3)
    snap = profiling.snapshot()
    me = threading.get_ident()
    assert {k: v[0] for k, v in snap["spans"].items()} == {("a", None, me): 2, ("b", "a", me): 2}
    assert snap["counts"] == {"h2d.bytes": 10}
    snap["counts"]["h2d.bytes"] = 0                   # a copy
    assert profiling.snapshot()["counts"] == {"h2d.bytes": 10}
    with profiling.span("c"):                         # the stack unwound after the raise
        pass
    assert ("c", None, me) in profiling.snapshot()["spans"]
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counts": {}}


def test_threads_lose_no_span_or_count():
    """16 threads, each 500 nested spans and counts, with a short switch
    interval: every update lands."""
    n_threads, n = 16, 500
    profiling.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        profiling.count("h2d.bytes", 1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = profiling.snapshot()
    assert snap["counts"] == {"h2d.bytes": n_threads * n}
    outer = [v[0] for (name, parent, _), v in snap["spans"].items() if name == "outer"]
    inner = [(parent, v[0]) for (name, parent, _), v in snap["spans"].items() if name == "inner"]
    assert outer == [n] * n_threads
    assert inner == [("outer", n)] * n_threads
