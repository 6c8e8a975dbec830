"""The zero-shot serving round, as a user's evaluation runs it: the entity
sweep (``generate_ent_embeddings``: image decode and crop, the M3AE cls
pass in batches, the RGCN over the graph), the relation embeddings, the
symbol table's refresh, and ``ZSLModule.evaluate`` on the ``rel_shared``
path with each unseen relation's vectors generated from the test noises.

Set-up builds the trainer and the ZSL module with the benchmark's weights
and serves one round untimed (it builds the kernels). The window serves
rounds until ``--seconds`` have passed; each round's embeddings, generated
vectors and ranks are kept, and after the window every round is held
against one reference computation of the same round.
"""

from __future__ import annotations

import contextlib
import time

from portbench import flops
from portbench.harness import Window, capture, host_load, host_mark
from portbench.jobs import common
from portbench.reference import compare
from portbench.reference import data as rdata
from portbench.reference import serve as rserve


def run(ctx):
    tr = ctx.traffic
    path = common.dataset(ctx)
    data, store, trainer, p0 = common.fusion(ctx, path)
    zsl, q0, _, noises = common.zsl_module(ctx, path, data)
    generated: list = []
    capture(trainer, "generate", generated, lambda a, k, out: out.detach().clone())
    n_queries = sum(len(v) for v in rdata.load(path)["test_candidates"].values())

    def serve_round(spans=None):
        span = spans.span if spans is not None else (lambda name: contextlib.nullcontext())
        with span("ent_sweep"):
            ent = trainer.generate_ent_embeddings(batch_size=tr["entity_batch"])
            ctx.sync()
        with span("rel_emb"):
            rel = trainer.generate_rel_embeddings(batch_size=tr["relation_batch"])
        with span("update_embed"):
            zsl.update_embed(ent, rel)
        with span("evaluate"):
            res = zsl.evaluate(trainer, verbose=False, eval_path=tr["eval_path"],
                               query_chunk=tr["query_chunk"], return_ranks=True)
        ctx.sync()
        return ent, rel, res["ranks"]

    serve_round()
    del generated[:]
    if ctx.trace:
        ctx.spans.wrap(store, "generate_batch", "decode")
    rounds, times = [], []
    prof = ctx.profile
    setup_s = time.perf_counter() - ctx.t_start
    mark = host_mark()
    t0 = time.perf_counter()
    while True:
        k = len(rounds) + 1
        if prof is not None and k == tr["profile_after"]:
            prof.start()
        t = time.perf_counter()
        out = serve_round(ctx.spans if ctx.trace else None)
        times.append(time.perf_counter() - t)
        if prof is not None and prof.active:
            prof.stop(1)
        rounds.append(out)
        if time.perf_counter() - t0 >= ctx.seconds and (prof is None or prof.done):
            break
    seconds = time.perf_counter() - t0
    host = host_load(mark, host_mark())
    peak = common.peak_bytes(ctx)
    per_round = len(generated) // len(rounds)
    gen = [generated[i * per_round:(i + 1) * per_round] for i in range(len(rounds))]
    del trainer, zsl, store
    common.free(ctx)
    rec = dict(path=path, p0=p0, q0=q0, noises=noises, rounds=rounds, generated=gen)
    return Window(units=len(rounds), seconds=seconds, unit_s=times, setup_s=setup_s,
                  flops_per_unit=flops.serve_round(ctx.config, n_queries, ctx.config["n_candidates"]),
                  peak=peak, notes=host), rec


def numbers(ctx, rec: dict) -> tuple[dict, dict]:
    """Every round held against the reference's round: the entity and
    relation embeddings and the generated vectors by their largest gap over
    the reference's largest value, the ranks by the least score
    perturbation that explains them."""
    d = rdata.load(rec["path"])
    ref = ctx.reference or rserve.run(ctx.config, rec["p0"], rec["q0"], d, rec["noises"],
                                      ctx.seed, ctx.device, ctx.traffic["reference_block"])
    ctx.reference = ref
    s_true = [s[0] for s in ref["scores"]]
    worst = dict(ent_gap=0.0, rel_gap=0.0, gen_gap=0.0, rank_slack=0.0)
    for (ent, rel, ranks), gen in zip(rec["rounds"], rec["generated"]):
        worst["ent_gap"] = max(worst["ent_gap"], compare.rel_gap(ent, ref["ent"]))
        worst["rel_gap"] = max(worst["rel_gap"], compare.rel_gap(rel, ref["rel"]))
        worst["gen_gap"] = max([worst["gen_gap"]] + [
            compare.rel_gap(a, b) for a, b in zip(gen, ref["generated"])]
            + ([float("inf")] if len(gen) != len(ref["generated"]) else []))
        worst["rank_slack"] = max(worst["rank_slack"], compare.rank_slack(
            ranks, list(zip(s_true, [s[1] for s in ref["scores"]])),
            [s[2] for s in ref["scores"]], [s[3] for s in ref["scores"]]))
    return worst, dict(rounds=len(rec["rounds"]), queries=len(ref["scores"]))


def control(ctx, rec: dict) -> dict:
    """``rec`` with the program's round replaced by the reference's, run in
    the precision the caller has set (the control of the check); its ranks
    count, per query, the candidates scoring at least the true tail or
    carrying its id."""
    import numpy as np

    r = rserve.run(ctx.config, rec["p0"], rec["q0"], rdata.load(rec["path"]), rec["noises"],
                   ctx.seed, ctx.device, ctx.traffic["reference_block"])
    ranks = np.asarray([1 + int(((s >= t) | (ids == tid)).sum())
                        for t, s, tid, ids in r["scores"]])
    return dict(rec, rounds=[(r["ent"], r["rel"], ranks)], generated=[r["generated"]])
