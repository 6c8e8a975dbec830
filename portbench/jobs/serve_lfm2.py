"""The zero-shot serving round of ``serve.py`` with LFM2-8B-A1B as the
multimodal encoder (configuration ``lfm2-8b-a1b``): the same entity sweep,
relation sweep, symbol-table refresh and ``evaluate`` on the
``rel_shared`` path, through the program's own LFM2 encoder (the model
type the configuration names in ``port_model_type``, cut to its
``layer_types`` and ``num_dense_layers``).

Set-up checks the model type with the program first, so a program without
the encoder stops there with its own error; it then builds the trainer and
the ZSL module with the benchmark's weights, refuses any encoder but the
program's LFM2, and serves one round untimed (it builds the kernels), which
must launch the causal attention kernel on a card.

Each MoE layer's ``select`` is wrapped, so every round keeps the experts
the program chose for every token of the entity sweep, the relation sweep
and the generator's description passes. After the window the reference
(``reference/lfm2.py``) computes the round once, taking the first round's
choices where its own margin for them is under the traffic's
``route_tie``, and every round is held against it: ``serve.py``'s gaps and
rank slack, and ``route_margin``, the largest reference margin at which a
round's program chose other experts than the reference used.

A traced run wraps the program's grouped attention entry in its own
annotation (``GQA_SPAN``; each call's shape recorded), adds the program's
``lfm2.moe``, ``lfm2.conv`` and ``moe.experts`` spans to its profile's
operations, and turns the program's counters on around the traced round:
its ``moe.routed`` goes to the notes beside the count from shapes
(``flops_lfm2.round_assignments``) that ``moe_roofline.lfm2`` reads.
"""

from __future__ import annotations

import contextlib
import time
import types

import numpy as np
import torch

from portbench import flops_lfm2
from portbench import trace as tracing
from portbench.harness import Window, capture, host_load, host_mark
from portbench.jobs import common, serve
from portbench.reference import data as rdata
from portbench.reference import lfm2 as rlfm2

GQA_SPAN = "portbench.attn_gqa"
SPANS = ("lfm2.moe", "lfm2.conv", "moe.experts", GQA_SPAN)


def _encoded(rel_ids) -> np.ndarray:
    """The ids ``FusionTrainer.generate`` encodes for ``rel_ids``: each
    distinct one once, in the order it takes them."""
    rel_ids = np.asarray(rel_ids)
    ids = np.unique(rel_ids)
    return rel_ids if len(ids) == len(rel_ids) else ids


def _install_gqa(ctx) -> list:
    """Wrap the program's grouped attention entry (as ``models/lfm2.py``
    calls it) in ``GQA_SPAN``; returns the list of (b, h, h_kv, n, hd,
    dtype, causal) of the calls made while the profile is active."""
    from mre_tpu_torch.models import lfm2

    inner = lfm2.grouped_attention
    calls: list = []

    def grouped_attention(q, k, v, padding_mask, scale, impl="auto"):
        if ctx.profile is not None and ctx.profile.active:
            b, h, n, hd = q.shape
            calls.append((b, h, k.shape[1], n, hd, str(q.dtype).replace("torch.", ""), True))
        with torch.profiler.record_function(GQA_SPAN):
            return inner(q, k, v, padding_mask, scale, impl)

    lfm2.grouped_attention = grouped_attention
    return calls


def _cut(ctx) -> dict:
    """The configuration's depth cut, checked by the program's own config:
    a program without the model type raises its own error here."""
    from mre_tpu_torch.models.m3ae import m3ae_config

    c = ctx.config
    cut = dict(layer_types=tuple(c["layer_types"]), num_dense_layers=c["num_dense_layers"])
    m3ae_config(c["port_model_type"], cut)
    return cut


def _program(ctx, path: str, cut: dict):
    """(data, store, trainer, p0) as ``common.fusion`` builds them, at the
    configuration's LFM2 model type and depth cut."""
    from mre_tpu_torch.models.lfm2 import LFM2

    c = ctx.config

    shim = types.SimpleNamespace(config=dict(c, model_type=c["port_model_type"]), seed=ctx.seed,
                                 device=ctx.device)
    data, store, trainer, p0 = common.fusion(shim, path, dict(encoder=cut))
    if not isinstance(trainer.model.M3AEmodel.encoder, LFM2):
        raise RuntimeError(f"model type {c['port_model_type']!r} built "
                           f"{type(trainer.model.M3AEmodel.encoder).__name__}, not LFM2")
    return data, store, trainer, p0


def _rows(calls: list, batch: int, n: int) -> torch.Tensor:
    """The choices of a sweep's calls (batches of ``batch`` rows, the last
    padded) as [n rows, tokens, k]."""
    parts = []
    for i, t in enumerate(calls):
        parts.append(t.view(batch, -1, t.shape[-1])[:min(batch, n - i * batch)])
    return torch.cat(parts)


def _by_relation(ids: list, per_layer: list) -> dict:
    """{relation id: per MoE layer its tokens' choices [1, tokens, k]} of the
    generator's description passes: call c encoded the rows ``ids[c]``, and
    ``per_layer[l][c]`` holds their choices in layer l."""
    out = {}
    for c, rows in enumerate(ids):
        for j, r in enumerate(rows):
            out[int(r)] = [calls[c].view(len(rows), -1, calls[c].shape[-1])[j:j + 1]
                           for calls in per_layer]
    return out


def run(ctx):
    tr, c = ctx.traffic, ctx.config
    cut = _cut(ctx)
    path = common.dataset(ctx)
    data, store, trainer, p0 = _program(ctx, path, cut)
    from mre_tpu_torch.core import profiling
    from mre_tpu_torch.models.lfm2 import SparseMoE
    from mre_tpu_torch.ops import attention as attn_ops

    zsl, q0, _, noises = common.zsl_module(ctx, path, data)
    if ctx.trace:
        ctx.gqa_calls = _install_gqa(ctx)
        ctx.profile.OPS = tracing.Profile.OPS + SPANS
    layers = [m for m in trainer.model.modules() if isinstance(m, SparseMoE)]
    chosen = [[] for _ in layers]
    for m, log in zip(layers, chosen):
        capture(m, "select", log, lambda a, k, out: out.to(torch.uint8))
    generated, encoded = [], []
    capture(trainer, "generate", generated, lambda a, k, out: out.detach().clone())
    capture(trainer, "generate", encoded, lambda a, k, out: _encoded(a[0]))
    n_queries = sum(len(v) for v in rdata.load(path)["test_candidates"].values())
    n_ent, n_rel = len(data["e2id"]), len(data["r2id"])
    launch_key = [k for k in attn_ops.LAUNCHES_BY_HEAD_DIM if ".causal_" in k]

    def launches():
        return sum(attn_ops.LAUNCHES_BY_HEAD_DIM[k] for k in launch_key)

    def serve_round(spans=None):
        span = spans.span if spans is not None else (lambda name: contextlib.nullcontext())
        marks = [len(chosen[0])]
        with span("ent_sweep"):
            ent = trainer.generate_ent_embeddings(batch_size=tr["entity_batch"])
            ctx.sync()
        marks.append(len(chosen[0]))
        with span("rel_emb"):
            rel = trainer.generate_rel_embeddings(batch_size=tr["relation_batch"])
        marks.append(len(chosen[0]))
        with span("update_embed"):
            zsl.update_embed(ent, rel)
        with span("evaluate"):
            res = zsl.evaluate(trainer, verbose=False, eval_path=tr["eval_path"],
                               query_chunk=tr["query_chunk"], return_ranks=True)
        ctx.sync()
        marks.append(len(chosen[0]))
        return (ent, rel, res["ranks"]), marks

    before = launches()
    serve_round()
    if ctx.device != "cpu" and launches() == before:
        raise RuntimeError("the LFM2 attention did not launch the causal kernel")
    for log in chosen:
        del log[:]
    del generated[:], encoded[:]
    if ctx.trace:
        ctx.spans.wrap(store, "generate_batch", "decode")
    rounds, marks, times = [], [], []
    host_counts = {}
    prof = ctx.profile
    setup_s = time.perf_counter() - ctx.t_start
    mark = host_mark()
    before = launches()
    t0 = time.perf_counter()
    while True:
        k = len(rounds) + 1
        if prof is not None and k == tr["profile_after"]:
            profiling.reset()
            profiling.enable()
            prof.start()
        t = time.perf_counter()
        out, m = serve_round(ctx.spans if ctx.trace else None)
        times.append(time.perf_counter() - t)
        if prof is not None and prof.active:
            prof.stop(1)
            profiling.disable()
            # the traced round's assignments as the program counted them (the
            # sweeps' padded rows included), beside the count from shapes
            # that moe_roofline.lfm2 reads
            counts = profiling.snapshot()["counts"]
            host_counts = dict(moe_routed=counts.get("moe.routed"),
                               moe_assignments_from_shapes=flops_lfm2.round_assignments(c))
        rounds.append(out)
        marks.append(m)
        if time.perf_counter() - t0 >= ctx.seconds and (prof is None or prof.done):
            break
    seconds = time.perf_counter() - t0
    host = host_load(mark, host_mark())
    host["gqa_launches_per_round"] = (launches() - before) / len(rounds)
    host.update(host_counts)
    peak = common.peak_bytes(ctx)
    per_round = len(generated) // len(rounds)
    gen = [generated[i * per_round:(i + 1) * per_round] for i in range(len(rounds))]
    routes = []
    for r, (a, b, e, f) in enumerate(marks):
        ids = encoded[r * per_round:(r + 1) * per_round]
        routes.append(dict(
            ent=[_rows(log[a:b], tr["entity_batch"], n_ent) for log in chosen],
            rel=[_rows(log[b:e], tr["relation_batch"], n_rel) for log in chosen],
            gen=_by_relation(ids, [log[e:f] for log in chosen])))
    del trainer, zsl, store, chosen
    common.free(ctx)
    rec = dict(path=path, p0=p0, q0=q0, noises=noises, rounds=rounds, generated=gen,
               routes=routes)
    return Window(units=len(rounds), seconds=seconds, unit_s=times, setup_s=setup_s,
                  flops_per_unit=flops_lfm2.serve_round(c, n_queries, c["n_candidates"]),
                  peak=peak, notes=host), rec


def _reference(ctx, rec: dict) -> dict:
    first = rec["routes"][0]
    return rlfm2.run(ctx.config, rec["p0"], rec["q0"], rdata.load(rec["path"]), rec["noises"],
                     ctx.seed, ctx.device, ctx.traffic["reference_block"],
                     follow=first,
                     tie=ctx.traffic["route_tie"])


def route_margin(ref_routes: dict, routes: dict) -> float:
    """The largest reference margin (``reference.lfm2.margins``) at which
    the program chose other experts for a token than the reference used:
    the entity and relation sweeps token by token, and each generator pass
    against the reference's pass of its relation's description."""
    def worst_of(biased, used, prog):
        e, k = biased.shape[-1], used.shape[-1]
        m = rlfm2.margins(biased.reshape(-1, e), prog.long().reshape(-1, k), used.reshape(-1, k))
        return float(m.abs().max()) if m.numel() else 0.0

    worst = 0.0
    for kind in ("ent", "rel"):
        for (biased, used, _), prog in zip(ref_routes[kind], routes[kind]):
            worst = max(worst, worst_of(biased, used, prog))
    for r, per_layer in routes["gen"].items():
        for (biased, used, _), prog in zip(ref_routes["gen"][r], per_layer):
            worst = max(worst, worst_of(biased, used, prog))
    return worst


def _layers(routes: dict) -> list:
    """Every per-layer entry of a round's routes: the entity sweep's, the
    relation sweep's, then each generator pass's by relation id."""
    return (routes["ent"] + routes["rel"]
            + [x for r in sorted(routes["gen"]) for x in routes["gen"][r]])


def numbers(ctx, rec: dict) -> tuple[dict, dict]:
    """``serve.numbers`` against the LFM2 reference, and ``route_margin``
    worst over the rounds; notes: the ties the reference followed and the
    largest margin among them, the rounds' choices that differ from the
    first round's, the expert load of the first round's entity sweep."""
    if ctx.reference is None:
        ctx.reference = _reference(ctx, rec)
    ref = ctx.reference
    worst, notes = serve.numbers(ctx, rec)
    worst["route_margin"] = max(route_margin(ref["routes"], r) for r in rec["routes"])
    first = rec["routes"][0]
    followed, followed_margin = 0, 0.0
    for biased, used, f in _layers(ref["routes"]):
        if bool(f.any()):
            own = torch.topk(biased[f], used.shape[-1], dim=-1).indices
            followed += int(f.sum())
            followed_margin = max(followed_margin,
                                  float(rlfm2.margins(biased[f], used[f], own).max()))
    drift = sum(int((a.long() != b.long()).any(-1).sum()) for r in rec["routes"][1:]
                for a, b in zip(_layers(r), _layers(first)))
    loads = []
    for sel in first["ent"]:
        counts = torch.bincount(sel.long().reshape(-1), minlength=ctx.config["num_experts"])
        loads.append((int(counts.max()), float(counts.float().mean())))
    notes.update(ties_followed=followed, followed_margin_max=followed_margin,
                 tokens_differing_from_round_1=drift,
                 expert_rows_max=[mx for mx, _ in loads], expert_rows_mean=loads[0][1],
                 expert_load_max_over_mean=max(mx / mean for mx, mean in loads))
    return worst, notes


def control(ctx, rec: dict) -> dict:
    """``rec`` with the program's round replaced by the reference's, run in
    TF32 (the precision below the configuration's float32) and routed by
    its own scores; its choices stand for the program's."""
    r = rlfm2.run(ctx.config, rec["p0"], rec["q0"], rdata.load(rec["path"]), rec["noises"],
                  ctx.seed, ctx.device, ctx.traffic["reference_block"], tf32=True)
    ranks = np.asarray([1 + int(((s >= t) | (ids == tid)).sum())
                        for t, s, tid, ids in r["scores"]])
    routes = {kind: [u for _, u, _ in r["routes"][kind]] for kind in ("ent", "rel")}
    routes["gen"] = {rid: [u for _, u, _ in per_layer]
                     for rid, per_layer in r["routes"]["gen"].items()}
    return dict(rec, rounds=[(r["ent"], r["rel"], ranks)], generated=[r["generated"]],
                routes=[routes])
