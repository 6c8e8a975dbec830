"""End-to-end zero-shot learnability run (the port's counterpart of
experiments/zsl_learnability.py).

Trains the whole pipeline (fusion learner → embeddings → Extractor
pretraining → WGAN generator) on the synthetic ZSL dataset with learnable
type structure (``data.fixtures.write_learnable_zsl_dataset``) and reports
zero-shot ranking quality on the unseen relations against random ranking.

    python -m mre_tpu_torch.tools.zsl_learnability [--epochs 4] \\
        [--pretrain_steps 400] [--train_times 200] [--seed 0] [--out DIR] \\
        [--compute_dtype float32|bfloat16] [--cert_out FILE] [--device cuda|cpu]

With ``--cert_out`` the trained module then ranks the test queries on every
(dtype × eval path) combination and a certification JSON is written: each
path's metrics and, against ``f32_factored``, the share of equal ranks, the
largest rank difference and the metric deltas. Without ``--out`` the dataset
goes to a temporary directory that is removed at the end. Runs on
``--device`` (default cuda; no card raises).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.data.fixtures import write_learnable_zsl_dataset
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.loaders import load_zsl_dataset
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer
from mre_tpu_torch.zsl.module import ZSLConfig, ZSLModule

N_CANDIDATES = 30
CERT_COMBOS = (("float32", "factored"), ("float32", "head_shared"),
               ("float32", "rel_shared"), ("bfloat16", "factored"),
               ("bfloat16", "head_shared"), ("bfloat16", "rel_shared"))


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--pretrain_steps", type=int, default=400)
    parser.add_argument("--train_times", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="")
    parser.add_argument("--compute_dtype", default="float32",
                        help="the M3AE transformers' dtype (bfloat16 runs the "
                             "kernel's bfloat16 instantiations)")
    parser.add_argument("--cert_out", default="",
                        help="if set, after training also rank with every "
                             "(dtype, path) combination of the eval path and "
                             "write a certification JSON")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def certify(zsl, fusion, result: dict, args) -> dict:
    """Rank the test queries on every (dtype, path) combination of the
    trained module; each path's metrics and its agreement with
    ``f32_factored`` (experiments/zsl_learnability.py:108-146)."""
    cert = {"n_queries": result["n"], "n_candidates": N_CANDIDATES,
            "trained": {"epochs": args.epochs, "train_times": args.train_times,
                        "pretrain_steps": args.pretrain_steps},
            "paths": {}}
    ranks = {}
    for dtype, path in CERT_COMBOS:
        t0 = time.time()
        r = zsl.evaluate(fusion, mode="test", verbose=False, query_chunk=16,
                         compute_dtype=dtype, eval_path=path, return_ranks=True)
        key = f"{'bf16' if dtype == 'bfloat16' else 'f32'}_{path}"
        ranks[key] = np.asarray(r.pop("ranks"))
        r.pop("per_relation", None)
        r["seconds"] = round(time.time() - t0, 2)
        cert["paths"][key] = r
        print(f"cert[{key}]: hits10 {r['hits10']:.4f} hits5 {r['hits5']:.4f} "
              f"mrr {r['mrr']:.4f} ({r['seconds']}s)", flush=True)
    ref = cert["paths"]["f32_factored"]
    for key in [k for k in cert["paths"] if k != "f32_factored"]:
        c = cert["paths"][key]
        c["rank_match_vs_f32_factored"] = float(np.mean(ranks[key] == ranks["f32_factored"]))
        c["max_abs_rank_delta"] = int(np.max(np.abs(ranks[key] - ranks["f32_factored"])))
        for m in ("hits10", "hits5", "hits1", "mrr"):
            c[f"d_{m}"] = round(c[m] - ref[m], 6)
    with open(args.cert_out, "w") as f:
        json.dump(cert, f, indent=1)
    print(f"cert written to {args.cert_out}", flush=True)
    return cert


def run(args, path: str) -> dict:
    """Write the learnable dataset at ``path``, train the pipeline, evaluate
    the unseen relations (and certify with ``args.cert_out``); returns the
    evaluation's result dict."""
    write_learnable_zsl_dataset(path, n_types=6, ents_per_type=20, n_rel=14, n_unseen=3,
                                triples_per_rel=40, n_candidates=N_CANDIDATES,
                                seed=args.seed)
    data = load_zsl_dataset(path, mode="train")
    store = MultimodalStore(
        data["mm_info"], data["rel_des"],
        MultimodalPipelineConfig(image_size=32, vocab_size=512, tokenizer_max_length=16,
                                 unpaired_tokenizer_max_length=16))
    table = TripleTable.build(np.asarray(data["triples"]).T,
                              len(data["e2id"]), len(data["r2id"]))
    fusion = FusionTrainer(table, store, FusionConfig(
        model_type="tiny4", emb_dim=32, noise_dim=8, patch_size=8,
        image_mask_ratio=0.5, text_mask_ratio=0.5,
        batch_size=8, sample_size=4, neg_ent=8,
        lr_maximum=3e-4, epochs=args.epochs, seed=args.seed,
        compute_dtype=args.compute_dtype), device=args.device)

    print(f"dataset at {path}: {table.n_entities} entities, "
          f"{table.n_relations} relations, {table.n_triples} train triples "
          f"(compute_dtype={args.compute_dtype}, device={fusion.device})", flush=True)
    for epoch in range(args.epochs):
        t0 = time.time()
        info = fusion.train_epoch()
        dt = (time.time() - t0) / max(fusion.steps_per_epoch, 1)
        print(f"fusion epoch {epoch}: loss {info['loss']:.3f} "
              f"gcn {info['gcn_loss']:.3f} text {info['text_loss']:.3f} "
              f"({dt * 1e3:.0f} ms/step)", flush=True)

    zsl = ZSLModule(path, data["r2id"], data["e2id"], ZSLConfig(
        emb_dim=32, noise_dim=8, test_sample=8, max_neighbor=20,
        pretrain_times=args.pretrain_steps, pretrain_batch_size=16,
        pretrain_few=4, pretrain_subepoch=4, pretrain_loss_every=200,
        train_times=args.train_times, D_batch_size=64, G_batch_size=64,
        gan_batch_rela=3, loss_every=100, seed=args.seed), device=args.device)

    ent_embs = fusion.generate_ent_embeddings(batch_size=64)
    rel_embs = fusion.generate_rel_embeddings(batch_size=16)
    zsl.update_embed(ent_embs, rel_embs)
    zsl.train_gan(fusion, pretrain_steps=args.pretrain_steps)
    result = zsl.evaluate(fusion, mode="test", verbose=True, query_chunk=16)

    random_hits10 = 10 / N_CANDIDATES
    print(f"\nZSL result: Hits@10 {result['hits10']:.3f} (random ≈ {random_hits10:.3f}), "
          f"Hits@5 {result['hits5']:.3f}, MRR {result['mrr']:.3f}, n={result['n']}")
    print(f"lift over random Hits@10: {result['hits10'] / random_hits10:.2f}x", flush=True)
    if args.cert_out:
        certify(zsl, fusion, result, args)
    return result


def main(argv=None) -> dict:
    args = parse_args(argv)
    resolve_device(args.device)             # no card and no --device cpu: raise first
    if args.out:
        return run(args, args.out)
    with tempfile.TemporaryDirectory() as tmp:
        return run(args, tmp)


if __name__ == "__main__":
    main()
