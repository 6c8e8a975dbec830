"""Fusion step time at the training configuration of ``chip_smoke.py``'s
phase 4 (M3AE-small, depth 12 / decoder 8, 480 entities, the FusionConfig
defaults), on one card.

    python3 mre_tpu_torch/tools/step_time.py [--steps 20] [--windows 2] [--tag NAME]

It times whichever ``mre_tpu_torch`` and ``chip_smoke`` come first on the
import path, so two checkouts compare on one card in one call by running
it with each on ``PYTHONPATH`` in turns (A, B, B, A). After six warm-up
steps it prints ms per step over ``--windows`` windows of ``--steps``
steps (host clock around synchronised epochs, the producer thread
included), and the RGCN encoder's forward and forward + backward over the
fixture's whole graph (CUDA events), beside the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    import chip_smoke as cs
    from mre_tpu_torch.data.graph_sampler import edges_from_tasks

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--windows", type=int, default=2)
    parser.add_argument("--tag", default="")
    args = parser.parse_args(argv)
    cs.resolve_device()
    cs.attention.build()
    cfg = cs.TRAIN
    with tempfile.TemporaryDirectory() as d:
        cs.write_zsl_dataset(d, n_ent=cfg["n_ent"], n_rel=cfg["n_rel"],
                             n_unseen=cfg["n_unseen"], triples_per_rel=cfg["triples_per_rel"],
                             image_size=cfg["image_px"], seed=1)
        data = cs.load_zsl_dataset(d, mode="train")
    table = cs.TripleTable.build(np.asarray(data["triples"]).T,
                                 len(data["e2id"]), len(data["r2id"]))
    store = cs.MultimodalStore(data["mm_info"], data["rel_des"],
                               cs.MultimodalPipelineConfig(image_size=cfg["image_size"]))
    tr = cs.FusionTrainer(table, store, cs.FusionConfig(
        model_type=cfg["model_type"], patch_size=cfg["patch_size"], seed=192))
    with cs.first_steps(tr, 6):
        tr.train_epoch()
    step_ms = []
    for _ in range(args.windows):
        with cs.first_steps(tr, args.steps):
            cs.sync()
            t0 = time.perf_counter()
            tr.train_epoch()
            cs.sync()
            step_ms.append((time.perf_counter() - t0) / args.steps * 1e3)
    ei, et = (torch.as_tensor(a, dtype=torch.int64, device=tr.device)
              for a in edges_from_tasks(table.triples))
    x = torch.randn(table.n_entities, tr.model.M3AEmodel.cfg.emb_dim, device=tr.device,
                    requires_grad=True)

    def fwd_bwd():
        tr.model.gcn_forward_encoder(x, ei, et).sum().backward()

    with torch.no_grad():
        rgcn_fwd = cs.time_ms(lambda: tr.model.gcn_forward_encoder(x, ei, et), reps=20, warmup=3)
    rgcn_fwd_bwd = cs.time_ms(fwd_bwd, reps=20, warmup=3)
    out = dict(tag=args.tag, step_ms=step_ms, rgcn_edges=int(ei.shape[1]), rgcn_fwd_ms=rgcn_fwd,
               rgcn_fwd_bwd_ms=rgcn_fwd_bwd, card=cs.card_line())
    print(f"[step_time] {args.tag}: ms per step ({args.steps}-step windows) "
          f"{[round(s, 1) for s in step_ms]}; RGCN over {out['rgcn_edges']} edges fwd "
          f"{rgcn_fwd:.3f} ms, fwd+bwd {rgcn_fwd_bwd:.3f} ms; {out['card']}", flush=True)
    return out


if __name__ == "__main__":
    main()
