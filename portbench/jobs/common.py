"""Set-up the jobs share: the seeded dataset, the program's store, triple
table, fusion trainer and ZSL module at the configuration's sizes, with
the benchmark's own weights loaded over the program's initialisation."""

from __future__ import annotations

import os

import numpy as np

from portbench import fixture, weights


def dataset(ctx) -> str:
    """Write the configuration's dataset from the seed; returns its path."""
    c = ctx.config
    path = os.path.join(ctx.work_dir, "data")
    fixture.write_zsl_dataset(path, n_ent=c["n_ent"], n_rel=c["n_rel"], n_unseen=c["n_unseen"],
                              triples_per_rel=c["triples_per_rel"], image_ratio=c["image_ratio"],
                              n_candidates=c["n_candidates"], image_size=c["image_px"],
                              seed=ctx.seed)
    return path


def fusion(ctx, path: str, fusion_cfg: dict | None = None):
    """(data, store, trainer, weights) of the program on the dataset at
    ``path``; the trainer's model holds the benchmark's weights."""
    from mre_tpu_torch.data.kg import TripleTable
    from mre_tpu_torch.data.loaders import load_zsl_dataset
    from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
    from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer

    c = ctx.config
    data = load_zsl_dataset(path, mode="train")
    store = MultimodalStore(data["mm_info"], data["rel_des"], MultimodalPipelineConfig(
        image_size=c["image_size"], vocab_size=c["vocab_size"],
        tokenizer_max_length=c["text_tokens"],
        unpaired_tokenizer_max_length=c["description_tokens"], seed=ctx.seed))
    table = TripleTable.build(np.asarray(data["triples"]).T, len(data["e2id"]), len(data["r2id"]))
    cfg = FusionConfig(model_type=c["model_type"], emb_dim=c["gcn_dim"], noise_dim=c["noise_dim"],
                       patch_size=c["patch_size"], seed=ctx.seed, compute_dtype=c["dtype"],
                       attention_impl=c["attention_impl"], **(fusion_cfg or {}))
    trainer = FusionTrainer(table, store, cfg, device=ctx.device)
    p0 = weights.for_module(trainer.model, weights.generator(ctx.seed, ctx.device, 0), ctx.device)
    return data, store, trainer, p0


def zsl_module(ctx, path: str, data: dict, zsl_cfg: dict | None = None):
    """(module, extractor weights, critic weights, test noises) of the
    program's ZSL module with the benchmark's draws."""
    import torch

    from mre_tpu_torch.zsl.module import ZSLConfig, ZSLModule

    c = ctx.config
    gen = weights.generator(ctx.seed, ctx.device, 1)
    noises = 0.1 * torch.randn(c["test_sample"], c["noise_dim"], generator=gen, device=ctx.device)
    cfg = ZSLConfig(emb_dim=c["gcn_dim"], noise_dim=c["noise_dim"], test_sample=c["test_sample"],
                    max_neighbor=c["max_neighbor"], pretrain_times=c["pretrain_times"],
                    seed=ctx.seed % (2 ** 31), **(zsl_cfg or {}))
    zsl = ZSLModule(path, data["r2id"], data["e2id"], cfg, device=ctx.device, test_noises=noises)
    q = weights.for_module(zsl.extractor, gen, ctx.device)
    d = weights.for_module(zsl.discriminator, gen, ctx.device)
    return zsl, q, d, noises


def free(ctx):
    """Collect the program's state, which the caller has let go, before the
    reference runs."""
    import gc

    import torch

    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()


def peak_bytes(ctx) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if ctx.device != "cpu" else 0
