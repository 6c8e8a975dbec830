"""Training / evaluation entry point (port of mre_tpu/cli/main.py).

Train mode: joint fusion training with checkpoints every ``save_epochs``
and a ZSL round (adversarial generator, zero-shot evaluation) after each
(reference main.py:32-215). Evaluate mode (``--evaluate``): load a
checkpoint, regenerate the embeddings, train the ZSL generator and rank the
zero-shot test queries (main.py:274-351).

Checkpoints hold the fusion parameters only, as in the JAX package:
``--resume`` and ``--pretrained_model_name`` restore them, while adam's
state, the schedule step, the spectral vectors and the sampler start
fresh; ``--start_epoch`` offsets the epoch labels. ``--pretrained_m3ae``
loads the upstream CC12M pickle's encoder side first
(``models/m3ae.py::load_cc12m_checkpoint``). ``--compute_dtype bfloat16``
reaches the fusion trainer and the evaluation.

Usage:
    python -m mre_tpu_torch.cli.main --dataset FB15K-237-ZS --data_root ./origin_data \\
        --model_type small --epochs 200 [--device cuda]
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from mre_tpu_torch.cli.args import read_options
from mre_tpu_torch.core import checkpoint as ckpt
from mre_tpu_torch.core.metrics import MetricLogger
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.loaders import load_zsl_dataset
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.models.m3ae import load_cc12m_checkpoint
from mre_tpu_torch.models.transformer import compute_dtype
from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer
from mre_tpu_torch.zsl.module import ZSLConfig, ZSLModule


def check_ported(args) -> None:
    """Check the options before anything is built. Every flag of the JAX
    entry point is ported. The JAX CLI has no mesh flag (its mesh is an
    argument of the library's trainers), so neither has this one: the mesh
    is ``parallel/mesh.py``, driven by ``tools/dryrun_multichip.py``.
    ``--compute_dtype`` must name a type the attention kernel has (float32
    or bfloat16; a ValueError otherwise)."""
    compute_dtype(args.compute_dtype)


def fusion_config(args) -> FusionConfig:
    return FusionConfig(
        model_type=args.model_type, emb_dim=args.emb_dim, noise_dim=args.noise_dim,
        patch_size=args.patch_size, image_mask_ratio=args.image_mask_ratio,
        text_mask_ratio=args.text_mask_ratio, batch_size=args.batch_size,
        sample_size=args.sample_size, margin=3.0,
        image_loss_weight=args.image_loss_weight,
        text_loss_weight=args.text_loss_weight,
        gcn_loss_weight=args.gcn_loss_weight,
        contrastive_loss_weight=args.contrastive_loss_weight,
        image_all_token_loss=args.image_all_token_loss,
        text_all_token_loss=args.text_all_token_loss,
        lr_maximum=args.lr_maximum, lr_minimum=args.lr_minimum,
        lr_warmup_epochs=args.lr_warmup_epochs, epochs=args.epochs,
        accumulate_grad_steps=args.accumulate_grad_steps,
        seed=args.seed, text_only=args.text_only, compute_dtype=args.compute_dtype)


def zsl_config(args) -> ZSLConfig:
    return ZSLConfig(
        emb_dim=args.emb_dim, noise_dim=args.noise_dim,
        test_sample=args.test_sample, max_neighbor=args.max_neighbor,
        pretrain_margin=args.pretrain_margin,
        pretrain_times=args.pretrain_times,
        pretrain_batch_size=args.pretrain_batch_size,
        pretrain_few=args.pretrain_few,
        pretrain_subepoch=args.pretrain_subepoch,
        pretrain_loss_every=args.pretrain_loss_every,
        train_times=args.train_times, D_epoch=args.D_epoch,
        G_epoch=args.G_epoch, D_batch_size=args.D_batch_size,
        G_batch_size=args.G_batch_size, gan_batch_rela=args.gan_batch_rela,
        lr_D=args.lr_D, lr_E=args.lr_E, lr_G=args.lr_maximum,
        loss_every=args.loss_every, seed=args.seed)


def build_pipeline(args):
    check_ported(args)
    data_path = os.path.join(args.data_root, args.dataset)
    data = load_zsl_dataset(data_path, mode="train")
    store = MultimodalStore(
        data["mm_info"], data["rel_des"],
        MultimodalPipelineConfig(image_size=args.image_size, tokenizer=args.tokenizer or None,
                                 vocab_size=args.vocab_size, text_only=args.text_only,
                                 seed=args.seed))
    table = TripleTable.build(np.asarray(data["triples"]).T,
                              len(data["e2id"]), len(data["r2id"]))
    fusion = FusionTrainer(table, store, fusion_config(args), device=args.device)

    if args.pretrained_m3ae:
        load_cc12m_checkpoint(args.pretrained_m3ae, fusion.model.M3AEmodel)
        print(f"Loaded pretrained M3AE from {args.pretrained_m3ae}")

    if args.pretrained_model_name:
        path = f"./saved_models/{args.dataset}/{args.pretrained_model_name}.ckpt"
        fusion.load_params(ckpt.load_checkpoint(path, fusion.params_tree()))
        print(f"Loaded pretrained model: {args.pretrained_model_name}")
    elif args.resume:
        latest = ckpt.latest_checkpoint(f"./saved_models/{args.dataset}", "epoch")
        if latest:
            fusion.load_params(ckpt.load_checkpoint(latest, fusion.params_tree()))
            print(f"Resumed from {latest}")

    zsl = ZSLModule(data_path, data["r2id"], data["e2id"], zsl_config(args),
                    device=args.device)
    return data, store, table, fusion, zsl


def run_zsl_round(args, fusion, zsl, logger, dump_embeddings: bool = False):
    """Refresh the embeddings → adversarial round → evaluation (reference
    main.py:203-213); saves the ZSL components to Embed_used
    (zsl_module.py:205-207)."""
    ent_embs = fusion.generate_ent_embeddings()
    rel_embs = fusion.generate_rel_embeddings()
    if dump_embeddings:
        # evaluate-mode embedding dumps (reference main.py:328-331)
        out_dir = args.output_dir or "."
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "temp_ent_embs.pkl"), "wb") as f:
            pickle.dump(ent_embs.cpu().numpy(), f)
        with open(os.path.join(out_dir, "temp_rel_embs.pkl"), "wb") as f:
            pickle.dump(rel_embs.cpu().numpy(), f)
    zsl.update_embed(ent_embs, rel_embs)
    zsl.train_gan(fusion)
    zsl.save(args.save_path, fusion)
    predict_unseen = None
    if args.distill_unseen:
        # unseen relations through the distilled description → embedding
        # predictor (DistillModel.py; utils.py generate_rel_embed 'unseen')
        predict_unseen, _ = fusion.train_distill(rel_embs, steps=args.distill_steps)
    result = zsl.evaluate(fusion, mode="test", predict_unseen=predict_unseen,
                          compute_dtype=args.compute_dtype, eval_path=args.eval_path)
    logger.log({f"zsl_{k}": v for k, v in result.items() if isinstance(v, (int, float))})
    return result


def main(args):
    logger = MetricLogger(output_dir=args.output_dir)
    data, store, table, fusion, zsl = build_pipeline(args)
    print(f"Entity Number: {table.n_entities}")
    print(f"Average steps per epoch is: {fusion.steps_per_epoch}")

    ckpt_dir = f"./saved_models/{args.dataset}"
    print("Start Fusion Training!")
    # reference semantics (main.py:123-125): train exactly args.epochs
    # epochs; start_epoch is a LABEL offset for resumed runs
    for raw_epoch in range(args.epochs):
        epoch = raw_epoch + args.start_epoch
        if args.profile_dir and raw_epoch == 0:
            from mre_tpu_torch.core.profiling import trace

            with trace(args.profile_dir):
                info = fusion.train_epoch()
        else:
            info = fusion.train_epoch()
        print(f"epoch{epoch + 1} loss is {info['loss']:.4f}!")
        logger.log({"epoch": epoch + 1, **info}, step=epoch)
        if (epoch + 1) % args.save_epochs == 0:
            path = f"{ckpt_dir}/epoch{epoch + 1}_{args.saved_model_name}.ckpt"
            ckpt.save_checkpoint(path, fusion.params_tree())
            print(f"save model at epoch{epoch + 1}: {path}")
            run_zsl_round(args, fusion, zsl, logger)
    ckpt.save_checkpoint(f"{ckpt_dir}/{args.saved_model_name}.ckpt", fusion.params_tree())
    print("Finish Training")


def evaluate_entry(args):
    logger = MetricLogger(output_dir=args.output_dir)
    data, store, table, fusion, zsl = build_pipeline(args)
    result = run_zsl_round(args, fusion, zsl, logger, dump_embeddings=True)
    print(f"[Final ZSL Scores] MRR: {result['mrr']:.4f}  Hits@10: {result['hits10']:.4f}  "
          f"Hits@5: {result['hits5']:.4f}  Hits@1: {result['hits1']:.4f}")
    return result


if __name__ == "__main__":
    cli_args = read_options()
    if cli_args.evaluate:
        evaluate_entry(cli_args)
    else:
        main(cli_args)
