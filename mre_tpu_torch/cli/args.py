"""CLI flag surface (port of mre_tpu/cli/args.py): every flag of the JAX
package with its default, plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain PyTorch path on the CPU)."""

from __future__ import annotations

import argparse


def read_options(argv=None):
    parser = argparse.ArgumentParser(
        description="Zero-shot multimodal relation extrapolation (PyTorch/CUDA)")
    # Base settlement
    parser.add_argument("--dataset", default="FB15K-237-ZS", type=str)
    parser.add_argument("--seed", default=192, type=int)
    parser.add_argument("--model_type", default="small", type=str)
    parser.add_argument("--compute_dtype", default="float32", type=str,
                        help="M3AE transformer dtype: float32 or bfloat16")
    parser.add_argument("--eval_path", default="rel_shared", type=str,
                        choices=["factored", "head_shared", "rel_shared"],
                        help="zero-shot ranking body (ZSLModule.evaluate): "
                             "rel_shared amortizes the candidate gather + "
                             "first SupportEncoder matmul over each "
                             "relation's shared rel2candidates list")
    parser.add_argument("--saved_model_name", default="mre_tpu_small", type=str)
    parser.add_argument("--pretrained_model_name", default="", type=str)
    parser.add_argument("--evaluate", action="store_true")
    # fusion modal specification
    parser.add_argument("--batch_size", default=12, type=int)
    parser.add_argument("--sample_size", default=4, type=int)
    parser.add_argument("--epochs", default=200, type=int)
    parser.add_argument("--start_epoch", default=0, type=int)
    parser.add_argument("--save_epochs", default=10, type=int)
    parser.add_argument("--eval_epochs", default=10, type=int)
    parser.add_argument("--image_mask_ratio", default=0.75, type=float)
    parser.add_argument("--text_mask_ratio", default=0.75, type=float)
    parser.add_argument("--patch_size", default=16, type=int)
    parser.add_argument("--image_loss_weight", default=0.7, type=float)
    parser.add_argument("--text_loss_weight", default=0.5, type=float)
    parser.add_argument("--gcn_loss_weight", default=0.7, type=float)
    parser.add_argument("--contrastive_loss_weight", default=0.5, type=float)
    parser.add_argument("--image_all_token_loss", action="store_true")
    parser.add_argument("--text_all_token_loss", action="store_true")
    # optimization
    parser.add_argument("--lr_maximum", default=1e-4, type=float)
    parser.add_argument("--lr_minimum", default=0.0, type=float)
    parser.add_argument("--lr_warmup_epochs", default=5, type=int)
    parser.add_argument("--accumulate_grad_steps", default=1, type=int)
    # GCN part
    parser.add_argument("--emb_dim", default=200, type=int)
    # WGAN generation part
    parser.add_argument("--test_sample", default=20, type=int)
    # flag parity only: the reference's no_meta eval branch is dead code
    # (zsl_module.py:690-704 never assigns `scores` when meta=False)
    parser.add_argument("--no_meta", action="store_true")
    parser.add_argument("--max_neighbor", default=50, type=int)
    parser.add_argument("--noise_dim", default=15, type=int)
    parser.add_argument("--train_times", default=1000, type=int)
    parser.add_argument("--D_epoch", default=1, type=int)
    parser.add_argument("--G_epoch", default=1, type=int)
    parser.add_argument("--D_batch_size", default=256, type=int)
    parser.add_argument("--G_batch_size", default=256, type=int)
    parser.add_argument("--gan_batch_rela", default=2, type=int)
    parser.add_argument("--lr_D", default=1e-4, type=float)
    parser.add_argument("--lr_E", default=1e-4, type=float)
    parser.add_argument("--pretrain_times", default=10000, type=int)
    parser.add_argument("--pretrain_batch_size", default=64, type=int)
    parser.add_argument("--pretrain_few", default=8, type=int)
    parser.add_argument("--pretrain_subepoch", default=10, type=int)
    parser.add_argument("--pretrain_margin", default=5.0, type=float)
    parser.add_argument("--pretrain_loss_every", default=500, type=int)
    parser.add_argument("--log_every", default=1000, type=int)
    parser.add_argument("--loss_every", default=50, type=int)
    parser.add_argument("--eval_every", default=500, type=int)
    # beyond the reference's flags
    parser.add_argument("--data_root", default="./origin_data", type=str)
    parser.add_argument("--tokenizer", default="", type=str,
                        help="HF tokenizer path/name; blank → hashing tokenizer")
    parser.add_argument("--vocab_size", default=30522, type=int)
    parser.add_argument("--image_size", default=256, type=int)
    parser.add_argument("--text_only", action="store_true")
    parser.add_argument("--pretrained_m3ae", default="", type=str,
                        help="path to a flax m3ae checkpoint pickle (CC12M)")
    parser.add_argument("--output_dir", default="./runs", type=str)
    parser.add_argument("--profile_dir", default="", type=str,
                        help="write a torch.profiler Chrome trace of the first epoch here")
    parser.add_argument("--distill_unseen", action="store_true",
                        help="evaluate unseen relations through the DistillModel predictor")
    parser.add_argument("--distill_steps", default=2000, type=int)
    parser.add_argument("--resume", action="store_true",
                        help="auto-resume from the latest checkpoint in saved_models/<dataset>")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; cuda raises without a card, cpu runs "
                             "the plain PyTorch path")

    args = parser.parse_args(argv)
    args.save_path = f"{args.data_root}/{args.dataset}/Embed_used"
    return args
