"""mre_tpu_torch — the PyTorch/CUDA port of mre_tpu for NVIDIA Hopper.

The package keeps the JAX package's layout (``core/``, ``ops/``,
``models/``, ``data/``, ``eval/``, ``zsl/``, ``train/``) so that every
module's counterpart is found under the same name. It imports torch and
numpy only. This slice ports the zero-shot serving path:

    FusionTrainer.generate_ent_embeddings / generate_rel_embeddings
    → ZSLModule.update_embed → ZSLModule.evaluate(eval_path="rel_shared")

Attention on CUDA tensors runs a hand-written sm_90a kernel
(``csrc/attention_fwd.cu``, bound in ``ops/attention.py``).
"""
