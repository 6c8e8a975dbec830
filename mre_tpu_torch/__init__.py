"""mre_tpu_torch — the PyTorch/CUDA port of mre_tpu for NVIDIA Hopper.

The package keeps the JAX package's layout (``cli/``, ``core/``,
``ops/``, ``models/``, ``data/``, ``eval/``, ``zsl/``, ``train/``,
``utils/``, ``openke/``) so that every module's counterpart is found under
the same name. It imports torch and numpy only. Ported so far:

* the entry point: ``python -m mre_tpu_torch.cli.main`` in train and
  evaluate modes, with checkpoints (``core/checkpoint.py``) and the distill
  predictor;
* zero-shot serving: FusionTrainer.generate_ent_embeddings /
  generate_rel_embeddings → ZSLModule.update_embed → ZSLModule.evaluate
  (``rel_shared``, ``head_shared`` or ``factored``);
* fusion training: FusionTrainer.train_step / train_epoch;
* ZSL training: ZSLModule.pretrain_extractor → compute_centroids →
  train_gan (WGAN-GP on the fusion model's generator head);
* the KGE toolkit: device sampling (``ops/sampling.py``), ranking losses,
  filtered link prediction (``ops/ranking.py``), the eleven OpenKE models
  (``models/kge.py``), ``train/kge.py::KGETrainer``, the OpenKE façade
  (``openke/``) with its native sampler (``csrc/sampler.cpp``, built by g++
  at first use), and the runner ``python -m mre_tpu_torch.tools.train_kge``.

* the parallel layer (``parallel/mesh.py``): a ``(data, model)`` process
  mesh over ``torch.distributed`` (NCCL on cards, gloo on the CPU) and its
  users: the data-parallel fusion step, the tensor-parallel entity sweep,
  the data-parallel D and G steps, the ``rel_shared`` evaluation, the KGE
  step with the entity table's rows over ``model`` and its filtered link
  prediction; ``python -m mre_tpu_torch.tools.dryrun_multichip`` checks
  them against a 1-rank run.

Everything the JAX package does is ported.

Attention on CUDA tensors runs a hand-written sm_90a kernel
(``csrc/attention_fwd.cu``, bound in ``ops/attention.py``).
"""
