"""Chip smoke test of the PyTorch/CUDA port (mre_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on any failure):

1. card and build — the card's name and power limit (nvidia-smi); every
   kernel of the path is compiled from csrc/ with nvcc (all sources at once),
   and each instantiation's ptxas registers and spills and its count of
   tensor-core HMMA instructions (cuobjdump) are printed;
2. kernels vs plain — each kernel's wrapper on the card at the shapes of the
   serving and training paths, held against its plain PyTorch version
   (float32 atol 1e-4, bfloat16 atol 2e-2), with CUDA-event times of the
   kernel, the plain version and the library call beside the bound worked
   out from shapes (float32 held to the TF32 tensor-core peak) and the
   kernel's share of it. ``attention_fwd`` at head_dim 64 stands for the TPU's
   ``_attention_kernel``, at head_dim 32 (the decoder) for
   ``_attention_kernel_packed``. The learnability path's short sequences
   (phase 10) are held too: N 17 and 33 at head_dim 64, N 33 at 32;
3. serving slice — a synthetic ZSL dataset (2048 entities, 32 relations, 4
   unseen) through the M3AE-small model (emb 384, depth 12, 6 heads of 64,
   image 256 / patch 16, 64 text and 320 description tokens; GCN dim 200,
   noise 15, test_sample 20) with seeded random weights:
   generate_ent_embeddings → generate_rel_embeddings → update_embed →
   evaluate(eval_path="rel_shared"). The launch counts of that run must
   equal depth × (⌈n_ent/512⌉ + ⌈n_rel/64⌉ + n_unseen). A second trainer
   built from the same seed with attention_impl="torch" then serves the
   same round through the plain attention, and the two must agree. One more
   kernel-path round runs under torch.profiler (device busy time, idle
   share, top device ops);
4. training — one ``train_epoch`` of the fusion step at the full width of
   M3AE-small (decoder 512 wide, depth 8, 16 heads of 32; 12 seeds × 4
   sampled edges: 60 nodes, 48 edges; 10 negatives) on a 480-entity
   fixture (40 steps), then the same epoch on a same-seed
   attention_impl="torch" trainer. Each kernel step must launch exactly
   3 × 12 head_dim-64 and 8 head_dim-32 attention kernels, the plain run
   none; every loss term is finite; the first step agrees to rtol 1e-4 and
   the epoch means to rtol 1e-2 (+ 1e-3). A second window of 20 steps of
   each, plain first, gives step times in turns. Then six steps of each path, the
   producer thread included, run under torch.profiler: device busy time,
   idle share, and the share of the plain attention backward;
5. the ZSL round — on the serving fixture after its update_embed, at the
   ZSLConfig defaults (emb 200, noise 15, test_sample 20, max_neighbor 50;
   pretraining episodes of 64 queries × 8 shots × 10 sub-epochs; GAN
   batches of 256 rows × 2 relations, so every D and G step re-encodes 512
   descriptions of 321 tokens through the text transformer):
   pretrain_extractor → compute_centroids → train_gan → evaluate on the
   rel_shared, head_shared and factored paths, on a kernel-path ZSL module
   and on a same-seed one over the plain-attention trainer. train_gan must
   launch exactly (D_epoch + G_epoch) × depth hd-64 kernels per epoch,
   pretraining and the centroids none, each evaluation depth × n_unseen,
   the plain run none; the first epoch's D and G terms agree to rtol 1e-4,
   every history term is finite, and the MRRs agree to 1e-3 across the two
   runs and the three paths; the kernel run's trained module (Extractor
   and generator head) ranks the queries through the kernel and through
   the plain attention (ranks gated as below; the separately trained plain
   run's ranks are reported). A
   second round of each, plain first, gives
   ms per pretrain step and per GAN epoch in turns; three GAN epochs run
   under torch.profiler (device busy time, idle share, the attention, float32
   GEMM and ``generate`` shares);
6. the CLI — ``python -m mre_tpu_torch.cli.main`` at the full width of
   M3AE-small with every width flag at its default, on a fixture of the
   training phase's size (candidate lists long enough for the GAN batcher),
   in a temporary working directory; the only reductions are 20 Extractor
   pretraining steps and 5 GAN epochs. Train mode in-process (``main``, two
   epochs, checkpoint and ZSL round at epoch 2, the first epoch under
   ``--profile_dir``): exact launch counts (2 epochs of steps, the entity and
   relation sweeps, 5 GAN epochs, one rel_shared evaluation), the JAX
   package's file set, finite ``loss`` and ``zsl_mrr`` in the metrics JSONL,
   ``attention_fwd_kernel`` in the trace. ``--resume --epochs 1
   --start_epoch 2``: the parameters right after ``build_pipeline`` equal
   the epoch-2 checkpoint bit for bit. Evaluate mode from the final
   checkpoint as a subprocess: exit 0, ``[Final ZSL Scores]``, and its
   dumped entity embeddings within rtol 1e-4 (of the largest magnitude) of a
   same-checkpoint trainer's on the plain attention. Wall time per stage:
   ms per step, checkpoint save / load seconds and bytes, ZSL-round and
   evaluate-entry seconds;
7. the options, in bfloat16 (the kernel's bf16 instantiations; launches
   counted per dtype, ``attention.LAUNCHES_BY_DTYPE``): the serving round
   of phase 3 with ``compute_dtype="bfloat16"`` on a kernel-path and a
   same-seed plain trainer (exactly depth × (⌈n_ent/512⌉ + ⌈n_rel/64⌉ +
   n_unseen) bf16 hd-64 launches and no float32 one; entity and relation
   embeddings within a median relative error of 0.05 of phase 3's float32
   ones, and nearer the plain bf16 run's than that run is to float32; ranks
   reported beside float32's), then the entity sweep again with the image
   cache (``precompute_image_cache``: seconds, bytes, ``ent_s`` on and
   off); a bf16 training epoch on phase 4's fixture, kernel then plain (3 ×
   depth bf16 hd-64 and dec_depth bf16 hd-32 launches per step; finite
   terms; the first step within rtol 5e-3), then phase 4's float32 trainer
   and the bf16 one in turns, then an epoch of a trainer built with
   ``image_cache=True`` and six of its steps under torch.profiler; GAN
   epochs on ZSL modules over the bf16 and the float32 trainers in turns;
   the CLI's ``main`` with ``--compute_dtype bfloat16``, one epoch, a
   checkpoint and a ZSL round (exact bf16 launches, finite ``zsl_mrr``).
   Every check of the phase runs and prints before its failures are raised;
8. the KGE toolkit (no attention kernel; its launches must stay 0), on
   synthetic benchmarks at the published sizes of FB15K-237 (14,541
   entities, 237 relations, 272,115 / 17,535 / 20,466 triples) and WN18RR
   (40,943, 11, 86,835 / 3,034 / 3,134): (a) ``corrupt_batch`` on the card
   equals the CPU's given the draws, tier-2 rows and truncation count
   included, on a KG with a 200-tail row, and a FB15K-237-sized batch holds
   no true triple and truncates nothing; (b) ``tools/train_kge.py``'s
   ``main`` runs the transe_FB15K237 recipe at full width for two epochs on
   the native sampler (8 threads): finite epoch losses, the second below the
   first, ms per step split into host sampling and the step; then an epoch
   on the device sampler; (c) rotate_WN18RR_adv through ``KGETrainer``
   (dim 1024, 2000 × 64, Adam): its first step on a 200 × 64 cut agrees
   with the CPU's (loss rtol 1e-4, parameters within 1e-4 of each table's
   largest magnitude), then one epoch of 43 steps; (d) distmult_WN18RR, one
   epoch (the ranking's matrix-product path); (e) filtered ranks of every
   test triple on the card for (b)-(d), ms per triple, and the first 64
   ranked on the CPU too (≥ 99% equal, none moved by more than 2, MRR
   within 1e-3); (f) torch.profiler over five RotatE steps, five façade
   TransE steps and one RotatE ranking chunk (device busy time, idle share,
   top ops, the gather / index-backward share). Every check of the phase
   runs and prints before its failures are raised;
9. the mesh (``mre_tpu_torch/parallel/mesh.py``; ~90 s):
   ``tools/dryrun_multichip.run_checks`` at full width on a 1-rank NCCL
   world and a larger one: one NCCL rank per card on a machine with two
   cards or more, else a 2-rank gloo world of CUDA tensors on the one card
   (NCCL refuses two ranks on one card); spawned after the kernel build, on
   a 512-entity serving fixture: three data-parallel fusion steps of phase
   4's config
   (parameters within 5e-4·scale + 1e-5 and adam's first moment within 1e-4
   of each leaf's largest, across the two worlds; exactly 3 × depth and
   dec_depth launches per rank and step; the train state saved under the
   mesh by rank 0, restored, two more steps bitwise equal to the live
   ones), the entity sweep with the FFNs tensor parallel on world/2 × 2 (rtol
   2e-4, atol 2e-5 of the replicated sweep), rel_shared ranks with the chunks over ``data`` (equal), three D/G
   iterations at the ZSLConfig defaults with the GAN batch over ``data``
   (rtol 2e-4), a rotate_WN18RR_adv step on a 200 × 64 cut data parallel
   (loss rtol 1e-4) and on world/2 × 2 with the entity rows over ``model``
   (the ranks of 64 test triples equal to the replicated run's); step,
   all-reduce (the 1-rank world's over its own one-rank NCCL group: its
   step has no collective), sweep, GAN and ranking times per world. Every check of the
   phase runs and prints before its failures are raised;
10. trained weights — ``tools/zsl_learnability.main`` in process at the
   trained settings of the JAX package's certification
   (experiments/results/bf16_cert.json: 6 fusion epochs, 400 Extractor
   pretraining steps, 400 GAN epochs; ``tiny4``: M3AE-small's widths at
   depth 4 / 4, image 32 / patch 8, 16 text and 16 description tokens) on
   the learnable fixture, with ``--cert_out chiprun_out/learnability_cert.json``:
   exact launches (3 × depth per fusion step, dec_depth per step, depth per
   sweep batch, 2 × depth per GAN epoch, depth × 3 unseen relations per
   evaluation; none in pretraining or the centroids); float32 ``factored``
   Hits@10 at least 0.5 on the 59 unseen-relation queries (random 0.333);
   the trained module through the kernel and through the plain attention,
   at least 0.95 of the float32 ranks equal and none moved by more than 1
   on each path (bf16 reported); each bf16 path against ``f32_factored`` at
   least 0.88 equal with |d Hits@10| at most 0.05; stage seconds and ms per
   fusion step, pretrain step and GAN epoch. Every check prints before the
   failures are raised together;
11. one JSON line of kernels (the float32 and the bfloat16 instantiations,
   each with its launches on every path, the mesh's per rank), the card
   line, and the result line.

Details that do not fit the end of the output go to chiprun_out/.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from mre_tpu_torch.cli import main as cli
from mre_tpu_torch.cli.args import read_options
from mre_tpu_torch.core import checkpoint as ckpt
from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.data.fixtures import write_zsl_dataset
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.loaders import load_candidates, load_zsl_dataset
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.ops import attention
from mre_tpu_torch.train.fusion import INFO_KEYS, FusionConfig, FusionTrainer
from mre_tpu_torch.zsl.module import EVAL_PATHS, ZSLConfig, ZSLModule

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet, dense), the rates each type's
# bound is held to: float32 at the TF32 tensor-core peak (the kernel computes
# float32 on the tensor cores, in three TF32 passes; the bound counts the
# work once), bfloat16 at the bf16 tensor-core peak, bytes at HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 495e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# the serving slice at the full width of M3AE-small (depth 12)
SLICE = dict(model_type="small", depth=12, image_size=256, patch_size=16,
             n_ent=2048, n_rel=32, n_unseen=4, triples_per_rel=200,
             n_candidates=500, image_px=64)

# the fusion training step at the full width of M3AE-small and the default
# FusionConfig (12 seeds × 4 edges, 10 negatives); 480 entities = 40 steps
TRAIN = dict(model_type="small", depth=12, dec_depth=8, image_size=256, patch_size=16,
             n_ent=480, n_rel=32, n_unseen=4, triples_per_rel=60, image_px=64)
# the kernel run against the plain run over one epoch: the first step's
# terms differ only by summation order (rtol 1e-4); after 40 adam steps a
# parameter whose gradient is near 0 may step by ±lr in the two runs, so the
# epoch means get a looser bound, plus one token's accuracy flip (1e-3).
FIRST_STEP_RTOL = 1e-4
EPOCH_RTOL, EPOCH_ATOL = 1e-2, 1e-3
PROFILE_STEPS = 6
TURN_STEPS = 20             # the second, timing-only windows in turns

# the ZSL round (phase 5): ZSLConfig defaults; P pretraining steps, T GAN
# epochs per run, three GAN epochs profiled. The kernel and plain runs
# share every draw (same seeds), so the first epoch's terms differ only by
# the attention's summation order (rtol 1e-4); the ranks of one trained
# module through either attention, and across paths, only by near-tie
# flips: at least 99% equal, none moved by more than 2 places.
ZSL_ROUND = dict(pretrain_steps=50, train_times=10, profile_epochs=3)
FIRST_EPOCH_RTOL = 1e-4
MRR_ATOL = 1e-3
RANK_EQUAL_MIN, RANK_MAX_DIFF = 0.99, 2


# the CLI (phase 6): the training fixture's size, every width flag at its
# default; n_candidates above the GAN batcher's floor of 20
CLI = dict(n_ent=480, n_rel=32, n_unseen=4, triples_per_rel=60, image_px=64,
           n_candidates=100, flags=["--model_type", "small", "--pretrain_times", "20",
                                    "--train_times", "5"])
CLI_EMB_RTOL = 1e-4
CLI_NAME = "mre_tpu_small"          # --saved_model_name's default

# the options (phase 7): bfloat16 against float32 (the entity and relation
# embeddings of one seed's weights) under the gate of tests/test_bf16.py.
# The bfloat16 kernel run against the plain run: the kernel rounds its
# outputs to bfloat16 after sums in another order than the plain twin's, so
# one unit in the last place differs here and there (phase 2: max |d| 2e-3
# to 7.8e-3) and the twelve blocks after carry it. The embeddings must then
# differ from the plain run's by less than the plain bfloat16 run differs
# from float32 (the kernel adds less than bfloat16 itself), and within the
# 0.05 gate; the first step within rtol 5e-3 (measured 6.1e-4, NVIDIA H100
# 80GB HBM3, 700.00 W). Ranks are reported, not gated: at random weights
# every candidate scores near every other (MRR ~0.01), so the bfloat16
# roundings alone reorder most lists (measured: 16% of the ranks equal
# kernel vs plain, max |d| 19), as they reorder the float32 ones.
BF16_MEDIAN_REL = 0.05
BF16_FIRST_STEP_RTOL = 5e-3
GAN_TURN_EPOCHS = 3


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 2: kernels vs plain -------------------------------------------------


def serving_mask(B: int, N: int, n_text: int, gen, mostly_pad: bool) -> torch.Tensor:
    """[B, N] float32, 1.0 = PAD, over [cls | non-text | text]: the last
    n_text tokens hold a description of 5-20 words (entity text) or 12
    words (relation descriptions), PAD after it."""
    pad = torch.zeros(B, N)
    lengths = (torch.full((B,), 13) if mostly_pad
               else torch.randint(5, 21, (B,), generator=gen))
    first_text = N - n_text
    for b in range(B):
        pad[b, first_text + int(lengths[b]):] = 1.0
    return pad


def attention_case(name, B, H, N, hd, dtype, mask_kind, gen, timed=False, n_text=None):
    """``n_text``: the text tokens at the end of an entity sequence (default
    min(64, N − 1))."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(B, H, N, hd, generator=gen).to(dev, dtype) for _ in range(3))
    if mask_kind in ("entity", "all_pad_row"):
        pad = serving_mask(B, N, n_text or min(64, N - 1), gen, mostly_pad=False)
        if mask_kind == "all_pad_row":
            pad[0] = 1.0
        pad = pad.to(dev)
    elif mask_kind == "masked_text":       # masked encoder: 16 kept text tokens
        pad = serving_mask(B, N, 16, gen, mostly_pad=False).clamp(max=1.0).to(dev)
    elif mask_kind == "relation":
        pad = serving_mask(B, N, N - 1, gen, mostly_pad=True).to(dev)
    else:
        pad = None
    scale = hd ** -0.5
    out = attention.attention_fwd_cuda(q, k, v, pad, scale)
    torch.cuda.synchronize()
    ref = attention.attention_reference(q, k, v, pad, scale)
    err = float((out.float() - ref.float()).abs().max())
    ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype]
    rec = dict(case=name, B=B, H=H, N=N, hd=hd, dtype=str(dtype).split(".")[-1],
               mask=mask_kind, max_abs_err=err, tol=TOL[dtype], ok=ok)
    if timed:
        keep = None if pad is None else (pad <= 0)[:, None, None, :]
        rec["ms"] = time_ms(lambda: attention.attention_fwd_cuda(q, k, v, pad, scale))
        rec["plain_ms"] = time_ms(lambda: attention.attention_reference(q, k, v, pad, scale))
        rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, scale=scale))
        flops = 4.0 * B * H * N * N * hd
        nbytes = 4 * B * H * N * hd * q.element_size() + (0 if pad is None else B * N * 4)
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        rec["bound_ms"] = max(t_ops, t_bytes)
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    log(f"[kernel] {name:<22} {rec['dtype']:<8} B{B} H{H} N{N} hd{hd} mask={mask_kind:<8} "
        f"max|d|={err:.3e} (tol {TOL[dtype]:g})"
        + (f"  kernel {rec['ms']:.3f} ms  plain {rec['plain_ms']:.3f} ms  "
           f"sdpa {rec['library_ms']:.3f} ms  bound {rec['bound_ms']:.3f} ms "
           f"({rec['bound_by']}, share {rec['share_of_bound']:.3f})" if timed else ""))
    if not ok:
        raise AssertionError(f"attention_fwd disagrees with its plain version: {rec}")
    return rec


def phase_kernels():
    gen = torch.Generator().manual_seed(0)
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        # head_dim 64: _attention_kernel (serving shapes, then training)
        recs.append(attention_case("entity", 512, 6, 321, 64, dtype, "entity", gen, timed=True))
        recs.append(attention_case("relation", 64, 6, 321, 64, dtype, "relation", gen, timed=True))
        recs.append(attention_case("generate", 20, 6, 321, 64, dtype, "relation", gen, timed=True))
        # the ZSL GAN's generator: 256 rows × 2 relations of descriptions
        recs.append(attention_case("gan", 512, 6, 321, 64, dtype, "relation", gen, timed=True))
        recs.append(attention_case("no_mask", 64, 6, 321, 64, dtype, "none", gen))
        recs.append(attention_case("huge_hd80", 64, 16, 321, 80, dtype, "entity", gen, timed=True))
        recs.append(attention_case("ragged_n37", 3, 6, 37, 64, dtype, "entity", gen))
        recs.append(attention_case("train_nodes", 60, 6, 321, 64, dtype, "entity", gen,
                                   timed=True))
        recs.append(attention_case("train_edges", 48, 6, 321, 64, dtype, "relation", gen,
                                   timed=True))
        recs.append(attention_case("masked_encoder", 60, 6, 81, 64, dtype, "masked_text", gen,
                                   timed=True))
        # head_dim 32: _attention_kernel_packed (the decoder, 16 heads of 32)
        recs.append(attention_case("decoder", 60, 16, 321, 32, dtype, "entity", gen,
                                   timed=True))
        recs.append(attention_case("decoder_ragged_n37", 3, 16, 37, 32, dtype, "entity", gen))
        recs.append(attention_case("decoder_n1", 3, 16, 1, 32, dtype, "none", gen))
        recs.append(attention_case("decoder_all_pad_row", 4, 16, 321, 32, dtype,
                                   "all_pad_row", gen))
        recs.append(attention_case("decoder_no_mask", 8, 16, 321, 32, dtype, "none", gen))
    # the learnability path (phase 10; tiny4: 6 heads of 64, the decoder 16
    # of 32) at its short sequences, from a generator of its own so the cases
    # above keep their inputs: [cls | 8 kept patches | 8 kept text] = 17 in
    # the masked encoder, [cls | 16] = 17 for the descriptions (the edges of
    # a step, the GAN's 64 rows × 3 relations), [cls | 16 patches | 16 text]
    # = 33 in the entity sweep, the unmasked encoder and the decoder. At N 17
    # one key tile is mostly past N.
    gen = torch.Generator().manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        recs.append(attention_case("learn_masked_n17", 40, 6, 17, 64, dtype, "entity", gen,
                                   timed=True, n_text=8))
        recs.append(attention_case("learn_edges_n17", 32, 6, 17, 64, dtype, "relation", gen,
                                   timed=True))
        recs.append(attention_case("learn_gan_n17", 192, 6, 17, 64, dtype, "relation", gen,
                                   timed=True))
        recs.append(attention_case("learn_sweep_n33", 64, 6, 33, 64, dtype, "entity", gen,
                                   timed=True, n_text=16))
        recs.append(attention_case("learn_all_pad_row_n17", 4, 6, 17, 64, dtype, "all_pad_row",
                                   gen, n_text=8))
        recs.append(attention_case("learn_decoder_n33", 40, 16, 33, 32, dtype, "entity", gen,
                                   timed=True, n_text=16))
    return recs


# -- phase 3: the serving slice ------------------------------------------------


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


ATTENTION_BWD = "autograd::engine::evaluate_function: FusedAttentionBackward"
GEMM = re.compile(r"gemm|gemv|splitKreduce", re.IGNORECASE)    # cuBLAS kernel names


def profile_run(fn, tag: str, spans: tuple = (), patterns: dict | None = None) -> dict:
    """One kernel-path run of ``fn`` under torch.profiler: wall time, device
    busy time (the sum over device-side events: kernels, copies, sets; CPU
    ops that only launch them, and the device rows of ``record_function``
    spans, are left out so nothing counts twice), idle share, the attention
    forward kernels' and the cuBLAS GEMMs' time and share, the device time
    of the attention backward (the plain recompute that autograd runs under
    the FusedAttentionBackward node), the device time of the kernels
    launched inside each named ``record_function`` span of ``spans``, the
    device time of the events whose names match each regex of ``patterns``,
    and the top device events by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Activity Buffer")]      # profiler's own
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    busy = max(busy_ms, 1e-9)
    bwd_ms = sum(e.device_time_total / 1e3 for e in events if e.key == ATTENTION_BWD)
    attn_ms = sum(r[1] for r in rows if "attention_fwd" in r[0])
    gemm_ms = sum(r[1] for r in rows if GEMM.search(r[0]))
    span_ms = {s: sum(e.device_time_total / 1e3 for e in events
                      if e.key == s and e.device_type == DeviceType.CPU) for s in spans}
    pattern_ms = {name: sum(r[1] for r in rows if rx.search(r[0]))
                  for name, rx in (patterns or {}).items()}
    out = dict(pattern_ms=pattern_ms,
               pattern_share={name: ms / busy for name, ms in pattern_ms.items()},
               wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=1.0 - busy_ms / wall_ms,
               attention_ms=attn_ms, attention_share=attn_ms / busy,
               gemm_ms=gemm_ms, gemm_share=gemm_ms / busy,
               attention_bwd_ms=bwd_ms, attention_bwd_share=bwd_ms / busy,
               span_ms=span_ms, span_share={s: ms / busy for s, ms in span_ms.items()},
               top=[dict(op=k[:80], ms=ms, count=c) for k, ms, c in rows[:12]])
    log(f"[{tag}] wall {wall_ms:.1f} ms  device busy {busy_ms:.1f} ms  idle share "
        f"{out['device_idle_share']:.3f}  attention_fwd {attn_ms:.1f} ms "
        f"({out['attention_share']:.3f} of busy)  GEMMs {gemm_ms:.1f} ms "
        f"({out['gemm_share']:.3f})  attention backward {bwd_ms:.1f} ms "
        f"({out['attention_bwd_share']:.3f})"
        + "".join(f"  inside {s} {ms:.1f} ms ({out['span_share'][s]:.3f})"
                  for s, ms in span_ms.items())
        + "".join(f"  {n} {ms:.2f} ms ({out['pattern_share'][n]:.3f})"
                  for n, ms in pattern_ms.items()))
    for r in out["top"]:
        log(f"[{tag}]   {r['ms']:10.2f} ms  x{r['count']:<5} {r['op']}")
    return out


reset_launches = attention.reset_launches


def rank_agreement(a, b):
    """(share of equal ranks, largest rank difference) of two rank arrays."""
    if a.shape != b.shape:
        raise AssertionError(f"rank arrays of shapes {a.shape} and {b.shape}")
    return float(np.mean(a == b)), int(np.abs(a - b).max())


def phase_slice(data_dir: str, cfg: dict = SLICE, device=None):
    """The serving round on a kernel-path and a same-seed plain trainer.
    Returns (info, served): ``served`` holds the fixture, both trainers and
    the kernel run's embeddings, for phase 5."""
    t = {}
    t0 = time.perf_counter()
    write_zsl_dataset(data_dir, n_ent=cfg["n_ent"], n_rel=cfg["n_rel"],
                      n_unseen=cfg["n_unseen"], triples_per_rel=cfg["triples_per_rel"],
                      n_candidates=cfg["n_candidates"], image_size=cfg["image_px"], seed=0)
    data = load_zsl_dataset(data_dir, mode="train")
    store = MultimodalStore(data["mm_info"], data["rel_des"],
                            MultimodalPipelineConfig(image_size=cfg["image_size"]))
    table = TripleTable.build(np.asarray(data["triples"]).T,
                              len(data["e2id"]), len(data["r2id"]))
    t["fixture_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()

    def trainer(impl):
        return FusionTrainer(table, store, FusionConfig(
            model_type=cfg["model_type"], emb_dim=200, noise_dim=15,
            patch_size=cfg["patch_size"], seed=192, attention_impl=impl), device=device)

    fusion, fusion_plain = trainer("auto"), trainer("torch")   # same seed, same weights
    zsl = ZSLModule(data_dir, data["r2id"], data["e2id"],
                    ZSLConfig(emb_dim=200, noise_dim=15, test_sample=20, max_neighbor=50),
                    device=device)
    sync()
    t["build_models_s"] = time.perf_counter() - t0

    def serve(fusion):
        times = {}
        t0 = time.perf_counter()
        ent = fusion.generate_ent_embeddings()
        sync()
        times["ent_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rel = fusion.generate_rel_embeddings()
        sync()
        times["rel_s"] = time.perf_counter() - t0
        zsl.update_embed(ent, rel)
        t0 = time.perf_counter()
        res = zsl.evaluate(fusion, verbose=False, eval_path="rel_shared", return_ranks=True)
        sync()
        times["eval_s"] = time.perf_counter() - t0
        return ent, rel, res, times

    reset_launches()
    ent, rel, res, times = serve(fusion)
    launches = dict(attention.LAUNCHES)
    t.update(times)
    # the serving path runs the encoder only: no decoder, no head_dim 32;
    # on the CPU (a rehearsal) the wrappers take the plain version
    on_card = fusion.device.type == "cuda"
    expect = {"attention_fwd": on_card * cfg["depth"] * (math.ceil(cfg["n_ent"] / 512)
                                                         + math.ceil(cfg["n_rel"] / 64)
                                                         + cfg["n_unseen"]),
              "attention_fwd_packed": 0}
    log(f"[slice] kernel run: {times}  launches {launches}  expected {expect}")
    log(f"[slice] metrics: hits10 {res['hits10']:.4f} hits5 {res['hits5']:.4f} "
        f"hits1 {res['hits1']:.4f} mrr {res['mrr']:.6f} n {res['n']}")
    if launches != expect:
        raise AssertionError(f"attention kernels launched {launches} times on the "
                             f"serving path, expected {expect}")
    if ent.shape != (cfg["n_ent"], 200) or rel.shape != (cfg["n_rel"], 200):
        raise AssertionError(f"embedding shapes {tuple(ent.shape)}, {tuple(rel.shape)}")
    if not (torch.isfinite(ent).all() and torch.isfinite(rel).all()):
        raise AssertionError("non-finite embeddings")
    if res["n"] == 0 or not np.isfinite(res["mrr"]):
        raise AssertionError(f"bad evaluation result: {res}")

    # the same round through the plain attention, as the reference
    reset_launches()
    ent_p, rel_p, res_p, times_p = serve(fusion_plain)
    if any(attention.LAUNCHES.values()):
        raise AssertionError(f"attention_impl='torch' still launched the kernel: "
                             f"{attention.LAUNCHES}")
    d_ent = float((ent - ent_p).abs().max())
    d_rel = float((rel - rel_p).abs().max())
    d_mrr = abs(res["mrr"] - res_p["mrr"])
    rank_agree = float(np.mean(res["ranks"] == res_p["ranks"]))
    log(f"[slice] plain run: {times_p}  mrr {res_p['mrr']:.6f}")
    log(f"[slice] kernel vs plain: max|d| ent {d_ent:.3e} rel {d_rel:.3e} "
        f"|d mrr| {d_mrr:.3e} ranks equal {rank_agree:.4f}")
    # float32 through 12 blocks; the online softmax sums in another order than
    # the plain softmax
    if d_ent > 1e-3 or d_rel > 1e-3 or d_mrr > 1e-3:
        raise AssertionError(f"kernel path disagrees with the plain path: "
                             f"ent {d_ent} rel {d_rel} mrr {d_mrr}")
    info = dict(times=t, times_plain=times_p, launches=launches, expected=expect,
                metrics={k: res[k] for k in ("hits10", "hits5", "hits1", "mrr", "n")},
                mrr_plain=res_p["mrr"], max_abs_ent=d_ent, max_abs_rel=d_rel,
                rank_agreement=rank_agree,
                profile=profile_run(lambda: serve(fusion), "profile") if on_card else None)
    served = dict(data_dir=data_dir, data=data, fusion=fusion, fusion_plain=fusion_plain,
                  ent=ent, rel=rel, ranks=res["ranks"])
    return info, served


# -- phase 4: the training step --------------------------------------------------


@contextlib.contextmanager
def first_steps(tr, steps: int):
    """The trainer's epochs cut to the first ``steps`` batches of its own
    sampler inside the block."""
    sampler = tr.sampler
    tr.sampler = list(itertools.islice(iter(sampler), steps))
    try:
        yield
    finally:
        tr.sampler = sampler


def profile_steps(tr, tag):
    """A few steps of an epoch (producer thread included) under the
    profiler."""
    with first_steps(tr, PROFILE_STEPS):
        return dict(profile_run(tr.train_epoch, tag), steps=PROFILE_STEPS)


def phase_train(data_dir: str, cfg: dict = TRAIN, device=None):
    """One epoch of the fusion step on a kernel-path trainer and on a
    same-seed plain-attention trainer; the launch counts, the loss terms and
    the two runs' agreement are checked, then a few steps are profiled.
    Returns (info, trained): ``trained`` holds the fixture and the kernel
    trainer, for phase 7."""
    t = {}
    t0 = time.perf_counter()
    write_zsl_dataset(data_dir, n_ent=cfg["n_ent"], n_rel=cfg["n_rel"],
                      n_unseen=cfg["n_unseen"], triples_per_rel=cfg["triples_per_rel"],
                      image_size=cfg["image_px"], seed=1)
    data = load_zsl_dataset(data_dir, mode="train")
    table = TripleTable.build(np.asarray(data["triples"]).T,
                              len(data["e2id"]), len(data["r2id"]))
    t["fixture_s"] = time.perf_counter() - t0

    def trainer(impl):
        # a store each: training images draw from the store's own generator
        store = MultimodalStore(data["mm_info"], data["rel_des"], MultimodalPipelineConfig(
            image_size=cfg["image_size"], **cfg.get("pipe", {})))
        return FusionTrainer(table, store, FusionConfig(
            model_type=cfg["model_type"], patch_size=cfg["patch_size"], seed=192,
            attention_impl=impl, **cfg.get("fusion", {})), device=device)

    t0 = time.perf_counter()
    kern, plain = trainer("auto"), trainer("torch")
    sync()
    t["build_models_s"] = time.perf_counter() - t0
    m3ae = kern.model.M3AEmodel.cfg
    on_card = kern.device.type == "cuda"
    # per step: the representation, the relation descriptions and the masked
    # encoder at head_dim 64, the decoder at head_dim 32
    per_step = {"attention_fwd": 3 * m3ae.depth, "attention_fwd_packed": m3ae.dec_depth}

    def epoch(tr):
        infos = []
        reset_launches()
        t0 = time.perf_counter()
        mean = tr.train_epoch(on_step=infos.append)
        sync()
        secs = time.perf_counter() - t0
        steps = [{k: float(v) for k, v in info.items()} for info in infos]
        return mean, steps, secs, dict(attention.LAUNCHES)

    mean_k, steps_k, t["epoch_s"], launches = epoch(kern)
    n = len(steps_k)
    expect = {k: on_card * n * c for k, c in per_step.items()}
    log(f"[train] kernel epoch: {n} steps in {t['epoch_s']:.2f} s "
        f"({t['epoch_s'] / max(n, 1) * 1e3:.1f} ms/step)  launches {launches}  "
        f"expected {expect} ({per_step} per step)")
    if n != kern.steps_per_epoch or n == 0:
        raise AssertionError(f"{n} steps, expected {kern.steps_per_epoch}")
    if launches != expect:
        raise AssertionError(f"attention kernels launched {launches} times in "
                             f"{n} training steps, expected {expect}")
    mean_p, steps_p, t["epoch_plain_s"], launches_p = epoch(plain)
    log(f"[train] plain epoch: {len(steps_p)} steps in {t['epoch_plain_s']:.2f} s  "
        f"launches {launches_p}")
    if any(launches_p.values()):
        raise AssertionError(f"attention_impl='torch' launched the kernel: {launches_p}")
    if len(steps_p) != n:
        raise AssertionError(f"plain epoch ran {len(steps_p)} steps, kernel epoch {n}")

    def rel_err(a, b):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) if a[k] != b[k] else 0.0
                   for k in INFO_KEYS)

    first = rel_err(steps_k[0], steps_p[0])
    epoch_err = {k: abs(mean_k[k] - mean_p[k]) for k in INFO_KEYS}
    log(f"[train] first step, kernel: " + "  ".join(f"{k} {steps_k[0][k]:.6f}" for k in INFO_KEYS))
    log(f"[train] first step, plain:  " + "  ".join(f"{k} {steps_p[0][k]:.6f}" for k in INFO_KEYS))
    log(f"[train] epoch mean, kernel: " + "  ".join(f"{k} {mean_k[k]:.6f}" for k in INFO_KEYS))
    log(f"[train] epoch mean, plain:  " + "  ".join(f"{k} {mean_p[k]:.6f}" for k in INFO_KEYS))
    log(f"[train] kernel vs plain: first step max rel {first:.3e} (tol {FIRST_STEP_RTOL:g}); "
        f"epoch means max |d| {max(epoch_err.values()):.3e} "
        f"(tol {EPOCH_RTOL:g} rel + {EPOCH_ATOL:g})")
    if first > FIRST_STEP_RTOL:
        raise AssertionError(f"first training step disagrees: max rel {first}")
    far = {k: d for k, d in epoch_err.items() if d > EPOCH_RTOL * abs(mean_p[k]) + EPOCH_ATOL}
    if far:
        raise AssertionError(f"epoch means disagree: {far}")

    # step times in turns (kernel, plain, plain, kernel): a second window of
    # TURN_STEPS steps of each, in the reverse order, so neither path gains
    # from running second
    with first_steps(plain, TURN_STEPS):
        _, steps_p2, t["epoch2_plain_s"], launches_p2 = epoch(plain)
    with first_steps(kern, TURN_STEPS):
        _, steps_k2, t["epoch2_s"], launches_k2 = epoch(kern)
    n2 = len(steps_k2)
    expect2 = {k: on_card * n2 * c for k, c in per_step.items()}
    if launches_k2 != expect2 or any(launches_p2.values()) or len(steps_p2) != n2:
        raise AssertionError(f"second windows launched {launches_k2} (kernel) and "
                             f"{launches_p2} (plain), expected {expect2} and none")
    bad = [(i, k) for i, s in enumerate(steps_k + steps_p + steps_p2 + steps_k2)
           for k, v in s.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite loss terms (step, term): {bad[:8]}")
    step_ms = {"kernel": (t["epoch_s"] + t["epoch2_s"]) / (n + n2) * 1e3,
               "plain": (t["epoch_plain_s"] + t["epoch2_plain_s"]) / (n + n2) * 1e3}
    log(f"[train] step wall time in turns (kernel {t['epoch_s']:.2f} s / {n} steps, plain "
        f"{t['epoch_plain_s']:.2f} s / {n}, plain {t['epoch2_plain_s']:.2f} s / {n2}, kernel "
        f"{t['epoch2_s']:.2f} s / {n2}): kernel {step_ms['kernel']:.1f} ms/step, "
        f"plain {step_ms['plain']:.1f} ms/step")

    prof = None
    if on_card:
        prof = {"kernel": profile_steps(kern, "train-profile"),
                "plain": profile_steps(plain, "train-profile-plain")}
    info = dict(times=t, steps=n, step_ms=step_ms, launches=launches,
                launches_per_step=per_step,
                info_first_kernel=steps_k[0], info_first_plain=steps_p[0],
                info_mean_kernel=mean_k, info_mean_plain=mean_p,
                first_step_max_rel=first, epoch_max_abs=epoch_err, profile=prof)
    return info, dict(data=data, table=table, fusion=kern)


# -- phase 5: the ZSL round ------------------------------------------------------


@contextlib.contextmanager
def plain_attention(trainer):
    """The trainer's attention modules on the plain path inside the block."""
    mods = [m for m in trainer.model.modules() if hasattr(m, "attention_impl")]
    impls = [m.attention_impl for m in mods]
    for m in mods:
        m.attention_impl = "torch"
    try:
        yield
    finally:
        for m, impl in zip(mods, impls):
            m.attention_impl = impl


def phase_zsl(served: dict, cfg: dict = ZSL_ROUND, card: str = "no card") -> dict:
    """Extractor pretraining, the centroids, the WGAN-GP loop and the three
    eval paths on the serving fixture, on a kernel-path ZSL module and on a
    same-seed one over the plain-attention trainer; launch counts, the two
    runs' agreement and the MRRs are checked, the loop is timed in turns
    and profiled."""
    fusion, fusion_plain = served["fusion"], served["fusion_plain"]
    data, data_dir = served["data"], served["data_dir"]
    zcfg = ZSLConfig(**cfg.get("zsl", {}))
    P, T = cfg["pretrain_steps"], cfg["train_times"]
    depth = fusion.model.M3AEmodel.cfg.depth
    on_card = fusion.device.type == "cuda"
    n_unseen = len(load_candidates(data_dir, "test"))
    none = {k: 0 for k in attention.LAUNCHES}
    gan_expect = dict(none, attention_fwd=on_card * T * (zcfg.D_epoch + zcfg.G_epoch) * depth)
    eval_expect = dict(none, attention_fwd=on_card * depth * n_unseen)

    def module():
        z = ZSLModule(data_dir, data["r2id"], data["e2id"], zcfg, device=fusion.device)
        z.update_embed(served["ent"], served["rel"])
        return z

    def timed(fn):
        reset_launches()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3, dict(attention.LAUNCHES)

    def train(z, fus):
        r = {}
        _, ms, r["launches_pretrain"] = timed(lambda: z.pretrain_extractor(steps=P, log_every=P))
        r["pretrain_step_ms"] = ms / P
        _, r["centroids_ms"], r["launches_centroids"] = timed(z.compute_centroids)
        # the D/G loop alone, on the centroids just computed
        (r["d_hist"], r["g_hist"]), ms, r["launches_gan"] = timed(
            lambda: z.train_gan(fus, train_times=T, log_every=T, skip_pretrain=True,
                                skip_centroids=True))
        r["gan_epoch_ms"] = ms / T
        return r

    def evaluate(z, fus):
        out = {}
        for path in EVAL_PATHS:
            res, ms, launches = timed(lambda: z.evaluate(fus, verbose=False, eval_path=path,
                                                         return_ranks=True))
            out[path] = dict(mrr=res["mrr"], n=res["n"], ms=ms, launches=launches,
                             ranks=res["ranks"])
        return out

    def check_launches(r, ev, gan, evl, what):
        got = dict(pretrain=r["launches_pretrain"], centroids=r["launches_centroids"],
                   train_gan=r["launches_gan"], **{p: e["launches"] for p, e in ev.items()})
        want = dict(pretrain=none, centroids=none, train_gan=gan, **{p: evl for p in ev})
        log(f"[zsl] {what} launches {got}")
        if got != want:
            raise AssertionError(f"{what}: attention launches {got}, expected {want}")

    zk, zp = module(), module()
    run_k = train(zk, fusion)
    ev_k = evaluate(zk, fusion)
    check_launches(run_k, ev_k, gan_expect, eval_expect, "kernel run")
    run_p = train(zp, fusion_plain)
    ev_p = evaluate(zp, fusion_plain)
    check_launches(run_p, ev_p, none, none, "plain run")

    bad = [(i, k) for h in ("d_hist", "g_hist") for r in (run_k, run_p)
           for i, step in enumerate(r[h]) for k, v in step.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite GAN history terms (epoch, term): {bad[:8]}")
    first = {h: max(abs(run_k[h][0][k] - run_p[h][0][k]) / max(abs(run_p[h][0][k]), 1e-12)
                    for k in run_p[h][0]) for h in ("d_hist", "g_hist")}
    for h in ("d_hist", "g_hist"):
        log(f"[zsl] first epoch {h[0].upper()}, kernel: "
            + "  ".join(f"{k} {v:.6f}" for k, v in run_k[h][0].items()))
        log(f"[zsl] first epoch {h[0].upper()}, plain:  "
            + "  ".join(f"{k} {v:.6f}" for k, v in run_p[h][0].items()))
    log(f"[zsl] first epoch kernel vs plain: max rel D {first['d_hist']:.3e}, "
        f"G {first['g_hist']:.3e} (tol {FIRST_EPOCH_RTOL:g})")
    if max(first.values()) > FIRST_EPOCH_RTOL:
        raise AssertionError(f"first GAN epoch disagrees between the paths: {first}")
    mrr = {p: (ev_k[p]["mrr"], ev_p[p]["mrr"]) for p in EVAL_PATHS}
    log(f"[zsl] MRR kernel / plain: " + "  ".join(f"{p} {a:.6f} / {b:.6f}"
                                                   for p, (a, b) in mrr.items()))
    if any(ev_k[p]["n"] == 0 for p in EVAL_PATHS):
        raise AssertionError(f"an eval path ranked nothing: {ev_k}")
    spread = max(a for a, _ in mrr.values()) - min(a for a, _ in mrr.values())
    d_plain = max(abs(a - b) for a, b in mrr.values())
    if d_plain > MRR_ATOL or spread > MRR_ATOL:
        raise AssertionError(f"MRRs disagree: kernel vs plain {d_plain}, across paths {spread}")

    # the kernel run's trained module (its Extractor, and the generator
    # head that train_gan trained in place in ``fusion``) ranks the same
    # queries through the kernel and through the plain attention on each
    # path, and each path against factored within each run. The separately
    # trained plain run's ranks are reported beside them, its MRR gated
    # above: ten GAN epochs of adam carry the two attentions' float32
    # differences far enough apart to move near-ties (395 of 399 equal on
    # some cards)
    with plain_attention(fusion):
        ev_kp = evaluate(zk, fusion)
    if any(e["launches"] != none for e in ev_kp.values()):
        raise AssertionError(f"the plain attention launched {ev_kp}")
    agree = {f"{p} kernel vs plain": rank_agreement(ev_k[p]["ranks"], ev_kp[p]["ranks"])
             for p in EVAL_PATHS}
    agree.update({f"{p} vs factored ({name})": rank_agreement(ev[p]["ranks"],
                                                              ev["factored"]["ranks"])
                  for name, ev in (("kernel", ev_k), ("plain", ev_p))
                  for p in ("rel_shared", "head_shared")})
    apart = {p: rank_agreement(ev_k[p]["ranks"], ev_p[p]["ranks"]) for p in EVAL_PATHS}
    log("[zsl] ranks equal / max |d rank|: "
        + "  ".join(f"{k} {eq:.4f} / {d}" for k, (eq, d) in agree.items()))
    log("[zsl] ranks of the separately trained plain run: "
        + "  ".join(f"{p} {eq:.4f} / {d}" for p, (eq, d) in apart.items()))
    off = {k: v for k, v in agree.items() if v[0] < RANK_EQUAL_MIN or v[1] > RANK_MAX_DIFF}
    if off:
        raise AssertionError(f"ranks disagree (share equal < {RANK_EQUAL_MIN} or a rank "
                             f"moved by more than {RANK_MAX_DIFF}): {off}")

    # times in turns (kernel, plain, plain, kernel): a second round of each
    run_p2 = train(zp, fusion_plain)
    run_k2 = train(zk, fusion)
    if run_k2["launches_gan"] != gan_expect or any(run_p2["launches_gan"].values()):
        raise AssertionError(f"second rounds launched {run_k2['launches_gan']} (kernel) and "
                             f"{run_p2['launches_gan']} (plain)")
    times = {name: {"pretrain_step_ms": [r["pretrain_step_ms"] for r in runs],
                    "gan_epoch_ms": [r["gan_epoch_ms"] for r in runs]}
             for name, runs in (("kernel", (run_k, run_k2)), ("plain", (run_p, run_p2)))}
    for name, tm in times.items():
        log(f"[zsl] {name}: ms per pretrain step {tm['pretrain_step_ms'][0]:.2f} / "
            f"{tm['pretrain_step_ms'][1]:.2f}, ms per GAN epoch {tm['gan_epoch_ms'][0]:.1f} / "
            f"{tm['gan_epoch_ms'][1]:.1f} (first / second round; {card})")

    prof = None
    if on_card:
        E = cfg["profile_epochs"]
        prof = dict(profile_run(lambda: zk.train_gan(fusion, train_times=E, log_every=E,
                                                     skip_pretrain=True, skip_centroids=True),
                                "zsl-profile", spans=("zsl.generate",)), epochs=E)
        log(f"[zsl-profile] {E} GAN epochs: device busy {prof['device_busy_ms']:.1f} ms, "
            f"idle share {prof['device_idle_share']:.3f}, attention "
            f"{prof['attention_share']:.3f}, float32 GEMMs {prof['gemm_share']:.3f}, "
            f"inside generate {prof['span_share']['zsl.generate']:.3f} of busy ({card})")
    strip = ("d_hist", "g_hist")
    return dict(launches=run_k["launches_gan"], expected_gan=gan_expect,
                expected_eval=eval_expect, times=times,
                centroids_ms=[run_k["centroids_ms"], run_p["centroids_ms"]],
                first_epoch={"kernel": {h: run_k[h][0] for h in strip},
                             "plain": {h: run_p[h][0] for h in strip}},
                first_epoch_max_rel=first,
                last_epoch={h: run_k[h][-1] for h in strip},
                mrr=mrr, rank_agreement=agree, rank_agreement_trained_apart=apart,
                eval_ms={p: (ev_k[p]["ms"], ev_p[p]["ms"]) for p in EVAL_PATHS},
                profile=prof, card=card)


# -- phase 6: the CLI -------------------------------------------------------------


@contextlib.contextmanager
def wrapped(owner, name, wrap):
    """``owner.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def timed_calls(records: list, what: str, size_of=None):
    """A wrapper factory: each call appends (what, seconds, bytes) to
    ``records``; ``size_of(args)`` gives the bytes (a checkpoint's file)."""
    def wrap(fn):
        def call(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            records.append(dict(what=what, s=time.perf_counter() - t0,
                                bytes=size_of(a) if size_of else None))
            return out
        return call
    return wrap


def phase_cli(work_dir: str, cfg: dict = CLI, card: str = "no card") -> dict:
    """The CLI's train mode, resume and evaluate mode (a subprocess) in
    ``work_dir``; launch counts, files, bitwise resume and the evaluate
    dump against a plain-attention trainer are checked."""
    os.makedirs(work_dir, exist_ok=True)
    old_cwd = os.getcwd()
    os.chdir(work_dir)
    try:
        return _phase_cli(cfg, card)
    finally:
        os.chdir(old_cwd)


def _phase_cli(cfg: dict, card: str) -> dict:
    ds = "cli"
    write_zsl_dataset(os.path.join("data", ds), n_ent=cfg["n_ent"], n_rel=cfg["n_rel"],
                      n_unseen=cfg["n_unseen"], triples_per_rel=cfg["triples_per_rel"],
                      n_candidates=cfg["n_candidates"], image_size=cfg["image_px"], seed=1)
    base = ["--dataset", ds, "--data_root", "data", "--output_dir", "runs", *cfg["flags"]]
    stages, built = [], []

    def file_size(a):              # a checkpoint call's path, after the call
        return os.path.getsize(a[0])

    def keep_built(fn):
        def call(args):
            out = fn(args)
            built.append(dict(fusion=out[3], params=out[3].params_tree(),
                              n_unseen=len(load_candidates(
                                  os.path.join(args.data_root, args.dataset), "test"))))
            return out
        return call

    def run_main(argv):
        with contextlib.ExitStack() as stack:
            stack.enter_context(wrapped(cli, "build_pipeline", keep_built))
            stack.enter_context(wrapped(ckpt, "save_checkpoint", timed_calls(
                stages, "checkpoint_save", file_size)))
            stack.enter_context(wrapped(ckpt, "load_checkpoint", timed_calls(
                stages, "checkpoint_load", file_size)))
            stack.enter_context(wrapped(cli, "run_zsl_round", timed_calls(stages, "zsl_round")))
            stack.enter_context(wrapped(FusionTrainer, "train_epoch", timed_calls(
                stages, "epoch")))
            reset_launches()
            t0 = time.perf_counter()
            cli.main(read_options(argv))
            sync()
            return time.perf_counter() - t0, dict(attention.LAUNCHES)

    # train mode: two epochs, checkpoint + ZSL round at epoch 2, epoch 1 traced
    train_s, launches = run_main(base + ["--epochs", "2", "--save_epochs", "2",
                                         "--profile_dir", "prof"])
    fusion = built[0]["fusion"]
    on_card = fusion.device.type == "cuda"
    m3ae = fusion.model.M3AEmodel.cfg
    steps = fusion.steps_per_epoch
    zcfg = cli.zsl_config(read_options(base))
    sweeps = math.ceil(cfg["n_ent"] / 512) + math.ceil(cfg["n_rel"] / 64)
    expect = {"attention_fwd": on_card * m3ae.depth * (
                  2 * steps * 3 + sweeps + zcfg.train_times * (zcfg.D_epoch + zcfg.G_epoch)
                  + built[0]["n_unseen"]),
              "attention_fwd_packed": on_card * 2 * steps * m3ae.dec_depth}
    epochs = [r["s"] for r in stages if r["what"] == "epoch"]
    log(f"[cli] train mode: {train_s:.1f} s, {steps} steps per epoch, epoch {epochs[0]:.2f} s "
        f"(traced) and {epochs[1]:.2f} s; launches {launches} expected {expect}")
    if launches != expect:
        raise AssertionError(f"the CLI's train mode launched {launches}, expected {expect}")
    want = [f"saved_models/{ds}/{f}{ext}" for f in (f"epoch2_{CLI_NAME}.ckpt",
                                                    f"{CLI_NAME}.ckpt")
            for ext in ("", ".meta.json")]
    want += [f"data/{ds}/Embed_used/{f}{ext}" for f in ("Extractor", "Discriminator",
                                                        "Generator")
             for ext in ("", ".meta.json")]
    missing = [f for f in want if not os.path.isfile(f)]
    if missing:
        raise AssertionError(f"train mode did not write {missing}")
    (metrics,) = os.listdir("runs")
    with open(os.path.join("runs", metrics)) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "loss" in r]
    mrr = [r["zsl_mrr"] for r in records if "zsl_mrr" in r]
    if len(losses) != 2 or len(mrr) != 1 or not all(map(math.isfinite, losses + mrr)):
        raise AssertionError(f"metrics records: loss {losses}, zsl_mrr {mrr}")
    (trace_file,) = os.listdir("prof")
    trace_bytes = os.path.getsize(os.path.join("prof", trace_file))
    with open(os.path.join("prof", trace_file)) as f:
        traced = "attention_fwd_kernel" in f.read()
    log(f"[cli] files {len(want)} present; loss {losses} zsl_mrr {mrr[0]:.6f}; trace "
        f"{trace_bytes} bytes, attention_fwd_kernel in it: {traced}")
    if on_card and not traced:
        raise AssertionError("the profiled epoch's trace has no attention_fwd_kernel")

    # resume: parameters only, bit for bit, then one epoch
    built.clear()
    resume_s, launches_resume = run_main(base + ["--resume", "--epochs", "1",
                                                 "--start_epoch", "2", "--save_epochs", "2"])
    saved = torch.load(f"saved_models/{ds}/epoch2_{CLI_NAME}.ckpt", weights_only=True)
    resumed = built[0]["params"]

    def leaves(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}") if isinstance(v, dict)
                       else {f"{prefix}/{k}": v})
        return out

    got, ref = leaves(resumed), leaves(saved)
    differ = [k for k in ref if k not in got or not np.array_equal(got[k], ref[k].numpy())]
    log(f"[cli] resume: {resume_s:.1f} s, {len(ref)} leaves, {len(differ)} differ from the "
        f"epoch-2 checkpoint; launches {launches_resume}")
    if differ or set(got) != set(ref):
        raise AssertionError(f"--resume did not restore the epoch-2 parameters: {differ[:5]}")

    # evaluate mode, as a user starts it
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mre_tpu_torch.cli.main", *base, "--evaluate",
                           "--pretrained_model_name", CLI_NAME],
                          capture_output=True, text=True, env=env, timeout=900)
    evaluate_s = time.perf_counter() - t0
    final = [line for line in proc.stdout.splitlines() if line.startswith("[Final ZSL Scores]")]
    log(f"[cli] evaluate mode (subprocess): exit {proc.returncode} in {evaluate_s:.1f} s; "
        f"{final[0] if final else 'no [Final ZSL Scores] line'}")
    if proc.returncode != 0 or not final:
        raise AssertionError(f"evaluate mode failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join("runs", "temp_ent_embs.pkl"), "rb") as f:
        ent = np.asarray(pickle.load(f))
    args = read_options(base)
    plain = FusionTrainer(fusion.table, fusion.store, dataclasses.replace(
        cli.fusion_config(args), attention_impl="torch"), device=fusion.device)
    plain.load_params(ckpt.load_checkpoint(f"saved_models/{ds}/{CLI_NAME}.ckpt",
                                           plain.params_tree()))
    reset_launches()
    ent_plain = plain.generate_ent_embeddings().cpu().numpy()
    if any(attention.LAUNCHES.values()):
        raise AssertionError(f"the plain trainer launched {attention.LAUNCHES}")
    scale = float(np.abs(ent_plain).max())
    d_ent = float(np.abs(ent - ent_plain).max())
    log(f"[cli] evaluate dump vs plain trainer: max|d| {d_ent:.3e}, max|plain| {scale:.3e}, "
        f"relative {d_ent / scale:.3e} (tol {CLI_EMB_RTOL:g})")
    if ent.shape != ent_plain.shape or not d_ent <= CLI_EMB_RTOL * scale:
        raise AssertionError(f"evaluate-mode embeddings disagree with the plain path: "
                             f"{ent.shape} vs {ent_plain.shape}, max|d| {d_ent}")

    saves = [r for r in stages if r["what"] == "checkpoint_save"]
    loads = [r for r in stages if r["what"] == "checkpoint_load"]
    zsl_s = [r["s"] for r in stages if r["what"] == "zsl_round"]
    step_ms = epochs[1] / steps * 1e3
    log(f"[cli] stages ({card}): {step_ms:.1f} ms per step (untraced epoch; traced "
        f"{epochs[0] / steps * 1e3:.1f}); checkpoint saves "
        + ", ".join(f"{r['s']:.2f} s / {r['bytes']} B" for r in saves)
        + "; loads " + ", ".join(f"{r['s']:.2f} s / {r['bytes']} B" for r in loads)
        + f"; ZSL round {zsl_s[0]:.2f} s; evaluate entry {evaluate_s:.1f} s")
    return dict(launches=launches, expected=expect, steps_per_epoch=steps,
                epoch_s=epochs, step_ms=step_ms, train_s=train_s, resume_s=resume_s,
                evaluate_s=evaluate_s, zsl_round_s=zsl_s, checkpoint_saves=saves,
                checkpoint_loads=loads, trace_bytes=trace_bytes, metrics=records,
                final_line=final[0], emb_max_abs=d_ent, emb_scale=scale,
                launches_resume=launches_resume, card=card)


# -- phase 7: the options (bfloat16 compute, the image cache) ------------------------


def by_dtype() -> dict:
    """The launch counts split by the kernel's instantiation, non-zero only."""
    return {k: v for k, v in attention.LAUNCHES_BY_DTYPE.items() if v}


def median_rel(a, ref) -> float:
    a, ref = a.float().cpu(), ref.float().cpu()
    return float(((a - ref).abs() / (ref.abs() + 1e-3)).median())


class Gates:
    """The phase's checks: each failure is logged and kept, and ``close``
    raises them together, so one run prints every number first."""

    def __init__(self, tag: str):
        self.tag, self.failed = tag, []

    def check(self, ok: bool, what: str):
        if not ok:
            log(f"[{self.tag}] FAILED: {what}")
            self.failed.append(what)

    def close(self):
        if self.failed:
            raise AssertionError(f"{self.tag}: {self.failed}")


def phase_bf16_serving(served: dict, f32: dict, cfg: dict = SLICE, card: str = "no card"):
    """The serving round in bfloat16 on a kernel-path and a same-seed plain
    trainer (the float32 round's weights: one seed), then with the image
    cache on. Returns (info, bf16): ``bf16`` holds the kernel trainer and
    its embeddings, for the GAN epochs."""
    gates = Gates("bf16-serve")
    data, fusion32 = served["data"], served["fusion"]
    store = MultimodalStore(data["mm_info"], data["rel_des"],
                            MultimodalPipelineConfig(image_size=cfg["image_size"]))

    def trainer(impl):
        return FusionTrainer(fusion32.table, store, FusionConfig(
            model_type=cfg["model_type"], emb_dim=200, noise_dim=15,
            patch_size=cfg["patch_size"], seed=192, attention_impl=impl,
            compute_dtype="bfloat16"), device=fusion32.device)

    fusion, fusion_plain = trainer("auto"), trainer("torch")
    zsl = ZSLModule(served["data_dir"], data["r2id"], data["e2id"],
                    ZSLConfig(emb_dim=200, noise_dim=15, test_sample=20, max_neighbor=50),
                    device=fusion.device)

    def serve(fus):
        times = {}
        reset_launches()
        t0 = time.perf_counter()
        ent = fus.generate_ent_embeddings()
        sync()
        times["ent_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rel = fus.generate_rel_embeddings()
        sync()
        times["rel_s"] = time.perf_counter() - t0
        zsl.update_embed(ent, rel)
        t0 = time.perf_counter()
        res = zsl.evaluate(fus, verbose=False, eval_path="rel_shared", return_ranks=True,
                           compute_dtype="bfloat16")
        sync()
        times["eval_s"] = time.perf_counter() - t0
        return ent, rel, res, times, by_dtype()

    on_card = fusion.device.type == "cuda"
    expect = {"attention_fwd.bfloat16": cfg["depth"] * (
        math.ceil(cfg["n_ent"] / 512) + math.ceil(cfg["n_rel"] / 64) + cfg["n_unseen"])} \
        if on_card else {}
    ent, rel, res, times, launches = serve(fusion)
    ent_p, rel_p, res_p, times_p, launches_p = serve(fusion_plain)
    ranks = {"kernel vs plain": rank_agreement(res["ranks"], res_p["ranks"]),
             "plain vs float32": rank_agreement(res_p["ranks"], served["ranks"])}
    emb_rel = {"ent vs float32": median_rel(ent, served["ent"]),
               "rel vs float32": median_rel(rel, served["rel"]),
               "ent plain vs float32": median_rel(ent_p, served["ent"]),
               "rel plain vs float32": median_rel(rel_p, served["rel"]),
               "ent kernel vs plain": median_rel(ent, ent_p),
               "rel kernel vs plain": median_rel(rel, rel_p)}
    log(f"[bf16-serve] kernel round {times} launches {launches} expected {expect}; plain round "
        f"{times_p} launches {launches_p}")
    log(f"[bf16-serve] float32 round (phase 3): ent_s {f32['ent_s']:.3f} rel_s "
        f"{f32['rel_s']:.3f} eval_s {f32['eval_s']:.3f}; bfloat16: ent_s {times['ent_s']:.3f} "
        f"rel_s {times['rel_s']:.3f} eval_s {times['eval_s']:.3f} ({card})")
    log(f"[bf16-serve] mrr bf16 kernel {res['mrr']:.6f} plain {res_p['mrr']:.6f} float32 "
        f"{f32['mrr']:.6f}; ranks equal / max |d|: "
        + "  ".join(f"{k} {eq:.4f} / {d}" for k, (eq, d) in ranks.items()))
    log("[bf16-serve] embeddings, median relative error: "
        + "  ".join(f"{k} {v:.5f}" for k, v in emb_rel.items()))
    gates.check(launches == expect, f"kernel round launched {launches}, expected {expect}")
    gates.check(not launches_p, f"plain round launched {launches_p}")
    gates.check(max(emb_rel.values()) < BF16_MEDIAN_REL,
                f"median relative errors {emb_rel} (gate {BF16_MEDIAN_REL})")
    gates.check(emb_rel["ent kernel vs plain"] <= emb_rel["ent plain vs float32"]
                and emb_rel["rel kernel vs plain"] <= emb_rel["rel plain vs float32"],
                f"the kernel moves the embeddings more than bfloat16 does: {emb_rel}")
    gates.check(bool(torch.isfinite(ent).all() and torch.isfinite(rel).all())
                and res["n"] > 0 and math.isfinite(res["mrr"]), "non-finite bf16 round")

    # the image cache: decode every image once, then the entity sweep crops
    secs = store.precompute_image_cache()
    cache_bytes = int(store._img_cache.nbytes)
    reset_launches()
    t0 = time.perf_counter()
    ent_c = fusion.generate_ent_embeddings()
    sync()
    ent_s_cached = time.perf_counter() - t0
    launches_c = by_dtype()
    n_batches = math.ceil(cfg["n_ent"] / 512)
    expect_c = {"attention_fwd.bfloat16": cfg["depth"] * n_batches} if on_card else {}
    log(f"[bf16-serve] image cache: {store._img_cache.shape[0]} images at "
        f"{store._cache_size} px, {cache_bytes} bytes, precompute {secs:.2f} s; ent_s "
        f"{ent_s_cached:.3f} with the cache against {times['ent_s']:.3f} without ({card})")
    gates.check(launches_c == expect_c, f"cached sweep launched {launches_c}, expected {expect_c}")
    gates.check(bool(torch.isfinite(ent_c).all()) and ent_c.shape == ent.shape,
                "cached entity sweep")
    store._img_cache = None                # the plain trainer shares the store
    gates.close()
    info = dict(times=times, times_plain=times_p, times_float32=f32, launches=launches,
                expected=expect, mrr=res["mrr"], mrr_plain=res_p["mrr"], mrr_float32=f32["mrr"],
                rank_agreement=ranks, median_rel=emb_rel,
                cache=dict(precompute_s=secs, bytes=cache_bytes, ent_s=ent_s_cached,
                           ent_s_uncached=times["ent_s"], launches=launches_c))
    return info, dict(fusion=fusion, ent=ent, rel=rel)


def phase_bf16_train(trained: dict, f32_step_ms: dict, cfg: dict = TRAIN,
                     card: str = "no card") -> dict:
    """One epoch of the fusion step in bfloat16 on a kernel-path and a
    same-seed plain trainer, then the float32 kernel trainer of phase 4 and
    the bfloat16 one in turns, then an epoch of a bfloat16 trainer built with
    ``image_cache=True`` and a few of its steps under the profiler."""
    gates = Gates("bf16-train")
    data, table = trained["data"], trained["table"]

    def trainer(impl, **extra):
        store = MultimodalStore(data["mm_info"], data["rel_des"], MultimodalPipelineConfig(
            image_size=cfg["image_size"], **cfg.get("pipe", {})))
        return FusionTrainer(table, store, FusionConfig(
            model_type=cfg["model_type"], patch_size=cfg["patch_size"], seed=192,
            attention_impl=impl, compute_dtype="bfloat16", **cfg.get("fusion", {}), **extra),
            device=trained["fusion"].device)

    def epoch(tr):
        infos = []
        reset_launches()
        t0 = time.perf_counter()
        tr.train_epoch(on_step=infos.append)
        sync()
        secs = time.perf_counter() - t0
        return [{k: float(v) for k, v in i.items()} for i in infos], secs, by_dtype()

    kern, plain = trainer("auto"), trainer("torch")
    m3ae = kern.model.M3AEmodel.cfg
    on_card = kern.device.type == "cuda"
    n = kern.steps_per_epoch
    expect = {"attention_fwd.bfloat16": n * 3 * m3ae.depth,
              "attention_fwd_packed.bfloat16": n * m3ae.dec_depth} if on_card else {}
    steps_k, secs_k, launches_k = epoch(kern)
    steps_p, secs_p, launches_p = epoch(plain)
    first = max(abs(steps_k[0][k] - steps_p[0][k]) / max(abs(steps_p[0][k]), 1e-12)
                for k in INFO_KEYS)
    log(f"[bf16-train] kernel epoch {len(steps_k)} steps {secs_k:.2f} s launches {launches_k} "
        f"expected {expect}; plain epoch {secs_p:.2f} s launches {launches_p}")
    log("[bf16-train] first step, kernel: " + "  ".join(f"{k} {steps_k[0][k]:.6f}"
                                                         for k in INFO_KEYS))
    log("[bf16-train] first step, plain:  " + "  ".join(f"{k} {steps_p[0][k]:.6f}"
                                                         for k in INFO_KEYS))
    log(f"[bf16-train] first step kernel vs plain max rel {first:.3e} "
        f"(tol {BF16_FIRST_STEP_RTOL:g})")
    gates.check(len(steps_k) == len(steps_p) == n > 0, f"steps {len(steps_k)}, {len(steps_p)}")
    gates.check(launches_k == expect, f"kernel epoch launched {launches_k}, expected {expect}")
    gates.check(not launches_p, f"plain epoch launched {launches_p}")
    gates.check(first <= BF16_FIRST_STEP_RTOL, f"first step kernel vs plain {first}")

    # ms per step, bfloat16 and float32 in turns (bf16, plain bf16, then
    # windows of TURN_STEPS steps: f32, bf16)
    f32 = trained["fusion"]
    with first_steps(f32, TURN_STEPS):
        steps_f, secs_f, launches_f = epoch(f32)
    with first_steps(kern, TURN_STEPS):
        steps_k2, secs_k2, launches_k2 = epoch(kern)
    n2 = len(steps_k2)
    gates.check(launches_k2 == {k: v // n * n2 for k, v in expect.items()},
                f"the kernel window launched {launches_k2}")
    gates.check(set(launches_f) <= {"attention_fwd.float32", "attention_fwd_packed.float32"},
                f"the float32 trainer launched {launches_f}")
    step_ms = {"bfloat16": [secs_k / n * 1e3, secs_k2 / n2 * 1e3],
               "float32": secs_f / len(steps_f) * 1e3,
               "bfloat16_plain": secs_p / n * 1e3, "float32_phase4": f32_step_ms}
    log(f"[bf16-train] ms per step in turns: bfloat16 {step_ms['bfloat16'][0]:.1f}, bfloat16 "
        f"plain {step_ms['bfloat16_plain']:.1f}, float32 {step_ms['float32']:.1f}, bfloat16 "
        f"{step_ms['bfloat16'][1]:.1f}; phase 4 float32 kernel {f32_step_ms['kernel']:.1f} "
        f"({card})")

    # FusionConfig.image_cache: decoded once at construction
    t0 = time.perf_counter()
    cached = trainer("auto", image_cache=True)
    build_s = time.perf_counter() - t0
    steps_c, secs_c, launches_c = epoch(cached)
    step_ms["bfloat16_cache"] = secs_c / n * 1e3
    log(f"[bf16-train] image_cache=True: built in {build_s:.2f} s ("
        f"{cached.store._img_cache.nbytes} cache bytes), epoch {secs_c:.2f} s = "
        f"{step_ms['bfloat16_cache']:.1f} ms per step; launches {launches_c} ({card})")
    gates.check(launches_c == expect, f"cached epoch launched {launches_c}")
    bad = [(i, k) for i, s in enumerate(steps_k + steps_p + steps_k2 + steps_c)
           for k, v in s.items() if not math.isfinite(v)]
    gates.check(not bad, f"non-finite loss terms (step, term): {bad[:8]}")
    prof = profile_steps(cached, "bf16-train-profile") if on_card else None
    gates.close()
    return dict(steps=n, launches=launches_k, expected=expect, step_ms=step_ms,
                first_step_max_rel=first, info_first_kernel=steps_k[0],
                info_first_plain=steps_p[0], cache_build_s=build_s, profile=prof)


def phase_bf16_gan(served: dict, bf16: dict, epochs: int = 3, zsl: dict | None = None,
                   card: str = "no card") -> dict:
    """GAN epochs on a ZSL module over the bfloat16 trainer, and on one over
    the float32 trainer of phase 3, in turns (bf16, f32, f32, bf16)."""
    gates = Gates("bf16-gan")
    data, data_dir = served["data"], served["data_dir"]
    zcfg = ZSLConfig(**(zsl or {}))
    depth = bf16["fusion"].model.M3AEmodel.cfg.depth
    on_card = bf16["fusion"].device.type == "cuda"
    expect = {"attention_fwd.bfloat16": epochs * (zcfg.D_epoch + zcfg.G_epoch) * depth} \
        if on_card else {}

    def module(ent, rel):
        z = ZSLModule(data_dir, data["r2id"], data["e2id"], zcfg, device=bf16["fusion"].device)
        z.update_embed(ent, rel)
        z.compute_centroids()
        return z

    runs = {"bfloat16": (module(bf16["ent"], bf16["rel"]), bf16["fusion"]),
            "float32": (module(served["ent"], served["rel"]), served["fusion"])}
    ms, launches = {"bfloat16": [], "float32": []}, {}
    for name in ("bfloat16", "float32", "float32", "bfloat16"):
        z, fus = runs[name]
        reset_launches()
        sync()
        t0 = time.perf_counter()
        d_hist, g_hist = z.train_gan(fus, train_times=epochs, log_every=epochs,
                                     skip_pretrain=True, skip_centroids=True)
        sync()
        ms[name].append((time.perf_counter() - t0) * 1e3 / epochs)
        launches.setdefault(name, []).append(by_dtype())
        bad = [k for h in (d_hist, g_hist) for s in h for k, v in s.items()
               if not math.isfinite(v)]
        gates.check(not bad, f"{name}: non-finite GAN terms {bad[:8]}")
    log(f"[bf16-gan] ms per GAN epoch in turns: bfloat16 {ms['bfloat16'][0]:.1f}, float32 "
        f"{ms['float32'][0]:.1f}, float32 {ms['float32'][1]:.1f}, bfloat16 "
        f"{ms['bfloat16'][1]:.1f}; launches {launches['bfloat16'][0]} expected {expect} "
        f"({card})")
    gates.check(all(x == expect for x in launches["bfloat16"]),
                f"bf16 GAN launched {launches['bfloat16']}, expected {expect}")
    gates.close()
    return dict(epochs=epochs, gan_epoch_ms=ms, launches=launches["bfloat16"][0],
                expected=expect)


def phase_bf16_cli(work_dir: str, cfg: dict = CLI, card: str = "no card") -> dict:
    """``main`` in-process with ``--compute_dtype bfloat16``: one epoch, a
    checkpoint and a ZSL round, with the phase-6 flags."""
    gates = Gates("bf16-cli")
    os.makedirs(work_dir, exist_ok=True)
    old_cwd = os.getcwd()
    os.chdir(work_dir)
    built = []

    def keep_built(fn):
        def call(args):
            out = fn(args)
            built.append(out)
            return out
        return call

    try:
        ds = "cli"
        write_zsl_dataset(os.path.join("data", ds), n_ent=cfg["n_ent"], n_rel=cfg["n_rel"],
                          n_unseen=cfg["n_unseen"], triples_per_rel=cfg["triples_per_rel"],
                          n_candidates=cfg["n_candidates"], image_size=cfg["image_px"], seed=1)
        argv = ["--dataset", ds, "--data_root", "data", "--output_dir", "runs", *cfg["flags"],
                "--compute_dtype", "bfloat16", "--epochs", "1", "--save_epochs", "1"]
        with wrapped(cli, "build_pipeline", keep_built):
            reset_launches()
            t0 = time.perf_counter()
            cli.main(read_options(argv))
            sync()
            secs = time.perf_counter() - t0
            launches = by_dtype()
        (metrics,) = os.listdir("runs")
        with open(os.path.join("runs", metrics)) as f:
            records = [json.loads(line) for line in f]
        n_unseen = len(load_candidates(os.path.join("data", ds), "test"))
    finally:
        os.chdir(old_cwd)
    _, _, _, fusion, zsl = built[0]
    m3ae = fusion.model.M3AEmodel.cfg
    steps = fusion.steps_per_epoch
    zcfg = zsl.cfg
    sweeps = math.ceil(cfg["n_ent"] / 512) + math.ceil(cfg["n_rel"] / 64)
    expect = {"attention_fwd.bfloat16": m3ae.depth * (
                  steps * 3 + sweeps + zcfg.train_times * (zcfg.D_epoch + zcfg.G_epoch)
                  + n_unseen),
              "attention_fwd_packed.bfloat16": steps * m3ae.dec_depth} \
        if fusion.device.type == "cuda" else {}
    mrr = [r["zsl_mrr"] for r in records if "zsl_mrr" in r]
    log(f"[bf16-cli] main --compute_dtype bfloat16: {secs:.1f} s, {steps} steps; launches "
        f"{launches} expected {expect}; zsl_mrr {mrr} ({card})")
    gates.check(launches == expect, f"launched {launches}, expected {expect}")
    gates.check(len(mrr) == 1 and math.isfinite(mrr[0]), f"zsl_mrr {mrr}")
    gates.close()
    return dict(seconds=secs, steps=steps, launches=launches, expected=expect, zsl_mrr=mrr)


# -- phase 8: the KGE toolkit ------------------------------------------------------

# Synthetic benchmarks at the published sizes of FB15K-237 and WN18RR
# (entities, relations, train / valid / test triples); the real files are
# not in the repository. The recipes are tools/train_kge.py's at full width.
KGE = dict(
    fb=dict(n_ent=14541, n_rel=237, n_train=272115, n_valid=17535, n_test=20466, seed=0),
    wn=dict(n_ent=40943, n_rel=11, n_train=86835, n_valid=3034, n_test=3134, seed=1),
    transe_epochs=2,
    rotate=dict(model="rotate", dim=1024, loss="sigmoid", adv_temperature=2.0, neg_ent=64,
                batch_size=2000, bern=False, opt_method="adam", alpha=2e-5,
                init_kwargs=dict(margin=6.0, epsilon=2.0)),
    distmult=dict(model="distmult", dim=200, loss="softplus", regul_rate=1.0,
                  opt_method="adagrad", alpha=0.5, neg_ent=25, bern=True),
    cpu_batch=200,                 # the first RotatE step's cut for the CPU side
    # test triples ranked on the CPU too (RotatE's dim-1024 broadcast scorer
    # takes ~0.7 s per test triple on 8 CPU cores)
    cpu_rank=dict(transe=64, rotate=16, distmult=64),
    profile_steps=5, profile_rank=256,
    sampling=dict(big=200, small=3000, batches=((256, 8), (2048, 8))),
)
# the first RotatE step, card against CPU: loss within rtol 1e-4, parameters
# within 1e-4 of the largest magnitude of each table (the card's index
# backward sums by atomic adds, in another order than the CPU's)
KGE_STEP_RTOL = 1e-4
INDEX_OPS = re.compile(r"index|gather|scatter", re.IGNORECASE)


def phase_kge(work_dir: str, cfg: dict = KGE, card: str = "no card", device=None) -> dict:
    """The KGE toolkit on the card: (a) sampling card vs CPU and a filtered
    batch at FB15K-237 size; (b) the façade runner's transe_FB15K237 recipe
    for two epochs on the native sampler, then an epoch on the device
    sampler; (c) rotate_WN18RR_adv through KGETrainer, its first step held
    against the CPU; (d) distmult_WN18RR; (e) link prediction of (b)-(d) on
    the card, the first test triples ranked on the CPU too; (f) profiles.
    Every check runs and prints before the failures are raised together."""
    from mre_tpu_torch import openke as ok
    from mre_tpu_torch.data.fixtures import write_openke_benchmark
    from mre_tpu_torch.data.kg import DeviceKG
    from mre_tpu_torch.openke.config import _predictors
    from mre_tpu_torch.ops import ranking
    from mre_tpu_torch.ops import sampling as S
    from mre_tpu_torch.tools import train_kge
    from mre_tpu_torch.train.kge import KGETrainer, KGETrainerConfig

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    gates = Gates("kge")
    out, times = {}, {}
    t_phase = time.perf_counter()
    reset_launches()

    # (a) sampling: the card's corrupt_batch equals the CPU's given the draws
    rng = np.random.default_rng(0)
    sc = cfg["sampling"]
    big = np.stack([np.zeros(sc["big"], np.int64), np.zeros(sc["big"], np.int64),
                    np.arange(1, sc["big"] + 1)], 1)
    small = np.stack([rng.integers(1, sc["small"], sc["small"]), np.ones(sc["small"], np.int64),
                      rng.integers(1, sc["small"], sc["small"])], 1)
    tri = np.unique(np.concatenate([big, small]).astype(np.int32), axis=0)
    table = TripleTable.build(tri, sc["small"], 2)
    kg_c, kg_d = DeviceKG.from_table(table), DeviceKG.from_table(table, device=dev)
    gen = torch.Generator().manual_seed(0)
    sampling_cmp = []
    for B, n_neg in sc["batches"]:
        h, r, t = torch.zeros(B, dtype=torch.int64), torch.zeros(B, dtype=torch.int64), \
            torch.ones(B, dtype=torch.int64)
        side_u = torch.rand((B, n_neg), generator=gen)
        row_t, row_h = 0 * table.n_relations + 0, 1 * table.n_relations + 0   # (h, r), (t, r)
        cnt_t = int(table.hr_offsets[row_t + 1] - table.hr_offsets[row_t])
        cnt_h = int(table.tr_offsets[row_h + 1] - table.tr_offsets[row_h])
        cnt = torch.where(side_u < 0.5, cnt_t, cnt_h)
        u = S._randint_below(torch.clamp(table.n_entities - cnt, min=1), (B, n_neg), gen)
        want = S.corrupt_batch(kg_c, h, r, t, n_neg, side_u=side_u, u=u)
        got = S.corrupt_batch(kg_d, h.to(dev), r.to(dev), t.to(dev), n_neg,
                              side_u=side_u.to(dev), u=u.to(dev))
        same = all(torch.equal(getattr(got, f).cpu(), getattr(want, f))
                   for f in ("neg_h", "neg_t", "neg_ent", "neg_side", "overflow_truncated"))
        trunc = int(got.overflow_truncated)
        sampling_cmp.append(dict(batch=B, n_neg=n_neg, equal=same, truncated=trunc,
                                 truncated_cpu=int(want.overflow_truncated)))
        log(f"[kge] (a) corrupt_batch {B}x{n_neg} on the big-row KG: card == CPU {same}, "
            f"truncated {trunc} (CPU {int(want.overflow_truncated)})")
        gates.check(same, f"corrupt_batch {B}x{n_neg} card != CPU")
    gates.check(sampling_cmp[0]["truncated"] == 0 and sampling_cmp[-1]["truncated"] > 0,
                f"truncation counts {[c['truncated'] for c in sampling_cmp]}: expected 0, then > 0")

    t0 = time.perf_counter()
    fb_dir, wn_dir = os.path.join(work_dir, "fb") + "/", os.path.join(work_dir, "wn") + "/"
    write_openke_benchmark(fb_dir, **cfg["fb"])
    write_openke_benchmark(wn_dir, **cfg["wn"])
    fb, wn = ok.read_benchmark(fb_dir), ok.read_benchmark(wn_dir)
    fb_train = TripleTable.build(fb["train"], fb["n_entities"], fb["n_relations"])
    times["fixtures_s"] = time.perf_counter() - t0
    fb_kg = DeviceKG.from_table(fb_train, device=dev)
    B_fb = fb_train.n_triples // 100
    nb = S.sample_training_batch(fb_kg, B_fb, 25, bern=True,
                                 generator=torch.Generator(dev).manual_seed(3))
    negs = [x.cpu().numpy().ravel() for x in (nb.neg_h, nb.r[:, None].expand_as(nb.neg_h),
                                             nb.neg_t)]
    n_true = int(fb_train.contains(*negs).sum())
    fb_trunc = int(nb.overflow_truncated)
    log(f"[kge] (a) FB15K-237-sized batch {B_fb}x25 on the card: {n_true} true negatives, "
        f"truncated {fb_trunc}")
    gates.check(n_true == 0, f"{n_true} negatives are true triples")
    gates.check(fb_trunc == 0, f"{fb_trunc} draws truncated")
    out["sampling"] = dict(cases=sampling_cmp, fb_batch=B_fb, fb_true_negatives=n_true,
                           fb_truncated=fb_trunc)

    # (b) the façade: tools/train_kge.py's main, transe_FB15K237, native sampler
    t0 = time.perf_counter()
    res = train_kge.main(["--recipe", "transe_FB15K237", "--in_path", fb_dir,
                          "--train_times", str(cfg["transe_epochs"]), "--device", str(dev)])
    times["transe_main_s"] = time.perf_counter() - t0
    tr = res["trainer"]
    losses = [e["loss"] for e in tr.epochs]

    def split(e):
        return dict(e, sample_ms=e["sample_s"] / e["steps"] * 1e3,
                    step_ms=e["step_s"] / e["steps"] * 1e3)

    epochs = [split(e) for e in tr.epochs]
    transe = dict(epochs=epochs, metrics=list(res["metrics"]), tester_s=res["rank_s"])
    log(f"[kge] (b) transe_FB15K237 (dim {res['model'].params['ent'].shape[1]}, batch "
        f"{tr.data_loader.batch_size}x25, native sampler on 8 threads), per epoch: "
        + "; ".join(f"loss {e['loss']:.3f} in {e['seconds']:.2f} s, host sampling "
                    f"{e['sample_ms']:.3f} ms + step {e['step_ms']:.3f} ms per step"
                    for e in epochs)
        + f"; Tester {res['rank_s']:.2f} s, filtered MRR {res['metrics'][0]:.5f} ({card})")
    gates.check(len(losses) == cfg["transe_epochs"] and all(map(math.isfinite, losses)),
                f"epoch losses {losses}")
    gates.check(losses[-1] < losses[0], f"the loss did not fall: {losses}")

    model = res["model"]
    loader = ok.TrainDataLoader(in_path=fb_dir, nbatches=100, bern_flag=1, filter_flag=1,
                                neg_ent=25, backend="torch", seed=0, device=dev)
    strategy = ok.NegativeSampling(model=model, loss=ok.MarginLoss(margin=5.0),
                                   batch_size=loader.get_batch_size())
    tr_t = ok.Trainer(model=strategy, data_loader=loader, train_times=1, alpha=1.0,
                      opt_method="sgd", log_every=0, device=dev)
    tr_t.run()
    e = transe["torch_backend"] = split(tr_t.epochs[0])
    log(f"[kge] (b) one epoch on the device sampler (backend='torch'): loss {e['loss']:.3f} "
        f"in {e['seconds']:.2f} s; sampling {e['sample_ms']:.3f} ms + step {e['step_ms']:.3f} "
        f"ms per step")
    gates.check(math.isfinite(e["loss"]), "torch-backend epoch loss not finite")
    out["transe"] = transe

    # (c) rotate_WN18RR_adv through KGETrainer
    wn_train = TripleTable.build(wn["train"], wn["n_entities"], wn["n_relations"])
    rot_cfg = dict(cfg["rotate"], nbatches=wn_train.n_triples // cfg["rotate"]["batch_size"])
    t0 = time.perf_counter()
    rot = KGETrainer(wn_train, KGETrainerConfig(**rot_cfg), device=dev)
    rot_cpu = KGETrainer(wn_train, KGETrainerConfig(**rot_cfg), device=cpu)
    times["rotate_init_s"] = time.perf_counter() - t0
    cut = cfg["cpu_batch"]
    full = rot.sample()
    batch = S.NegativeBatch(*(x[:cut] for x in full[:7]), full.overflow_truncated)
    loss_d = float(rot.step_with_batch(batch))
    loss_c = float(rot_cpu.step_with_batch(S.NegativeBatch(*(x.cpu() for x in batch))))
    step_err = {}
    for k, v in rot_cpu.params.items():
        ref = v.detach()
        step_err[k] = float((rot.params[k].detach().cpu() - ref).abs().max()
                            / max(float(ref.abs().max()), 1e-30))
    loss_rel = abs(loss_d - loss_c) / max(abs(loss_c), 1e-30)
    log(f"[kge] (c) rotate first step ({cut}x{rot_cfg['neg_ent']} cut): loss card {loss_d:.7f} "
        f"CPU {loss_c:.7f} (rel {loss_rel:.2e}); parameters max |d| / max |x| {step_err}")
    gates.check(loss_rel <= KGE_STEP_RTOL, f"rotate first-step loss rel {loss_rel}")
    gates.check(all(e <= KGE_STEP_RTOL for e in step_err.values()),
                f"rotate first-step parameters {step_err}")
    del rot_cpu
    sync()
    t0 = time.perf_counter()
    stats = rot.train_epoch()
    rot_loss = float(stats["loss"])
    rot_s = time.perf_counter() - t0
    rot_info = dict(steps=rot_cfg["nbatches"], epoch_loss=rot_loss,
                    truncated=int(stats["overflow_truncated"]),
                    ms_per_step=rot_s / rot_cfg["nbatches"] * 1e3,
                    first_step=dict(loss_card=loss_d, loss_cpu=loss_c, loss_rel=loss_rel,
                                    param_rel=step_err))
    log(f"[kge] (c) rotate epoch: {rot_cfg['nbatches']} steps of {rot_cfg['batch_size']}x"
        f"{rot_cfg['neg_ent']} in {rot_s:.2f} s ({rot_info['ms_per_step']:.2f} ms/step), "
        f"loss {rot_loss:.4f}, truncated {rot_info['truncated']} ({card})")
    gates.check(math.isfinite(rot_loss) and rot_info["truncated"] == 0,
                f"rotate epoch loss {rot_loss}, truncated {rot_info['truncated']}")
    out["rotate"] = rot_info

    # (d) distmult_WN18RR through KGETrainer
    dm_cfg = dict(cfg["distmult"], batch_size=wn_train.n_triples // 100, nbatches=100)
    dm = KGETrainer(wn_train, KGETrainerConfig(**dm_cfg), device=dev)
    sync()
    t0 = time.perf_counter()
    dm_loss = float(dm.train_epoch()["loss"])
    dm_s = time.perf_counter() - t0
    out["distmult"] = dict(steps=100, epoch_loss=dm_loss, ms_per_step=dm_s / 100 * 1e3)
    log(f"[kge] (d) distmult epoch: 100 steps of {dm_cfg['batch_size']}x25 in {dm_s:.2f} s "
        f"({dm_s * 10:.2f} ms/step), loss {dm_loss:.4f}")
    gates.check(math.isfinite(dm_loss), f"distmult epoch loss {dm_loss}")

    # (e) link prediction on the card; the first test triples on the CPU too
    def union_table(b):
        return TripleTable.build(np.concatenate([b["train"], b["valid"], b["test"]]),
                                 b["n_entities"], b["n_relations"])

    fb_union, wn_union = union_table(fb), union_table(wn)
    cases = {"transe": (lambda kg: _predictors(model, kg), model.params, fb, fb_union),
             "rotate": (rot.predictors, rot.params, wn, wn_union),
             "distmult": (dm.predictors, dm.params, wn, wn_union)}
    ranks = {}
    for name, (predictors, params, b, union) in cases.items():
        kg = DeviceKG.from_table(union, device=dev)
        tails, heads = predictors(kg)
        sync()
        t0 = time.perf_counter()
        card_ranks = ranking.rank_arrays(tails, heads, params, kg, b["test"])
        secs = time.perf_counter() - t0
        n_cpu = cfg["cpu_rank"][name]
        kg_cpu = DeviceKG.from_table(union)
        tails_c, heads_c = predictors(kg_cpu)
        params_c = {k: v.detach().cpu() for k, v in params.items()}
        t0 = time.perf_counter()
        cpu_ranks = ranking.rank_arrays(tails_c, heads_c, params_c, kg_cpu, b["test"][:n_cpu])
        cpu_s = time.perf_counter() - t0
        a = np.concatenate([card_ranks[k][:n_cpu] for k in sorted(cpu_ranks)])
        c = np.concatenate([cpu_ranks[k] for k in sorted(cpu_ranks)])
        equal, diff = rank_agreement(a, c)
        filt = np.concatenate([card_ranks["tail_filter"], card_ranks["head_filter"]])
        mrr_card = float(np.mean(1.0 / np.concatenate(
            [card_ranks["tail_filter"][:n_cpu], card_ranks["head_filter"][:n_cpu]])))
        mrr_cpu = float(np.mean(1.0 / np.concatenate(
            [cpu_ranks["tail_filter"], cpu_ranks["head_filter"]])))
        ranks[name] = dict(n_test=len(b["test"]), seconds=secs,
                           ms_per_triple=secs / len(b["test"]) * 1e3,
                           filtered_mrr=float(np.mean(1.0 / filt)), cpu_triples=n_cpu,
                           cpu_seconds=cpu_s, equal_share=equal, max_diff=diff,
                           mrr_card=mrr_card, mrr_cpu=mrr_cpu)
        log(f"[kge] (e) {name}: {len(b['test'])} test triples ranked on the card in "
            f"{secs:.2f} s ({ranks[name]['ms_per_triple']:.4f} ms/triple), filtered MRR "
            f"{ranks[name]['filtered_mrr']:.5f}; first {n_cpu} on the CPU ({cpu_s:.1f} s): "
            f"{equal:.4f} of {len(a)} ranks equal, max |d| {diff}, MRR card {mrr_card:.6f} "
            f"CPU {mrr_cpu:.6f}")
        gates.check(equal >= RANK_EQUAL_MIN and diff <= RANK_MAX_DIFF,
                    f"{name} ranks card vs CPU: {equal} equal, max |d| {diff}")
        gates.check(abs(mrr_card - mrr_cpu) <= MRR_ATOL,
                    f"{name} MRR card {mrr_card} vs CPU {mrr_cpu}")
    out["ranking"] = ranks

    # (f) profiles: RotatE steps, façade TransE steps (native sampling
    # included), one RotatE ranking chunk
    prof = None
    if on_card:
        n = cfg["profile_steps"]
        native_loader = tr.data_loader
        rank_kg = DeviceKG.from_table(wn_union, device=dev)
        r_tails, r_heads = rot.predictors(rank_kg)
        chunk = wn["test"][:cfg["profile_rank"]]

        def rotate_steps():
            for _ in range(n):
                rot.train_step()

        def transe_steps():
            for _ in range(n):
                tr.step(native_loader.sample())

        def rank_chunk():
            ranking.rank_arrays(r_tails, r_heads, rot.params, rank_kg, chunk,
                                chunk=cfg["profile_rank"])

        prof = {}
        for tag, fn in (("rotate_steps", rotate_steps), ("transe_steps", transe_steps),
                        ("rotate_rank_chunk", rank_chunk)):
            fn()                                            # warm
            prof[tag] = profile_run(fn, f"kge-{tag}", patterns={"gather/index": INDEX_OPS})
    out["profile"] = prof
    launches = dict(attention.LAUNCHES_BY_DTYPE)
    out["launches"] = launches
    gates.check(not any(launches.values()), f"attention kernels launched in phase 8: {launches}")
    times["phase_s"] = time.perf_counter() - t_phase
    out["times"] = times
    log(f"[kge] phase 8 in {times['phase_s']:.1f} s ({card})")
    gates.close()
    return out


# the mesh (phase 9): tools/dryrun_multichip's checks at full width, on a
# 1-rank NCCL world and a larger one (``mesh_world``), all on one serving
# fixture of 512 entities (one sweep batch of 512): the fusion step at phase 4's config
# (M3AE-small, 12 seeds × 4 edges: 60 nodes), the tensor-parallel sweep,
# rel_shared and the GAN loop (ZSLConfig defaults); RotatE at
# rotate_WN18RR_adv's width on a WN18RR-sized table, a 200 × 64 cut of its
# batch.
MESH = dict(
    serve=dict(SLICE, n_ent=512),
    model=dict(model_type=TRAIN["model_type"], patch_size=TRAIN["patch_size"], seed=192),
    pipe=dict(image_size=TRAIN["image_size"]),
    depth=TRAIN["depth"], dec_depth=TRAIN["dec_depth"],
    fusion=dict(steps=3, resume=2),
    tp=dict(batch_size=512, n_model=2),
    zsl=dict(cfg=dict(emb_dim=200, noise_dim=15, test_sample=20, max_neighbor=50),
             iters=3, query_chunk=64, sweep_batch=512),
    kge=dict(n_ent=40943, n_rel=11, n_train=86835, seed=1, cut=200, n_test=64, test_seed=5,
             rotate=KGE["rotate"]),
)
MESH_KGE_RTOL = 1e-4


def mesh_world(device: str) -> tuple[int, str]:
    """The larger world of phase 9 and its backend: one NCCL rank per card
    where there are two cards or more, else two gloo ranks sharing the one
    card (NCCL refuses two ranks on one card), or two on the CPU."""
    cards = torch.cuda.device_count() if device == "cuda" else 0
    return (cards, "nccl") if cards >= 2 else (2, "gloo")


def phase_mesh(work_dir: str, cfg: dict = MESH, card: str = "no card",
               device: str = "cuda") -> dict:
    """The parallel layer (``mre_tpu_torch/parallel/mesh.py``) through
    ``tools/dryrun_multichip.run_checks`` on a 1-rank NCCL world and a
    larger one (``mesh_world``): the data-parallel fusion step (three steps,
    parameters within 5e-4·scale + 1e-5 and adam's first moment within 1e-4
    of the 1-rank run's, exactly 3 × depth + dec_depth launches per rank and
    step, a bitwise resume from a mesh checkpoint after two more steps), the
    tensor-parallel entity sweep on world/2 × 2 (rtol 2e-4, atol 2e-5), rel_shared
    ranks (equal), three D/G iterations (rtol 2e-4), a RotatE step data
    parallel (loss rtol 1e-4) and on world/2 × 2 with the entity rows over
    ``model`` (ranks of 64 test triples equal). Every check prints before
    the failures are raised together."""
    from mre_tpu_torch.tools import dryrun_multichip as dry

    world, backend = mesh_world(device)
    gates = Gates("mesh")
    t_phase = time.perf_counter()
    serve = cfg["serve"]
    serve_dir = os.path.join(work_dir, "serve")
    write_zsl_dataset(serve_dir, n_ent=serve["n_ent"], n_rel=serve["n_rel"],
                      n_unseen=serve["n_unseen"], triples_per_rel=serve["triples_per_rel"],
                      n_candidates=serve["n_candidates"], image_size=serve["image_px"], seed=0)
    model, pipe = cfg["model"], cfg["pipe"]
    rot = dict(cfg["kge"]["rotate"], batch_size=cfg["kge"]["cut"])
    table = {k: cfg["kge"][k] for k in ("n_ent", "n_rel", "n_train", "seed")}
    run_cfg = dict(
        setup=dict(path=serve_dir, pipe=pipe, fusion=model),
        tp=cfg["tp"], zsl=cfg["zsl"],
        fusion=cfg["fusion"],
        kge_cases=[dict(table, n_model=1, cfg=rot),
                   dict(table, n_model=2, cfg=rot, n_test=cfg["kge"]["n_test"],
                        test_seed=cfg["kge"]["test_seed"], chunk=cfg["kge"]["n_test"])])
    # a CPU rehearsal has no NCCL: gloo for both
    t0 = time.perf_counter()
    one, two = dry.run_worlds(run_cfg, world, device, backend=backend,
                              single_backend="nccl" if device == "cuda" else "gloo",
                              threads=(os.cpu_count() or 2,
                                       max(1, (os.cpu_count() or 2) // world)))
    log(f"[mesh] worlds 1 ({one['backend']}) and {world} ({two[0]['backend']}) in "
        f"{time.perf_counter() - t0:.1f} s")
    worlds = {1: [one], world: two}
    for holds, line in dry.compare(two[0], one):
        log(f"[mesh] {line}")
        gates.check(holds, line)
    for line in dry.ranks_agree(two):
        gates.check(False, f"ranks disagree: {line}")

    m3ae_depth, dec_depth = cfg["depth"], cfg["dec_depth"]
    on_card = device == "cuda"
    per_step = {"attention_fwd": on_card * 3 * m3ae_depth,
                "attention_fwd_packed": on_card * dec_depth}
    n_unseen = serve["n_unseen"]
    want = {"fusion_step": per_step,
            "tp": {"attention_fwd": on_card * m3ae_depth, "attention_fwd_packed": 0},
            "rel_shared": {"attention_fwd": on_card * m3ae_depth * n_unseen,
                           "attention_fwd_packed": 0},
            "gan": {"attention_fwd": on_card * 2 * m3ae_depth * cfg["zsl"]["iters"],
                    "attention_fwd_packed": 0}}
    by_rank = {}
    for res in [one] + two:
        label = f"world{res['world']}_rank{res['rank']}"
        got = {"tp": res["tp"]["launches"], "rel_shared": res["zsl"]["eval_launches"],
               "gan": res["zsl"]["gan_launches"]}
        for i, step in enumerate(res["fusion"]["launches"]):
            gates.check(step == per_step, f"{label} fusion step {i} launches {step}, "
                                          f"expected {per_step}")
        for k, v in got.items():
            gates.check(v == want[k], f"{label} {k} launches {v}, expected {want[k]}")
        steps = res["fusion"]["launches"]
        by_rank[label] = {k: sum(s[k] for s in steps) + sum(g[k] for g in got.values())
                          for k in per_step}
        log(f"[mesh] {label} ({res['backend']}, {res['device']}): launches {by_rank[label]}; "
            f"step ms {[round(x, 1) for x in res['fusion']['step_ms']]}, all-reduce ms "
            f"{[round(x, 1) for x in res['fusion']['allreduce_ms']]} over "
            f"{res['fusion']['grad_floats']} floats; TP sweep {res['tp']['ms']:.1f} ms on "
            f"{res['tp']['mesh']}; GAN {res['zsl']['gan_ms']:.1f} ms per D+G over "
            f"{res['zsl']['rows']} rows; resume checkpoint {res['fusion']['resume']['bytes']} "
            f"bytes saved in {res['fusion']['resume']['save_s']:.2f} s; sections s "
            f"{ {k: round(v, 1) for k, v in res['section_s'].items()} }")
        gates.check(all(np.isfinite(v) for i in res["fusion"]["infos"] for v in i.values()),
                    f"{label} non-finite fusion terms")
    rd, rd1 = two[0]["kge_cases"][0], one["kge_cases"][0]
    rel = abs(rd["losses"][0] - rd1["losses"][0]) / abs(rd1["losses"][0])
    log(f"[mesh] rotate dp step ({cfg['kge']['cut']}x{rot['neg_ent']}, mesh {rd['mesh']}): "
        f"loss {rd['losses'][0]:.7f} vs 1-rank {rd1['losses'][0]:.7f} (rel {rel:.2e}); "
        f"step ms {rd['step_ms'][0]:.1f} vs {rd1['step_ms'][0]:.1f}")
    gates.check(rel <= MESH_KGE_RTOL, f"rotate dp loss rel {rel}")
    rm, rm1 = two[0]["kge_cases"][1], one["kge_cases"][1]
    equal = all(np.array_equal(v, rm1["ranks"][k]) for k, v in rm["ranks"].items())
    log(f"[mesh] rotate dp×mp step (mesh {rm['mesh']}): loss {rm['losses'][0]:.7f} vs "
        f"{rm1['losses'][0]:.7f}; {cfg['kge']['n_test']} test triples ranked on the row-split "
        f"table in {rm['lp_ms_per_triple']:.2f} ms per triple (replicated "
        f"{rm1['lp_ms_per_triple']:.2f}); ranks equal: {equal}")
    gates.check(equal, "rotate ranks on the row-split table differ from the replicated ones")
    gates.check(np.isclose(rm["losses"][0], rm1["losses"][0], rtol=MESH_KGE_RTOL),
                f"rotate dp×mp loss {rm['losses'][0]} vs {rm1['losses'][0]}")

    def strip(res):
        """A world's result without the arrays (parameters, moments, embeddings)."""
        f = {k: v for k, v in res["fusion"].items() if k not in ("params", "moment")}
        z = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in res["zsl"].items()
             if k != "state"}
        kge = [{k: v for k, v in c.items() if k not in ("params", "ranks")}
               for c in res["kge_cases"]]
        return dict(rank=res["rank"], world=res["world"], backend=res["backend"],
                    device=res["device"], fusion=f, tp={k: v for k, v in res["tp"].items()
                                                       if k != "emb"}, zsl=z, kge=kge)

    out = dict(card=card, launches_by_rank=by_rank,
               worlds={str(w): [strip(r) for r in rs] for w, rs in worlds.items()},
               lines=[line for _, line in dry.compare(two[0], one)],
               phase_s=time.perf_counter() - t_phase)
    log(f"[mesh] phase 9 in {out['phase_s']:.1f} s ({card})")
    gates.close()
    return out


# -- phase 10: the learnability run on trained weights ---------------------------


# tools/zsl_learnability at the trained settings of the JAX package's own
# certification (experiments/results/bf16_cert.json: 6 epochs, 400 pretraining
# steps, 400 GAN epochs) on its learnable fixture: 59 unseen-relation queries
# of 30 candidates. The gates, set before the first run on the card:
# float32 factored Hits@10 at least 0.5 (random: 10 / 30); the trained module
# through the kernel and through the plain attention, on each float32 path, at
# least 0.95 of the ranks equal and none moved by more than 1; each bf16 path
# against f32_factored at least 0.88 equal (the JAX run's least: 53 / 59 =
# 0.898) and Hits@10 within 0.05.
LEARN = dict(epochs=6, pretrain_steps=400, train_times=400, seed=0)
LEARN_HITS10_MIN = 0.5
LEARN_RANK_EQUAL_MIN, LEARN_RANK_MAX_DIFF = 0.95, 1
CERT_RANK_MATCH_MIN, CERT_D_HITS10_MAX = 0.88, 0.05


def phase_learnability(work_dir: str, cfg: dict = LEARN, card: str = "no card",
                       device: str = "cuda") -> dict:
    """``tools/zsl_learnability.main`` in process with ``--cert_out``: the
    whole pipeline trained on the learnable fixture, then certified on every
    (dtype × eval path). Exact launch counts of the run (from the
    configuration), learnability, the trained module through the kernel and
    the plain attention, bf16 against float32, and stage times. Every check
    prints before the failures are raised together."""
    from mre_tpu_torch.tools import zsl_learnability as zl

    gates = Gates("trained")
    t_phase = time.perf_counter()
    stages, held = [], {}
    cert_path = os.path.join(OUT_DIR, "learnability_cert.json")
    os.makedirs(OUT_DIR, exist_ok=True)

    def stage(what):
        """Seconds and kernel launches of each call (synchronised)."""
        def wrap(fn):
            def call(*a, **kw):
                sync()
                before = dict(attention.LAUNCHES_BY_DTYPE)
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sync()
                stages.append(dict(what=what, s=time.perf_counter() - t0, launches={
                    k: v - before[k] for k, v in attention.LAUNCHES_BY_DTYPE.items()
                    if v != before[k]}))
                return out
            return call
        return wrap

    def keep(fn):                  # the first evaluation's module and trainer
        def call(self, fusion_trainer, *a, **kw):
            held.setdefault("zsl", self)
            held.setdefault("fusion", fusion_trainer)
            return fn(self, fusion_trainer, *a, **kw)
        return call

    argv = ["--epochs", str(cfg["epochs"]), "--pretrain_steps", str(cfg["pretrain_steps"]),
            "--train_times", str(cfg["train_times"]), "--seed", str(cfg["seed"]),
            "--out", work_dir, "--cert_out", cert_path, "--device", device]
    with contextlib.ExitStack() as stack:
        for owner, name in ((FusionTrainer, "train_epoch"),
                            (FusionTrainer, "generate_ent_embeddings"),
                            (FusionTrainer, "generate_rel_embeddings"),
                            (ZSLModule, "pretrain_extractor"),
                            (ZSLModule, "compute_centroids"), (ZSLModule, "train_gan")):
            stack.enter_context(wrapped(owner, name, stage(name)))
        stack.enter_context(wrapped(ZSLModule, "evaluate",
                                    lambda fn: keep(stage("evaluate")(fn))))
        reset_launches()
        t0 = time.perf_counter()
        result = zl.main(argv)
        sync()
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in attention.LAUNCHES_BY_DTYPE.items()}
    with open(cert_path) as f:
        cert = json.load(f)
    zsl, fusion = held["zsl"], held["fusion"]

    # exact launches, from the configuration: per fusion step 3 encoder
    # passes × depth at head_dim 64 (masked joint, N 17; unmasked joint, N
    # 33; edge descriptions, N 17) and the decoder × dec_depth at head_dim
    # 32 (N 33); the entity sweep in batches of 64 and the relation sweep in
    # batches of 16 (zsl_learnability.py), D_epoch + G_epoch generator
    # passes per GAN epoch, and n_unseen generator passes per evaluation
    # (1 + the 6 certification paths; a bf16 evaluation's generator runs in
    # the trainer's float32). Pretraining and the centroids launch none.
    m3ae = fusion.model.M3AEmodel.cfg
    zc = zsl.cfg
    on_card = fusion.device.type == "cuda"
    steps = cfg["epochs"] * fusion.steps_per_epoch
    n_unseen = len(load_candidates(zsl.data_path, "test"))
    n_evals = sum(r["what"] == "evaluate" for r in stages)
    sweeps = (math.ceil(fusion.table.n_entities / 64) + math.ceil(fusion.table.n_relations / 16))
    per = dict(fusion_steps=3 * m3ae.depth * steps, sweeps=m3ae.depth * sweeps,
               gan=m3ae.depth * cfg["train_times"] * (zc.D_epoch + zc.G_epoch),
               evaluations=m3ae.depth * n_unseen * n_evals)
    expect = {k: 0 for k in attention.LAUNCHES_BY_DTYPE}
    expect["attention_fwd.float32"] = on_card * sum(per.values())
    expect["attention_fwd_packed.float32"] = on_card * m3ae.dec_depth * steps
    log(f"[trained] launches {launches}; expected {expect} = depth {m3ae.depth} × (3 × "
        f"{steps} steps + {sweeps} sweep batches + {cfg['train_times']} GAN epochs × "
        f"{zc.D_epoch + zc.G_epoch} + {n_evals} evaluations × {n_unseen} relations) and "
        f"dec_depth {m3ae.dec_depth} × {steps} steps")
    gates.check(n_evals == 7, f"{n_evals} evaluations, expected 1 + 6 certification paths")
    gates.check(launches == expect, f"launches {launches}, expected {expect}")

    # learnability
    f32 = cert["paths"]["f32_factored"]
    random_hits10 = 10 / cert["n_candidates"]
    log(f"[trained] f32_factored on {cert['n_queries']} unseen-relation queries: Hits@10 "
        f"{f32['hits10']:.4f} (random {random_hits10:.4f}, lift "
        f"{f32['hits10'] / random_hits10:.2f}x), Hits@5 {f32['hits5']:.4f}, Hits@1 "
        f"{f32['hits1']:.4f}, MRR {f32['mrr']:.4f}; the run's own evaluation "
        f"(head_shared) Hits@10 {result['hits10']:.4f} MRR {result['mrr']:.4f}")
    gates.check(cert["n_queries"] == 59, f"{cert['n_queries']} queries, expected 59")
    gates.check(f32["hits10"] >= LEARN_HITS10_MIN,
                f"f32_factored Hits@10 {f32['hits10']} < {LEARN_HITS10_MIN}")

    # bf16 against float32, from the certification
    for key, c in cert["paths"].items():
        if key == "f32_factored":
            continue
        log(f"[trained] cert {key}: Hits@10 {c['hits10']:.4f} MRR {c['mrr']:.4f}; vs "
            f"f32_factored ranks equal {c['rank_match_vs_f32_factored']:.4f}, max |d rank| "
            f"{c['max_abs_rank_delta']}, d_hits10 {c['d_hits10']:+.6f}, d_mrr "
            f"{c['d_mrr']:+.6f} ({c['seconds']} s)")
        if key.startswith("bf16"):
            gates.check(c["rank_match_vs_f32_factored"] >= CERT_RANK_MATCH_MIN,
                        f"{key} ranks equal {c['rank_match_vs_f32_factored']} < "
                        f"{CERT_RANK_MATCH_MIN}")
            gates.check(abs(c["d_hits10"]) <= CERT_D_HITS10_MAX,
                        f"{key} |d_hits10| {abs(c['d_hits10'])} > {CERT_D_HITS10_MAX}")

    # the trained module through the kernel and through the plain attention
    def ranks(dtype, path):
        return zsl.evaluate(fusion, mode="test", verbose=False, query_chunk=16,
                            compute_dtype=dtype, eval_path=path, return_ranks=True)["ranks"]

    combos = [(d, p) for d in ("float32", "bfloat16") for p in EVAL_PATHS]
    kernel = {c: ranks(*c) for c in combos}
    reset_launches()
    with plain_attention(fusion):
        plain = {c: ranks(*c) for c in combos}
    plain_launches = {k: v for k, v in attention.LAUNCHES_BY_DTYPE.items() if v}
    gates.check(not plain_launches, f"the plain attention launched {plain_launches}")
    agree = {f"{d} {p}": rank_agreement(kernel[(d, p)], plain[(d, p)]) for d, p in combos}
    log("[trained] kernel vs plain on the trained module, ranks equal / max |d rank|: "
        + "  ".join(f"{k} {eq:.4f} / {dm}" for k, (eq, dm) in agree.items()))
    for (d, p), (eq, dm) in zip(combos, agree.values()):
        if d == "float32":
            gates.check(eq >= LEARN_RANK_EQUAL_MIN and dm <= LEARN_RANK_MAX_DIFF,
                        f"float32 {p} kernel vs plain: {eq} equal, max |d| {dm}")

    # stage times
    def total(what):
        return sum(r["s"] for r in stages if r["what"] == what)

    epochs_s = [r["s"] for r in stages if r["what"] == "train_epoch"]
    pretrain_s, centroids_s = total("pretrain_extractor"), total("compute_centroids")
    gan_loop_s = total("train_gan") - pretrain_s - centroids_s
    times = dict(
        run_s=run_s, epochs_s=epochs_s,
        fusion_step_ms=sum(epochs_s) / steps * 1e3,
        fusion_step_ms_after_first_epoch=(sum(epochs_s[1:]) / (steps - fusion.steps_per_epoch)
                                          * 1e3 if len(epochs_s) > 1 else None),
        ent_sweep_s=total("generate_ent_embeddings"),
        rel_sweep_s=total("generate_rel_embeddings"),
        pretrain_step_ms=pretrain_s / cfg["pretrain_steps"] * 1e3, centroids_s=centroids_s,
        gan_epoch_ms=gan_loop_s / cfg["train_times"] * 1e3,
        evaluate_s=[r["s"] for r in stages if r["what"] == "evaluate"])
    times["setup_s"] = run_s - sum(r["s"] for r in stages
                                   if r["what"] not in ("pretrain_extractor",
                                                        "compute_centroids"))
    log(f"[trained] stages ({card}): run {run_s:.1f} s = setup and dataset "
        f"{times['setup_s']:.1f} s + {len(epochs_s)} fusion epochs "
        f"{sum(epochs_s):.1f} s ({fusion.steps_per_epoch} steps each; "
        f"{times['fusion_step_ms']:.2f} ms per step, "
        f"{times['fusion_step_ms_after_first_epoch'] or float('nan'):.2f} after the first "
        f"epoch) + sweeps {times['ent_sweep_s'] + times['rel_sweep_s']:.2f} s + Extractor "
        f"pretraining {pretrain_s:.1f} s ({times['pretrain_step_ms']:.2f} ms per step) + "
        f"centroids {centroids_s:.2f} s + GAN {gan_loop_s:.1f} s "
        f"({times['gan_epoch_ms']:.2f} ms per epoch) + {n_evals} evaluations "
        f"{sum(times['evaluate_s']):.2f} s")
    out = dict(card=card, launches=launches, expected=expect, expected_parts=per,
               steps=steps, steps_per_epoch=fusion.steps_per_epoch, cert=cert,
               result={k: v for k, v in result.items() if k != "per_relation"},
               kernel_vs_plain=agree, times=times, stages=stages,
               phase_s=time.perf_counter() - t_phase)
    log(f"[trained] phase 10 in {out['phase_s']:.1f} s ({card})")
    gates.close()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    resolve_device()                       # TF32 off before any comparison
    card = card_line()
    log(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = attention.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    build = attention.build_report(lib)
    for (hd, dtype), r in sorted(build.items()):
        log(f"[build] attention_fwd_kernel<{hd}, {dtype}>: {r['registers']} registers, "
            f"spill stores {r['spill_stores']} B, spill loads {r['spill_loads']} B, "
            f"HMMA {r['hmma'] if r['hmma'] is not None else 'not counted (no cuobjdump)'}")
    if len(build) != 2 * len(attention.HEAD_DIMS):
        raise AssertionError(f"ptxas reported {sorted(build)}, expected every head_dim × dtype")
    spills = [key for key, r in build.items() if key[0] <= 64 and r["spill_stores"]]
    if spills:
        raise AssertionError(f"register spills at head_dim <= 64: {spills}")
    if any(r["hmma"] == 0 for r in build.values()):
        raise AssertionError(f"an instantiation has no tensor-core instruction: {build}")

    phase_s = {"build": time.perf_counter() - t_start}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            phase_s[name] = time.perf_counter() - t0
            log(f"[time] {name}: {phase_s[name]:.1f} s")

    recs = timed("2_kernels", phase_kernels)
    with tempfile.TemporaryDirectory() as tmp:
        slice_info, served = timed("3_serving", phase_slice, os.path.join(tmp, "serve"))
        train_info, trained = timed("4_training", phase_train, os.path.join(tmp, "train"))
        zsl_info = timed("5_zsl", phase_zsl, served, card=card)
        cli_info = timed("6_cli", phase_cli, os.path.join(tmp, "cli"), card=card)
        f32_round = dict(slice_info["times"], mrr=slice_info["metrics"]["mrr"])
        serve16_info, bf16 = timed("7_bf16_serving", phase_bf16_serving, served, f32_round,
                                   card=card)
        train16_info = timed("7_bf16_train", phase_bf16_train, trained, train_info["step_ms"],
                             card=card)
        gan16_info = timed("7_bf16_gan", phase_bf16_gan, served, bf16, epochs=GAN_TURN_EPOCHS,
                           card=card)
        cli16_info = timed("7_bf16_cli", phase_bf16_cli, os.path.join(tmp, "cli_bf16"),
                           card=card)
        kge_info = timed("8_kge", phase_kge, os.path.join(tmp, "kge"), card=card)
        mesh_info = timed("9_mesh", phase_mesh, os.path.join(tmp, "mesh"), card=card)
        learn_info = timed("10_trained", phase_learnability, os.path.join(tmp, "learn"),
                           card=card)

    def entry(name, replaces, case, dtype="float32"):
        """One kernel's line: its times at ``case`` in ``dtype``, its
        launches on each path of this run (phases 3-6 in float32, phase 7 in
        bfloat16, phase 8 in either, phase 9 in float32 on each rank, phase
        10 in float32)."""
        rec = next(r for r in recs if r["case"] == case and r["dtype"] == dtype)
        if dtype == "float32":
            by_path = {"serving": slice_info["launches"][name],
                       "training": train_info["launches"][name],
                       "zsl_training": zsl_info["launches"][name],
                       "cli": cli_info["launches"][name],
                       "kge": kge_info["launches"][f"{name}.float32"],
                       # per rank of each world (its own process's counter)
                       "mesh": {r: c[name] for r, c in mesh_info["launches_by_rank"].items()},
                       "trained": learn_info["launches"][f"{name}.float32"]}
        else:
            key = f"{name}.{dtype}"
            by_path = {"serving": serve16_info["launches"].get(key, 0),
                       "training": train16_info["launches"].get(key, 0),
                       "zsl_training": gan16_info["launches"].get(key, 0),
                       "cli": cli16_info["launches"].get(key, 0),
                       "kge": kge_info["launches"][key],
                       "mesh": {r: 0 for r in mesh_info["launches_by_rank"]},
                       "trained": learn_info["launches"][key]}
            name = f"{name}_bf16"
        launches = sum(v if isinstance(v, int) else sum(v.values()) for v in by_path.values())
        return {"name": name, "route": "cuda", "source": "mre_tpu_torch/csrc/attention_fwd.cu",
                "replaces": replaces, "launches": launches,
                "launches_by_path": by_path, "case": case,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "share_of_bound": rec["share_of_bound"],
                "library_ms": rec["library_ms"]}

    kernels = {"kernels": [
        entry("attention_fwd", "mre_tpu/ops/pallas/attention.py:81", "entity"),
        entry("attention_fwd_packed", "mre_tpu/ops/pallas/attention.py:94", "decoder"),
        entry("attention_fwd", "mre_tpu/ops/pallas/attention.py:81", "entity", "bfloat16"),
        entry("attention_fwd_packed", "mre_tpu/ops/pallas/attention.py:94", "decoder",
              "bfloat16"),
    ]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, kernel_cases=recs,
                       build={f"hd{hd}_{dt}": r for (hd, dt), r in build.items()},
                       slice=slice_info, train=train_info, zsl=zsl_info, cli=cli_info,
                       bf16_serving=serve16_info, bf16_train=train16_info,
                       bf16_gan=gan16_info, bf16_cli=cli16_info, kge=kge_info,
                       mesh=mesh_info, trained=learn_info, phase_s=phase_s,
                       kernels=kernels["kernels"]),
                  f, indent=1)
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
