"""Chip smoke test of the PyTorch/CUDA port (mre_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on any failure):

1. card and build — the card's name and power limit (nvidia-smi); every
   kernel of the path is compiled from csrc/ with nvcc (all sources at once);
2. kernels vs plain — each kernel's wrapper on the card at the serving
   shapes, held against its plain PyTorch version (float32 atol 1e-4,
   bfloat16 atol 2e-2), with CUDA-event times of the kernel, the plain
   version and the library call beside the bound worked out from shapes;
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
4. one JSON line of kernels, the card line, and the result line.

Details that do not fit the end of the output go to chiprun_out/.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.data.fixtures import write_zsl_dataset
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.loaders import load_zsl_dataset
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.ops import attention
from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer
from mre_tpu_torch.zsl.module import ZSLConfig, ZSLModule

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet, dense): float32 outside the
# tensor cores, bfloat16 on the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# the serving slice at the full width of M3AE-small (depth 12)
SLICE = dict(model_type="small", depth=12, image_size=256, patch_size=16,
             n_ent=2048, n_rel=32, n_unseen=4, triples_per_rel=200,
             n_candidates=500, image_px=64)


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


def attention_case(name, B, H, N, hd, dtype, mask_kind, gen, timed=False):
    dev = torch.device("cuda")
    q, k, v = (torch.randn(B, H, N, hd, generator=gen).to(dev, dtype) for _ in range(3))
    if mask_kind == "entity":
        pad = serving_mask(B, N, 64, gen, mostly_pad=False).to(dev)
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
    log(f"[kernel] {name:<22} {rec['dtype']:<8} B{B} H{H} N{N} hd{hd} mask={mask_kind:<8} "
        f"max|d|={err:.3e} (tol {TOL[dtype]:g})"
        + (f"  kernel {rec['ms']:.3f} ms  plain {rec['plain_ms']:.3f} ms  "
           f"sdpa {rec['library_ms']:.3f} ms  bound {rec['bound_ms']:.3f} ms "
           f"({rec['bound_by']})" if timed else ""))
    if not ok:
        raise AssertionError(f"attention_fwd disagrees with its plain version: {rec}")
    return rec


def phase_kernels():
    gen = torch.Generator().manual_seed(0)
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        recs.append(attention_case("entity", 512, 6, 321, 64, dtype, "entity", gen, timed=True))
        recs.append(attention_case("relation", 64, 6, 321, 64, dtype, "relation", gen, timed=True))
        recs.append(attention_case("generate", 20, 6, 321, 64, dtype, "relation", gen, timed=True))
        recs.append(attention_case("no_mask", 64, 6, 321, 64, dtype, "none", gen))
        recs.append(attention_case("huge_hd80", 64, 16, 321, 80, dtype, "entity", gen, timed=True))
        recs.append(attention_case("ragged_n37", 3, 6, 37, 64, dtype, "entity", gen))
    return recs


# -- phase 3: the serving slice ------------------------------------------------


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile_serve(serve) -> dict:
    """One more kernel-path run under torch.profiler: wall time, device busy
    time (the sum over device-side events: kernels, copies, sets; CPU ops
    that only launch them are left out so nothing counts twice), idle share,
    and the top device events by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")]      # profiler's own
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=1.0 - busy_ms / wall_ms,
               attention_ms=sum(r[1] for r in rows if "attention_fwd" in r[0]),
               top=[dict(op=k[:80], ms=ms, count=c) for k, ms, c in rows[:12]])
    log(f"[profile] wall {wall_ms:.1f} ms  device busy {busy_ms:.1f} ms  idle share "
        f"{out['device_idle_share']:.3f}  attention_fwd {out['attention_ms']:.1f} ms")
    for r in out["top"]:
        log(f"[profile]   {r['ms']:10.2f} ms  x{r['count']:<5} {r['op']}")
    return out


def phase_slice(data_dir: str, cfg: dict = SLICE, device=None):
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
        res = zsl.evaluate(fusion, verbose=False, return_ranks=True)
        sync()
        times["eval_s"] = time.perf_counter() - t0
        return ent, rel, res, times

    attention.LAUNCHES["attention_fwd"] = 0
    ent, rel, res, times = serve(fusion)
    launches = dict(attention.LAUNCHES)
    t.update(times)
    expect = cfg["depth"] * (math.ceil(cfg["n_ent"] / 512) + math.ceil(cfg["n_rel"] / 64)
                             + cfg["n_unseen"])
    log(f"[slice] kernel run: {times}  launches {launches}  expected {expect}")
    log(f"[slice] metrics: hits10 {res['hits10']:.4f} hits5 {res['hits5']:.4f} "
        f"hits1 {res['hits1']:.4f} mrr {res['mrr']:.6f} n {res['n']}")
    if launches["attention_fwd"] != expect:
        raise AssertionError(f"attention_fwd launched {launches['attention_fwd']} "
                             f"times on the serving path, expected {expect}")
    if ent.shape != (cfg["n_ent"], 200) or rel.shape != (cfg["n_rel"], 200):
        raise AssertionError(f"embedding shapes {tuple(ent.shape)}, {tuple(rel.shape)}")
    if not (torch.isfinite(ent).all() and torch.isfinite(rel).all()):
        raise AssertionError("non-finite embeddings")
    if res["n"] == 0 or not np.isfinite(res["mrr"]):
        raise AssertionError(f"bad evaluation result: {res}")

    # the same round through the plain attention, as the reference
    attention.LAUNCHES["attention_fwd"] = 0
    ent_p, rel_p, res_p, times_p = serve(fusion_plain)
    if attention.LAUNCHES["attention_fwd"] != 0:
        raise AssertionError("attention_impl='torch' still launched the kernel")
    d_ent = float((ent - ent_p).abs().max())
    d_rel = float((rel - rel_p).abs().max())
    d_mrr = abs(res["mrr"] - res_p["mrr"])
    rank_agree = float(np.mean(res["ranks"] == res_p["ranks"]))
    log(f"[slice] plain run: {times_p}  mrr {res_p['mrr']:.6f}")
    log(f"[slice] kernel vs plain: max|d| ent {d_ent:.3e} rel {d_rel:.3e} "
        f"|d mrr| {d_mrr:.3e} ranks equal {rank_agree:.4f}")
    # float32 through 12 blocks; the online softmax sums in another order than
    # the plain softmax and index_add_ atomics reorder the RGCN sums
    if d_ent > 1e-3 or d_rel > 1e-3 or d_mrr > 1e-3:
        raise AssertionError(f"kernel path disagrees with the plain path: "
                             f"ent {d_ent} rel {d_rel} mrr {d_mrr}")
    return dict(times=t, times_plain=times_p, launches=launches, expected=expect,
                metrics={k: res[k] for k in ("hits10", "hits5", "hits1", "mrr", "n")},
                mrr_plain=res_p["mrr"], max_abs_ent=d_ent, max_abs_rel=d_rel,
                rank_agreement=rank_agree, profile=profile_serve(lambda: serve(fusion)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    resolve_device()                       # TF32 off before any comparison
    card = card_line()
    log(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = attention.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = attention.BUILD_DIR / "attention_fwd.ptxas.txt"
    if ptxas.exists():
        log(ptxas.read_text().strip())

    recs = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        slice_info = phase_slice(tmp)

    line = next(r for r in recs if r["case"] == "entity" and r["dtype"] == "float32")
    kernels = {"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "mre_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "mre_tpu/ops/pallas/attention.py:81",
        "launches": slice_info["launches"]["attention_fwd"],
        "max_abs_err": line["max_abs_err"], "ms": line["ms"],
        "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
        "bound_by": line["bound_by"], "library_ms": line["library_ms"],
    }]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, kernel_cases=recs,
                       slice=slice_info, kernels=kernels["kernels"]), f, indent=1)
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
