"""Tile sweep of the attention kernel on one CUDA card.

    python -m mre_tpu_torch.tools.tile_sweep [--block-k 16 32 64] [--warps 4 8]

Builds ``csrc/attention_fwd.cu`` once per (``ATTN_BLOCK_K``, ``ATTN_WARPS``)
pair (nvcc runs in parallel): keys per shared-memory tile, and warps per
block at 16 query rows each. Each build is checked against the plain
version and timed with CUDA events at two main-path shapes, in float32 and
bfloat16: the decoder of the training step (B 60, H 16, N 321, hd 32) and
the entity sweep of serving (B 512, H 6, N 321, hd 64), both with
entity-style padding. Prints the ptxas registers and spills of the hd-32
and hd-64 instantiations of each build and one JSON line of results.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.ops import attention

SHAPES = {"decoder": (60, 16, 321, 32), "entity": (512, 6, 321, 64)}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def _inputs(shape, dev, gen):
    B, H, N, hd = shape
    pad = torch.zeros(B, N)
    for b, n in enumerate(torch.randint(5, 21, (B,), generator=gen).tolist()):
        pad[b, N - 64 + n:] = 1.0                # entity text: 5-20 words of 64
    qkv = [torch.randn(*shape, generator=gen).to(dev) for _ in range(3)]
    return qkv, pad.to(dev)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--block-k", type=int, nargs="+", default=[16, 32, 64])
    p.add_argument("--warps", type=int, nargs="+", default=[4, 8])
    args = p.parse_args()
    dev = resolve_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    tiles = list(itertools.product(args.block_k, args.warps))
    with ThreadPoolExecutor(len(tiles)) as pool:
        paths = list(pool.map(lambda bw: attention.build(
            (f"ATTN_BLOCK_K={bw[0]}", f"ATTN_WARPS={bw[1]}")), tiles))

    gen = torch.Generator().manual_seed(0)
    inputs = {name: _inputs(shape, dev, gen) for name, shape in SHAPES.items()}
    results = []
    for (bk, warps), path in zip(tiles, paths):
        lib = attention.bind(path)
        report = attention.ptxas_report(path.with_suffix(".ptxas.txt").read_text())
        print(f"[ptxas] BLOCK_K {bk} WARPS {warps}: " + " | ".join(
            f"hd{hd} {dt}: {r.get('registers')} registers, {r.get('spill_stores')} B spilled"
            for (hd, dt), r in sorted(report.items()) if hd in (32, 64)), flush=True)
        for (name, shape), dtype in itertools.product(SHAPES.items(),
                                                       (torch.float32, torch.bfloat16)):
            (q, k, v), pad = [x.to(dtype) for x in inputs[name][0]], inputs[name][1]
            scale = shape[-1] ** -0.5
            out = attention.attention_fwd_cuda(q, k, v, pad, scale, lib=lib)
            ref = attention.attention_reference(q, k, v, pad, scale)
            err = float((out.float() - ref.float()).abs().max())
            if not err <= TOL[dtype]:
                raise AssertionError(f"BLOCK_K {bk} WARPS {warps} {name} {dtype}: max|d| {err}")
            ms = _time_ms(lambda: attention.attention_fwd_cuda(q, k, v, pad, scale, lib=lib))
            rec = dict(block_k=bk, warps=warps, shape=name, dtype=str(dtype).split(".")[-1],
                       max_abs_err=err, ms=ms)
            print(f"[sweep] {rec}", flush=True)
            results.append(rec)
    print(json.dumps({"card": card, "shapes": SHAPES, "sweep": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
