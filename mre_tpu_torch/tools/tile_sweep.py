"""Key-tile sweep of the head_dim-32 attention kernel on one CUDA card.

    python -m mre_tpu_torch.tools.tile_sweep [--block-k 32 64 128]

Builds ``csrc/attention_fwd.cu`` once per ``BLOCK_K_HD32`` value (nvcc runs
in parallel), checks each build against the plain version at the decoder
shape of the training step (B 60, H 16, N 321, hd 32, entity-style padding)
in float32 and bfloat16, and times it with CUDA events. Prints the ptxas
register and spill report of each head_dim-32 instantiation and one JSON
line of results.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.ops import attention

SHAPE = (60, 16, 321, 32)
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


def _ptxas_hd32(report: str) -> list[str]:
    """The ptxas lines of the head_dim-32 kernels: entry, registers, spills."""
    out, keep = [], False
    for line in report.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            keep = "attention_fwd_kernelILi32E" in m.group(1)
            if keep:
                out.append("bf16" if "bfloat16" in m.group(1) else "f32")
        elif keep and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--block-k", type=int, nargs="+", default=[32, 64, 128])
    args = p.parse_args()
    dev = resolve_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with ThreadPoolExecutor(len(args.block_k)) as pool:
        paths = list(pool.map(lambda bk: attention.build((f"BLOCK_K_HD32={bk}",)), args.block_k))

    gen = torch.Generator().manual_seed(0)
    B, H, N, hd = SHAPE
    pad = torch.zeros(B, N)
    for b, n in enumerate(torch.randint(5, 21, (B,), generator=gen).tolist()):
        pad[b, N - 64 + n:] = 1.0                # entity text: 5-20 words of 64
    pad = pad.to(dev)
    qkv = [torch.randn(B, H, N, hd, generator=gen).to(dev) for _ in range(3)]
    scale = hd ** -0.5
    results = []
    for bk, path in zip(args.block_k, paths):
        lib = attention.bind(path)
        ptxas = _ptxas_hd32(path.with_suffix(".ptxas.txt").read_text())
        print(f"[ptxas] BLOCK_K_HD32={bk}: " + " | ".join(ptxas), flush=True)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype) for x in qkv)
            out = attention.attention_fwd_cuda(q, k, v, pad, scale, lib=lib)
            ref = attention.attention_reference(q, k, v, pad, scale)
            err = float((out.float() - ref.float()).abs().max())
            if not err <= TOL[dtype]:
                raise AssertionError(f"BLOCK_K_HD32={bk} {dtype}: max|d| {err}")
            ms = _time_ms(lambda: attention.attention_fwd_cuda(q, k, v, pad, scale, lib=lib))
            rec = dict(block_k=bk, dtype=str(dtype).split(".")[-1], max_abs_err=err, ms=ms)
            print(f"[sweep] {rec}", flush=True)
            results.append(rec)
    print(json.dumps({"card": card, "shape": SHAPE, "sweep": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
