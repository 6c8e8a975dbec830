"""Tile sweep of the attention kernel on one CUDA card.

    python -m mre_tpu_torch.tools.tile_sweep [--block-k 32 64] [--wg 1 2] [--stages 2 3 4]

Builds ``csrc/attention_fwd.cu`` once per (``ATTN_BLOCK_K``, ``ATTN_WG``,
``ATTN_STAGES``) of the Hopper design (keys per TMA tile, consumer
warpgroups of 64 query rows per block, tiles in the TMA ring); nvcc runs
in parallel. Each build is checked against the plain
version and timed with CUDA events, in float32 and bfloat16, at four
main-path shapes: the decoder of the training step (B 60, H 16, N 321,
hd 32), the entity sweep of serving (B 512, H 6, N 321, hd 64), the
training step's nodes (B 60, H 6, N 321, hd 64) and M3AE-huge's entity
sweep (B 512, H 16, N 321, hd 80), all with entity-style padding. Builds
are timed in turns, twice, so a drift of the card's clock shows as a
difference between the two rounds. Prints the ptxas registers and spills
of every instantiation of each build and one JSON line of results; a tile
that does not fit in shared memory at a head_dim is reported as refused
there (float32 at hd 80 with 64-key tiles).
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

SHAPES = {"decoder": (60, 16, 321, 32), "entity": (512, 6, 321, 64),
          "train_nodes": (60, 6, 321, 64), "huge_entity": (512, 16, 321, 80)}
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


def tiles(block_k, wg, stages) -> dict:
    """{label: nvcc defines} of the builds to sweep."""
    out = {}
    for bk, w, st in itertools.product(block_k, wg, stages):
        out[f"bk{bk}_wg{w}_st{st}"] = (f"ATTN_BLOCK_K={bk}", f"ATTN_WG={w}",
                                       f"ATTN_STAGES={st}")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--block-k", type=int, nargs="+", default=[32, 64])
    p.add_argument("--wg", type=int, nargs="+", default=[1, 2])
    p.add_argument("--stages", type=int, nargs="+", default=[2, 3, 4])
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()
    dev = resolve_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    builds = tiles(args.block_k, args.wg, args.stages)
    with ThreadPoolExecutor(len(builds)) as pool:
        paths = dict(zip(builds, pool.map(attention.build, builds.values())))

    gen = torch.Generator().manual_seed(0)
    inputs = {name: _inputs(shape, dev, gen) for name, shape in SHAPES.items()}
    libs = {}
    for label, path in paths.items():
        libs[label] = attention.bind(path)
        report = attention.ptxas_report(path.with_suffix(".ptxas.txt").read_text())
        print(f"[ptxas] {label}: " + " | ".join(
            f"hd{hd} {dt}: {r.get('registers')} registers, {r.get('spill_stores')} B spilled"
            for (hd, dt), r in sorted(report.items())), flush=True)

    results = []
    for rnd, ((name, shape), dtype, label) in itertools.product(
            range(args.rounds), itertools.product(SHAPES.items(),
                                                  (torch.float32, torch.bfloat16), libs)):
        lib = libs[label]
        (q, k, v), pad = [x.to(dtype) for x in inputs[name][0]], inputs[name][1]
        scale = shape[-1] ** -0.5
        rec = dict(build=label, defines=builds[label], round=rnd, shape=name,
                   dtype=str(dtype).split(".")[-1])
        try:
            out = attention.attention_fwd_cuda(q, k, v, pad, scale, lib=lib)
        except RuntimeError as e:                # e.g. the tile outgrows shared memory
            rec["refused"] = str(e)
        else:
            ref = attention.attention_reference(q, k, v, pad, scale)
            err = float((out.float() - ref.float()).abs().max())
            if not err <= TOL[dtype]:
                raise AssertionError(f"{label} {name} {dtype}: max|d| {err}")
            rec.update(max_abs_err=err, ms=_time_ms(
                lambda: attention.attention_fwd_cuda(q, k, v, pad, scale, lib=lib)))
        print(f"[sweep] {rec}", flush=True)
        results.append(rec)
    print(json.dumps({"card": card, "shapes": SHAPES, "sweep": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
