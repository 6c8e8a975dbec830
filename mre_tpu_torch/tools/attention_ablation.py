"""Where the attention kernel's time goes, by switching its parts off, on one CUDA card.

    python -m mre_tpu_torch.tools.attention_ablation

There is no hardware profiler on the card's machine, so this tool builds
copies of ``csrc/attention_fwd.cu`` (into ``mre_tpu_torch/_build/ablation/``)
in which one part of the Hopper body is compiled out: S = Q·K^T (``no_s``),
O += P·V (``no_pv``), both (``no_mma``), the online softmax
(``no_softmax``), float32's hi/lo split of the K and V tiles (``no_split``),
or all of them (``no_compute``: the TMA ring, the Q loads and the O stores
alone). Each build is timed with CUDA events at the tile sweep's four
main-path shapes in float32 and bfloat16, twice in turns; the full build
(``base``) is checked against the plain version first. An ablated build
computes nothing meaningful: only its time is read, as the time of what is
left. Prints each (shape, dtype, build)'s times, each build's blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and one JSON line.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.ops import attention
from mre_tpu_torch.tools.tile_sweep import SHAPES, TOL, _inputs, _time_ms
from mre_tpu_torch.utils import build

# the Hopper body's parts: (first line, last line) of each, as they appear in
# attention_fwd.cu; the switch compiles the lines between them out
PARTS = {
    "ATTN_ABLATE_S": ("auto qk = [&](int it) {", "wgmma_commit();"),
    "ATTN_ABLATE_PV": ("auto pv = [&](uint32_t v) {", "wgmma_commit();"),
    "ATTN_ABLATE_SOFTMAX": ("auto softmax = [&](const float* ct, float& c0, float& c1) {",
                            "    };"),
}
SPLIT = "split_tile<HD, BK, CONSUMERS,"
VARIANTS = {"base": (), "no_s": ("ATTN_ABLATE_S",), "no_pv": ("ATTN_ABLATE_PV",),
            "no_mma": ("ATTN_ABLATE_S", "ATTN_ABLATE_PV"),
            "no_softmax": ("ATTN_ABLATE_SOFTMAX",), "no_split": ("ATTN_ABLATE_SPLIT",),
            "no_compute": ("ATTN_ABLATE_S", "ATTN_ABLATE_PV", "ATTN_ABLATE_SOFTMAX",
                           "ATTN_ABLATE_SPLIT")}
OCCUPANCY = """
extern "C" int occupancy(int head_dim, int dtype) {
    int n = -1;
#define ATTN_OCC(HD, T) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, \\
        wgmma::attention_fwd_kernel<HD, T>, wgmma::Cfg<T>::THREADS, wgmma::Layout<HD, T>::BYTES)
    if (dtype == 0 && head_dim == 32) ATTN_OCC(32, float);
    if (dtype == 0 && head_dim == 64) ATTN_OCC(64, float);
    if (dtype == 0 && head_dim == 80) ATTN_OCC(80, float);
    if (dtype == 1 && head_dim == 32) ATTN_OCC(32, __nv_bfloat16);
    if (dtype == 1 && head_dim == 64) ATTN_OCC(64, __nv_bfloat16);
    if (dtype == 1 && head_dim == 80) ATTN_OCC(80, __nv_bfloat16);
    return n;
}
"""


def ablated_source(src: str) -> str:
    """``src`` with each ``ATTN_ABLATE_*`` switch around its part of the
    Hopper kernel, and an ``occupancy`` entry point. Raises when a part is
    not found (the kernel changed: update ``PARTS``)."""
    lines = src.split("\n")
    start = next(i for i, line in enumerate(lines)
                 if "attention_fwd_kernel(const __grid_constant__" in line)

    def find(text, at):
        for i in range(at, len(lines)):
            if text in lines[i]:
                return i
        raise ValueError(f"attention_ablation: {text!r} not found in the kernel")

    for macro, (first, last) in PARTS.items():
        a = find(first, start)
        b = find(last, a + 1)
        keep = "        c0 = c1 = 1.f;\n" if macro == "ATTN_ABLATE_SOFTMAX" else ""
        lines[b] = f"#else\n{keep}#endif\n" + lines[b] if keep else "#endif\n" + lines[b]
        lines[a] += f"\n#ifndef {macro}"
    at = start
    for _ in range(2):                      # the K and the V split of a tile
        at = find(SPLIT, at + 1)
        end = find("tid);", at)
        lines[at] = "#ifndef ATTN_ABLATE_SPLIT\n" + lines[at]
        lines[end] += "\n#endif"
    return "\n".join(lines) + OCCUPANCY


def _build(item, path: Path) -> tuple[str, Path]:
    name, defines = item
    lib = path.with_name(f"{name}.so")
    proc = subprocess.run(build.nvcc_command(path, lib, defines), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{proc.stderr}")
    return name, lib


def main() -> int:
    dev = resolve_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    path = build.BUILD_DIR / "ablation" / "attention_fwd.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(ablated_source(attention._SOURCE.read_text()))
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(lambda item: _build(item, path), VARIANTS.items()))
    for name, lib in libs.items():
        libs[name] = attention.bind(lib)
        libs[name].occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
        libs[name].occupancy.restype = ctypes.c_int

    gen = torch.Generator().manual_seed(0)
    inputs = {name: _inputs(shape, dev, gen) for name, shape in SHAPES.items()}
    results = []
    for rnd, (name, shape), dtype in itertools.product(
            range(2), SHAPES.items(), (torch.float32, torch.bfloat16)):
        (q, k, v), pad = [x.to(dtype) for x in inputs[name][0]], inputs[name][1]
        scale = shape[-1] ** -0.5
        for build, lib in libs.items():
            if build == "base":
                out = attention.attention_fwd_cuda(q, k, v, pad, scale, lib=lib)
                err = float((out.float() - attention.attention_reference(
                    q, k, v, pad, scale).float()).abs().max())
                if not err <= TOL[dtype]:
                    raise AssertionError(f"base {name} {dtype}: max|d| {err}")
            ms = _time_ms(lambda: attention.attention_fwd_cuda(q, k, v, pad, scale, lib=lib))
            rec = dict(build=build, round=rnd, shape=name, dtype=str(dtype).split(".")[-1], ms=ms)
            print(f"[ablation] {rec}", flush=True)
            results.append(rec)
    occupancy = {build: {f"hd{hd} {dt}": lib.occupancy(hd, code)
                         for (dt, code), hd in itertools.product(
                             (("float32", 0), ("bfloat16", 1)), attention.HEAD_DIMS)}
                 for build, lib in libs.items()}
    for build, occ in occupancy.items():
        print(f"[occupancy] {build}: {occ} blocks per SM", flush=True)
    print(json.dumps({"card": card, "shapes": SHAPES, "ablation": results,
                      "occupancy": occupancy}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
