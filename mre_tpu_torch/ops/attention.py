"""Fused masked multi-head attention: the Hopper kernel and its plain twin.

Port of mre_tpu/ops/pallas/attention.py (``fused_attention``,
``_attention_kernel``, ``_attention_kernel_packed``, ``_attention_reference``).
Layouts are the JAX package's: q, k, v ``[B, H, N, hd]``, ``padding_mask``
``[B, N]`` with 1.0 = PAD. Masked logits are where-selected to −1e7 before
the softmax.

* ``attention_reference`` — plain PyTorch, einsums in float32. The CPU path,
  the comparison in ``chip_smoke.py`` and ``attention_impl="torch"`` use it.
* ``attention_fwd_cuda`` — launches the hand-written sm_90a kernel in
  ``csrc/attention_fwd.cu``, a flash-attention forward on the tensor cores
  in one design at every head_dim (32, 64, 80; ``WGMMA_INSTANTIATIONS``):
  warpgroup MMA (``wgmma``) fed by TMA tile loads that complete on
  ``mbarrier``s, three TF32 passes in float32 (the K/V tiles split into hi
  and lo in shared memory), P split into bf16 hi + lo in bfloat16. The
  kernel is compiled with ``nvcc`` at first
  use into ``mre_tpu_torch/_build/`` and bound through a plain C interface
  with ``ctypes``. One kernel serves both TPU bodies: head_dim 64 and 80
  (M3AE-small's and M3AE-huge's encoders) stand for ``_attention_kernel``
  and count in ``LAUNCHES["attention_fwd"]``;
  head_dim 32 (the M3AE decoder) stands for ``_attention_kernel_packed``,
  whose head packing is a TPU lane-layout device, and counts in
  ``LAUNCHES["attention_fwd_packed"]``. ``LAUNCHES_BY_DTYPE`` splits each
  count by the inputs' dtype (``"attention_fwd.bfloat16"``, ...) and
  ``LAUNCHES_BY_HEAD_DIM`` by instantiation (``"hd80.float32"``, ...), so a
  caller can tell which instantiation ran; ``reset_launches`` zeroes all
  three.
* ``FusedAttention`` — the ``jax.custom_vjp`` split of the JAX package: the
  forward runs the kernel on a CUDA tensor and the plain version on a CPU
  tensor; the backward recomputes through the plain version, as ``_bwd``
  does in JAX (no backward kernel exists there either).
* ``grouped_attention`` — the LFM2 encoder's entry (``models/lfm2.py``), which
  the JAX package does not have: causal attention with grouped KV heads
  (k, v ``[B, H_kv, N, hd]``; query head h reads KV head ``h // (H // H_kv)``),
  forward only (the encoder serves, it is not trained). On CUDA tensors it
  launches the kernel's causal instantiations (``CAUSAL_INSTANTIATIONS``: the
  same body, skipping the key tiles above a block's diagonal and masking the
  diagonal tile, K and V loaded at the KV head's TMA coordinate), counted in
  ``LAUNCHES_BY_HEAD_DIM["hd64.causal_gqa4.float32"]`` and so on.
  ``attention_reference(..., causal=True)`` is its plain twin.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import torch

from mre_tpu_torch.utils import build as _build

_SOURCE = _build.CSRC / "attention_fwd.cu"
HEAD_DIMS = (32, 64, 80)
# the instantiations built on wgmma + TMA: all of them. chip_smoke.py
# requires HGMMA and UTMALDG, and no HMMA, in each.
WGMMA_INSTANTIATIONS = frozenset({(32, "float32"), (64, "float32"), (80, "float32"),
                                  (32, "bfloat16"), (64, "bfloat16"), (80, "bfloat16")})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def causal_key(head_dim: int, dtype: str, group: int) -> str:
    """The ``LAUNCHES_BY_HEAD_DIM`` key of a causal instantiation."""
    return f"hd{head_dim}.causal_gqa{group}.{dtype}"


# the causal instantiations with grouped KV heads: (head_dim, dtype, query
# heads per KV head), LFM2-8B-A1B's 32 query heads over 8 KV heads of 64
CAUSAL_INSTANTIATIONS = frozenset({(64, "float32", 4), (64, "bfloat16", 4)})

LAUNCHES = {"attention_fwd": 0, "attention_fwd_packed": 0}
LAUNCHES_BY_DTYPE = {f"{k}.{d}": 0 for k in LAUNCHES for d in ("float32", "bfloat16")}
LAUNCHES_BY_HEAD_DIM = {f"hd{hd}.{d}": 0 for hd in HEAD_DIMS for d in ("float32", "bfloat16")}
LAUNCHES_BY_HEAD_DIM.update({causal_key(hd, d, g): 0 for hd, d, g in CAUSAL_INSTANTIATIONS})
_lib = None


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_DTYPE, LAUNCHES_BY_HEAD_DIM):
        for key in counts:
            counts[key] = 0


def launch_key(head_dim: int) -> str:
    """The counter of the TPU kernel body this head_dim stands for: below 64
    the JAX package takes ``_attention_kernel_packed``."""
    return "attention_fwd_packed" if head_dim < 64 else "attention_fwd"


def attention_reference(q, k, v, padding_mask, scale, causal: bool = False):
    """Plain twin of ``_attention_reference`` (attention.py:139-147). Its
    extension for ``grouped_attention``: k and v may hold fewer heads than q
    (query head h reads KV head ``h // (H // H_kv)``), and ``causal``
    excludes the keys after each query's own position (-inf, after the PAD
    select)."""
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k, v = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
    att = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if padding_mask is not None:
        att = att.masked_fill(padding_mask[:, None, None, :] > 0, -1e7)
    if causal:
        n = q.shape[2]
        later = torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1)
        att = att.masked_fill(later, float("-inf"))
    att = torch.softmax(att, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", att, v.float()).to(q.dtype)


def build(defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/attention_fwd.cu`` for sm_90a (``utils.build.build_cuda``:
    once per source hash and ``defines``, e.g. ``("ATTN_BLOCK_K=32",
    "ATTN_WG=1")`` for a tile sweep). The ptxas report goes beside the
    library."""
    return _build.build_cuda(_SOURCE, defines)


_ENTRY = re.compile(r"attention_fwd_kernelILi(\d+)E(f|13__nv_bfloat16)E")
_CAUSAL_ENTRY = re.compile(r"attention_fwd_causal_kernelILi(\d+)E(f|13__nv_bfloat16)Li(\d+)E")


def _instantiation(symbol: str):
    """(head_dim, dtype name) of a mangled kernel symbol, (head_dim, dtype
    name, query heads per KV head) of a causal one, or None."""
    m = _ENTRY.search(symbol)
    if m is not None:
        return int(m.group(1)), "float32" if m.group(2) == "f" else "bfloat16"
    m = _CAUSAL_ENTRY.search(symbol)
    if m is not None:
        return (int(m.group(1)), "float32" if m.group(2) == "f" else "bfloat16",
                int(m.group(3)))
    return None


def ptxas_report(text: str) -> dict:
    """``utils.build.ptxas_report``, each kernel named by its instantiation:
    ``{(hd, dtype): {"registers", "spill_stores", "spill_loads"}}``."""
    return _build.ptxas_report(text, _instantiation)


def sass_counts(sass: str) -> dict:
    """``utils.build.sass_counts``, each kernel named by its instantiation:
    ``{(hd, dtype): {"HMMA": n, "HGMMA": n, "UTMALDG": n}}``."""
    return _build.sass_counts(sass, _instantiation)


def build_report(lib: Path) -> dict:
    """``utils.build.build_report`` of a built library, each kernel named
    by its instantiation."""
    return _build.build_report(lib, _instantiation)


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its C entry point."""
    lib = ctypes.CDLL(str(path))
    lib.attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.attention_fwd.restype = ctypes.c_int
    lib.attention_fwd_causal.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.attention_fwd_causal.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def attention_fwd_cuda(q, k, v, padding_mask, scale: float, lib=None):
    """Launch the Hopper kernel on CUDA tensors; raises on any input it does
    not take (no fallback). ``lib``: a library from ``bind(build(defines))``
    in place of the default build (a tile sweep)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("attention_fwd_cuda: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention_fwd_cuda: dtype {q.dtype} not in "
                         f"{tuple(_DTYPES)} or q/k/v dtypes differ")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention_fwd_cuda: q, k, v must share one "
                         f"[B, H, N, hd] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, N, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention_fwd_cuda: head_dim {hd} not in {HEAD_DIMS}")
    if B * H > 65535:                      # one grid row per (b, h): gridDim.y limit
        raise ValueError(f"attention_fwd_cuda: B·H = {B * H} exceeds 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention_fwd_cuda: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):   # TMA: 16-byte bases
        raise ValueError("attention_fwd_cuda: q, k, v must start 16-byte aligned")
    mask_ptr = None
    if padding_mask is not None:
        if (padding_mask.device != q.device or padding_mask.dtype != torch.float32
                or tuple(padding_mask.shape) != (B, N)
                or not padding_mask.is_contiguous()):
            raise ValueError("attention_fwd_cuda: padding_mask must be a "
                             "contiguous float32 [B, N] tensor on q's device")
        mask_ptr = padding_mask.data_ptr()
    lib = lib if lib is not None else _load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               mask_ptr, out.data_ptr(), B, H, N, hd,
                               _DTYPES[q.dtype], float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed with CUDA error {rc}")
    dtype = str(q.dtype).split(".")[-1]
    LAUNCHES[launch_key(hd)] += 1
    LAUNCHES_BY_DTYPE[f"{launch_key(hd)}.{dtype}"] += 1
    LAUNCHES_BY_HEAD_DIM[f"hd{hd}.{dtype}"] += 1
    return out


def attention_fwd_causal_cuda(q, k, v, padding_mask, scale: float, lib=None):
    """Launch the kernel's causal instantiation with grouped KV heads on CUDA
    tensors: q ``[B, H, N, hd]``, k and v ``[B, H_kv, N, hd]``; raises on any
    input it does not take (no fallback)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("attention_fwd_causal_cuda: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention_fwd_causal_cuda: dtype {q.dtype} not in "
                         f"{tuple(_DTYPES)} or q/k/v dtypes differ")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("attention_fwd_causal_cuda: q [B, H, N, hd] and k, v "
                         f"[B, H_kv, N, hd], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, N, hd = q.shape
    H_kv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, N, hd) or H % H_kv:
        raise ValueError(f"attention_fwd_causal_cuda: k, v {tuple(k.shape)} do not group "
                         f"the heads of q {tuple(q.shape)}")
    dtype = str(q.dtype).split(".")[-1]
    if (hd, dtype, H // H_kv) not in CAUSAL_INSTANTIATIONS:
        raise ValueError(f"attention_fwd_causal_cuda: no causal instantiation at head_dim "
                         f"{hd}, {dtype}, {H // H_kv} query heads per KV head "
                         f"(has {sorted(CAUSAL_INSTANTIATIONS)})")
    if B * H > 65535:
        raise ValueError(f"attention_fwd_causal_cuda: B·H = {B * H} exceeds 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention_fwd_causal_cuda: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention_fwd_causal_cuda: q, k, v must start 16-byte aligned")
    mask_ptr = None
    if padding_mask is not None:
        if (padding_mask.device != q.device or padding_mask.dtype != torch.float32
                or tuple(padding_mask.shape) != (B, N)
                or not padding_mask.is_contiguous()):
            raise ValueError("attention_fwd_causal_cuda: padding_mask must be a "
                             "contiguous float32 [B, N] tensor on q's device")
        mask_ptr = padding_mask.data_ptr()
    lib = lib if lib is not None else _load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attention_fwd_causal(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
                                      out.data_ptr(), B, H, H_kv, N, hd, _DTYPES[q.dtype],
                                      float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd_causal launch failed with CUDA error {rc}")
    LAUNCHES_BY_HEAD_DIM[causal_key(hd, dtype, H // H_kv)] += 1
    return out


class FusedAttention(torch.autograd.Function):
    """Kernel forward (plain version for CPU tensors); the backward
    recomputes through ``attention_reference`` (attention.py:193-202)."""

    @staticmethod
    def forward(ctx, q, k, v, padding_mask, scale):
        ctx.save_for_backward(q, k, v, padding_mask)
        ctx.scale = scale
        if q.is_cuda:
            return attention_fwd_cuda(q, k, v, padding_mask, scale)
        return attention_reference(q, k, v, padding_mask, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, padding_mask = ctx.saved_tensors
        with torch.enable_grad():
            q_, k_, v_ = (t.detach().requires_grad_() for t in (q, k, v))
            out = attention_reference(q_, k_, v_, padding_mask, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (q_, k_, v_), g)
        return dq, dk, dv, None, None


class _CausalLaunch(torch.autograd.Function):
    """The causal kernel's launch as an op of its own, forward only (no
    backward: the LFM2 encoder serves, it is not trained). A ctypes launch
    made outside any op is linked to no op in the profiler's device trace;
    inside this one, its time counts inside the spans around the call, as
    ``FusedAttention``'s does."""

    @staticmethod
    def forward(ctx, q, k, v, padding_mask, scale):
        return attention_fwd_causal_cuda(q, k, v, padding_mask, scale)


def fused_attention(q, k, v, padding_mask, scale: float, impl: str = "auto"):
    """q, k, v: [B, H, N, hd]; padding_mask: [B, N] with 1.0 = PAD.

    ``impl``: ``auto`` launches the kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``kernel`` insists on the kernel (a CPU
    tensor raises); ``torch`` runs the plain version on any device."""
    if impl == "torch":
        return attention_reference(q, k, v, padding_mask, scale)
    if impl not in ("auto", "kernel"):
        raise ValueError(f"unknown attention impl {impl!r} (auto | kernel | torch)")
    if impl == "kernel" and not q.is_cuda:
        raise ValueError("attention_impl='kernel' needs CUDA tensors; "
                         "the kernel has no CPU form")
    return FusedAttention.apply(q, k, v, padding_mask, scale)


def grouped_attention(q, k, v, padding_mask, scale: float, impl: str = "auto"):
    """Causal attention, forward only. q: [B, H, N, hd]; k, v: [B, H_kv, N,
    hd], query head h reading KV head ``h // (H // H_kv)``; padding_mask: [B,
    N] with 1.0 = PAD, or None.

    ``impl`` as in ``fused_attention``: ``auto`` launches the causal kernel
    for CUDA tensors and runs ``attention_reference`` for CPU tensors;
    ``kernel`` insists on the kernel; ``torch`` runs the plain version."""
    if k.shape[1] != v.shape[1] or q.shape[1] % k.shape[1]:
        raise ValueError(f"grouped_attention: k and v must hold one number of KV heads that "
                         f"divides q's {q.shape[1]}, got {tuple(k.shape)}, {tuple(v.shape)}")
    if impl == "torch" or (impl == "auto" and not q.is_cuda):
        return attention_reference(q, k, v, padding_mask, scale, causal=True)
    if impl not in ("auto", "kernel"):
        raise ValueError(f"unknown attention impl {impl!r} (auto | kernel | torch)")
    if not q.is_cuda:
        raise ValueError("attention_impl='kernel' needs CUDA tensors; "
                         "the kernel has no CPU form")
    return _CausalLaunch.apply(q, k, v, padding_mask, scale)
