"""Fused masked multi-head attention: the Hopper kernel and its plain twin.

Port of mre_tpu/ops/pallas/attention.py (``fused_attention``,
``_attention_kernel``, ``_attention_reference``). Layouts are the JAX
package's: q, k, v ``[B, H, N, hd]``, ``padding_mask`` ``[B, N]`` with
1.0 = PAD. Masked logits are where-selected to −1e7 before the softmax.

* ``attention_reference`` — plain PyTorch, einsums in float32. The CPU path,
  the comparison in ``chip_smoke.py`` and ``attention_impl="torch"`` use it.
* ``attention_fwd_cuda`` — launches the hand-written sm_90a kernel in
  ``csrc/attention_fwd.cu``. The kernel is compiled with ``nvcc`` at first
  use into ``mre_tpu_torch/_build/`` and bound through a plain C interface
  with ``ctypes``. ``LAUNCHES["attention_fwd"]`` counts its launches.
* ``FusedAttention`` — the ``jax.custom_vjp`` split of the JAX package: the
  forward runs the kernel on a CUDA tensor and the plain version on a CPU
  tensor; the backward recomputes through the plain version, as ``_bwd``
  does in JAX (no backward kernel exists there either).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "attention_fwd.cu"
BUILD_DIR = _PKG / "_build"
HEAD_DIMS = (64, 80)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"attention_fwd": 0}
_lib = None


def attention_reference(q, k, v, padding_mask, scale):
    """Plain twin of ``_attention_reference`` (attention.py:139-147)."""
    att = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if padding_mask is not None:
        att = att.masked_fill(padding_mask[:, None, None, :] > 0, -1e7)
    att = torch.softmax(att, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", att, v.float()).to(q.dtype)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the attention kernel is built "
                           "from csrc/attention_fwd.cu on a machine with the "
                           "CUDA toolkit")
    return found


def build() -> Path:
    """Compile ``csrc/attention_fwd.cu`` for sm_90a (once per source hash)."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libattention_fwd-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    (BUILD_DIR / "attention_fwd.ptxas.txt").write_text(proc.stderr)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.attention_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def attention_fwd_cuda(q, k, v, padding_mask, scale: float):
    """Launch the Hopper kernel on CUDA tensors; raises on any input it does
    not take (no fallback)."""
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
    mask_ptr = None
    if padding_mask is not None:
        if (padding_mask.device != q.device or padding_mask.dtype != torch.float32
                or tuple(padding_mask.shape) != (B, N)
                or not padding_mask.is_contiguous()):
            raise ValueError("attention_fwd_cuda: padding_mask must be a "
                             "contiguous float32 [B, N] tensor on q's device")
        mask_ptr = padding_mask.data_ptr()
    lib = _load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               mask_ptr, out.data_ptr(), B, H, N, hd,
                               _DTYPES[q.dtype], float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed with CUDA error {rc}")
    LAUNCHES["attention_fwd"] += 1
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
