"""Float32 linear products on Hopper's tensor cores at float32 accuracy.

``linear(x, weight, bias)`` is the port's float32 ``Dense`` product
``x · weightᵀ + bias``, with ``weight`` ``[N, K]`` as ``nn.Linear`` holds it
(``models/initializers.py::dense``, the LFM2 experts in ``models/lfm2.py``).
It routes by what the call shows, never by a setting:

* ``gemm_f32x3`` — the hand-written sm_90a kernel in ``csrc/gemm_f32x3.cu``:
  a ``wgmma`` GEMM fed by TMA in three TF32 passes (hi·hi + hi·lo + lo·hi,
  hi the operand rounded to TF32, lo the exact rest), float32 accumulators,
  the bias in its epilogue. It takes a CUDA float32 product that autograd
  needs nothing from (grad off, or no operand requiring it), with K % 4 == 0
  (TMA's 16-byte strides) and a contiguous 16-byte aligned weight, at any
  row count (``_kernel_takes``, asked on every device; the checks
  themselves are ``_refusal``'s, which ``gemm_f32x3`` raises). Built with
  ``nvcc`` at first use into ``mre_tpu_torch/_build/``
  (``utils.build.build_cuda``), bound through a plain C interface with
  ``ctypes`` and launched inside an op of its own (``_Launch``), so that a
  profiler links its device time to the spans around the call.
* ``F.linear`` — everything else: a CPU tensor (so no CPU number moves), a
  product under autograd (its backward's products are not K-major for
  TF32 ``wgmma``), bfloat16, and the shapes the kernel does not take, each
  by an explicit check (no ``try`` that falls back).

``split_tf32`` and ``linear_reference`` are the kernel's plain twins: the
split it makes and its three passes, in plain PyTorch. ``LAUNCHES`` counts
the kernel's launches (``reset_launches`` zeroes it); while tracing is on,
``core/profiling`` counts ``linear.f32x3`` (the kernel) and
``linear.cublas`` (a CUDA product routed to ``F.linear``).
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import torch
import torch.nn.functional as F

from mre_tpu_torch.core.profiling import count
from mre_tpu_torch.utils import build as _build

_SOURCE = _build.CSRC / "gemm_f32x3.cu"
# the kernels of the library, and the one whose name the benchmark's GEMM
# pattern (portbench/trace.py) must match
KERNELS = ("gemm_f32x3_kernel", "gemm_tf32_split_kernel")
LAUNCHES = {"gemm_f32x3": 0}
_TF32_MASK = -0x2000                    # 0xffffe000: sign, exponent, 10 mantissa bits
_lib = None


def reset_launches() -> None:
    LAUNCHES["gemm_f32x3"] = 0


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``x`` = hi + lo: hi is x rounded to the nearest TF32 (ties
    away from zero) by an integer add and a mask, as the kernel makes it;
    lo = x − hi, exact in float32."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & _TF32_MASK).view(torch.float32)
    return hi, x - hi


def tf32(x: torch.Tensor) -> torch.Tensor:
    """The TF32 the tensor core reads from a float32: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & _TF32_MASK).view(torch.float32)


def linear_reference(x, weight, bias=None):
    """The kernel's three passes in plain PyTorch: hi·hi + hi·lo + lo·hi,
    each lo read as TF32, summed in one float32 product over the three
    passes' K."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(weight)
    return F.linear(torch.cat([tf32(xl), xh, xh], -1), torch.cat([wh, tf32(wl), wh], -1), bias)


def build() -> Path:
    """Compile ``csrc/gemm_f32x3.cu`` for sm_90a, once per source hash."""
    return _build.build_cuda(_SOURCE)


def _kernel_name(symbol: str):
    """The kernel of a mangled symbol in the ptxas or cuobjdump listing."""
    m = re.search(r"(gemm_f32x3_kernel|gemm_tf32_split_kernel)", symbol)
    return None if m is None else m.group(1)


def build_report(lib: Path) -> dict:
    """``utils.build.build_report`` of this library: registers, spills,
    SASS counts and ptxas's ``wgmma`` serialisation per kernel
    (``KERNELS``)."""
    return _build.build_report(lib, _kernel_name)


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its C entry point."""
    lib = ctypes.CDLL(str(path))
    lib.gemm_f32x3.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.gemm_f32x3.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def _refusal(x, weight, bias) -> str | None:
    """Why the kernel does not take ``x · weightᵀ + bias`` (None: it does),
    asked on any device and at any row count: float32 operands on one
    device that autograd needs nothing from, ``weight`` ``[N, K]`` with
    K % 4 == 0 (TMA's 16-byte strides), contiguous and 16-byte aligned, a
    contiguous ``bias`` ``[N]``, at least one row (over every leading
    dimension of ``x``, which may have any layout)."""
    operands = (x, weight) if bias is None else (x, weight, bias)
    if any(t.dtype != torch.float32 for t in operands):
        return "x, weight and bias must be float32"
    if any(t.device != x.device for t in operands):
        return "x, weight and bias must lie on one device"
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return "autograd needs this product, and the kernel has no backward"
    if weight.dim() != 2 or x.dim() == 0 or x.shape[-1] != weight.shape[1]:
        return f"x [..., K] and weight [N, K], got {tuple(x.shape)}, {tuple(weight.shape)}"
    K, N = weight.shape[1], weight.shape[0]
    if x.numel() == 0 or N == 0 or K % 4:
        return (f"M, N, K must be positive and K % 4 == 0 (TMA's 16-byte strides), "
                f"got {tuple(x.shape)}, N {N}")
    if bias is not None and tuple(bias.shape) != (N,):
        return f"bias must be [{N}], got {tuple(bias.shape)}"
    if not (weight.is_contiguous() and (bias is None or bias.is_contiguous())):
        return "weight and bias must be contiguous"
    if weight.data_ptr() % 16:
        return "weight must start 16-byte aligned"
    return None


def _kernel_takes(x, weight, bias) -> bool:
    """Whether ``linear`` launches the kernel for this product (module
    docstring): whether ``_refusal`` finds nothing. The rows do not route:
    a row's result must not depend on the rows beside it, which
    ``FusionTrainer.generate``'s one encoding per distinct description
    relies on (cuBLAS under a row count and the kernel over it moved its
    rows by 1.2e-6 on an H100). Small products pay host time for it: a
    launch costs ~33 µs against ``F.linear``'s ~18 (PERF.md §6)."""
    return _refusal(x, weight, bias) is None


def gemm_f32x3(x, weight, bias=None):
    """``x · weightᵀ + bias`` by the kernel at any row count: x ``[..., K]``
    on a CUDA device, weight ``[N, K]``, bias ``[N]`` or None; raises on
    operands it does not take (``_refusal``; no fallback)."""
    if not x.is_cuda:
        raise ValueError("gemm_f32x3: x must lie on a CUDA device")
    why = _refusal(x, weight, bias)
    if why is not None:
        raise ValueError(f"gemm_f32x3: {why}")
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.data_ptr() % 16:                # a view at an odd offset: TMA wants 16 bytes
        x2 = x2.clone()
    return _Launch.apply(x2, weight, bias).view(*x.shape[:-1], weight.shape[0])


def _launch(x, weight, bias):
    """The launch, on operands ``gemm_f32x3`` has checked: x ``[M, K]``
    contiguous and 16-byte aligned."""
    M, K = x.shape
    N = weight.shape[0]
    lib = _load()
    split = torch.empty(2, N, K, dtype=torch.float32, device=x.device)
    y = torch.empty(M, N, dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
            split.data_ptr(), y.data_ptr(), M, N, K,
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        rc = lib.gemm_f32x3(*args)
    else:                                  # the C code launches on the current device
        with torch.cuda.device(x.device):
            rc = lib.gemm_f32x3(*args)
    if rc != 0:
        raise RuntimeError(f"gemm_f32x3 launch failed with CUDA error {rc}")
    LAUNCHES["gemm_f32x3"] += 1
    return y


class _Launch(torch.autograd.Function):
    """The kernel's launch as an op of its own, forward only (``_refusal``
    keeps every product autograd needs away from it): a ctypes launch made
    outside any op is linked to no op in a profiler's device trace; inside
    this one its time counts inside the spans around the call."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        return _launch(x, weight, bias)


def linear(x, weight, bias=None):
    """``F.linear(x, weight, bias)`` in float32, on the kernel where it
    takes the product (module docstring), on ``F.linear`` otherwise."""
    takes = _kernel_takes(x, weight, bias)
    if not x.is_cuda:
        return F.linear(x, weight, bias)
    if not takes:
        count("linear.cublas", 1)
        return F.linear(x, weight, bias)
    count("linear.f32x3", 1)
    return gemm_f32x3(x, weight, bias)
