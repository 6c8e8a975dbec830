"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller passes a device. With no
card present and no device given they raise: the port never drops to the
CPU on its own.

Resolving a device also turns TF32 off for float32 matrix products and
cuDNN convolutions. The JAX reference computes in full float32, and TF32
keeps only about three decimal digits, which would move the port's
embeddings (and near-tied ranks) away from the reference's.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); else the given device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly "
                "to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
