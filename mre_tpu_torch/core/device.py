"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller passes a device. With no
card present and no device given, or a ``cuda`` device given, they raise:
the port never drops to the CPU on its own. A rank of a process mesh
(``parallel/mesh.py``) takes ``rank_device``: card ``local_rank % cards``
unless the caller passes another device; several ranks may share a card.

Resolving a device also turns TF32 off for float32 matrix products and
cuDNN convolutions. The JAX reference computes in full float32, and TF32
keeps only about three decimal digits, which would move the port's
embeddings (and near-tied ranks) away from the reference's.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; else the given device. A ``cuda`` device raises
    without a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly "
            "to run the plain PyTorch path on the CPU")
    return device


def rank_device(local_rank: int, device: str | torch.device | None = None) -> torch.device:
    """The device of the rank ``local_rank`` on its host: ``cuda:(local_rank
    % device_count)`` for None or an unindexed ``cuda``, else ``device``
    (the CPU only when asked for). Raises without a card as
    ``resolve_device`` does."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device
