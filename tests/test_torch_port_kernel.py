"""The Hopper attention kernel vs its plain twin, on the card only.

This module imports no JAX (the card's machine has none), so it runs there
without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_port_kernel.py -m cuda

Tolerances: float32 atol 1e-4 (online vs two-pass softmax, another
summation order); bfloat16 atol 2e-2 (both round the float32 result to
bfloat16 once, one ulp of an O(1) value is 2^-8).
"""

import numpy as np
import pytest
import torch

from mre_tpu_torch.ops import attention as port

pytestmark = pytest.mark.cuda


def _case(B, H, N, hd, dtype, mask_kind, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, N, hd, generator=g).cuda().to(dtype) for _ in range(3))
    pad = None
    if mask_kind != "none":
        pad = torch.zeros(B, N)
        pad[:, N - min(7, N - 1):] = 1.0
        if mask_kind == "all_but_first":
            pad[0, 1:] = 1.0
        elif mask_kind == "all":
            pad[0, :] = 1.0
        pad = pad.cuda()
    return q, k, v, pad


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["none", "tail", "all_but_first", "all"])
@pytest.mark.parametrize("N", [1, 37, 64, 130, 321])
def test_kernel_matches_plain(hd, dtype, mask_kind, N):
    q, k, v, pad = _case(3, 4, N, hd, dtype, mask_kind, seed=N + hd)
    before = port.LAUNCHES["attention_fwd"]
    out = port.attention_fwd_cuda(q, k, v, pad, hd ** -0.5)
    torch.cuda.synchronize()
    assert port.LAUNCHES["attention_fwd"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = port.attention_reference(q, k, v, pad, hd ** -0.5)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, pad = _case(2, 2, 9, 64, torch.float32, "tail", seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        port.attention_fwd_cuda(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                v[..., :32].contiguous(), pad, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        port.attention_fwd_cuda(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), None, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        port.attention_fwd_cuda(q.half(), k.half(), v.half(), pad, 0.1)
    with pytest.raises(ValueError, match="padding_mask"):
        port.attention_fwd_cuda(q, k, v, pad.double(), 0.1)


def test_autograd_forward_launches_kernel_backward_recomputes():
    q, k, v, pad = _case(2, 3, 50, 64, torch.float32, "tail", seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = port.LAUNCHES["attention_fwd"]
    out = port.fused_attention(*leaves, pad, 0.125)
    (out ** 2).sum().backward()
    assert port.LAUNCHES["attention_fwd"] == before + 1
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (port.attention_reference(*ref_leaves, pad, 0.125) ** 2).sum().backward()
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_allclose(a.grad.cpu().numpy(), b.grad.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
