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


@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["none", "tail", "all_but_first", "all"])
# N on either side of the 16-row warp tile, the 32-key tile, the 64-row
# query tile and the serving length 321: ragged last tiles, idle warps
@pytest.mark.parametrize("N", [1, 15, 16, 17, 37, 63, 64, 65, 127, 129, 130, 320, 321, 322])
def test_kernel_matches_plain(hd, dtype, mask_kind, N):
    q, k, v, pad = _case(3, 4, N, hd, dtype, mask_kind, seed=N + hd)
    before = dict(port.LAUNCHES)
    out = port.attention_fwd_cuda(q, k, v, pad, hd ** -0.5)
    torch.cuda.synchronize()
    # one launch, counted under the TPU kernel body this head_dim stands for
    key = "attention_fwd_packed" if hd < 64 else "attention_fwd"
    assert port.LAUNCHES == {**before, key: before[key] + 1}
    assert out.dtype == dtype and out.shape == q.shape
    ref = port.attention_reference(q, k, v, pad, hd ** -0.5)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_many_waves(hd, dtype):
    """B·H = 1024 at N 321: several thousand blocks, many waves per SM."""
    q, k, v, pad = _case(64, 16, 321, hd, dtype, "tail", seed=hd)
    out = port.attention_fwd_cuda(q, k, v, pad, hd ** -0.5)
    torch.cuda.synchronize()
    ref = port.attention_reference(q, k, v, pad, hd ** -0.5)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [17, 65, 321])
def test_kernel_tiles_stay_inside_their_head(hd, dtype, N):
    """The TMA tensor maps are [B·H, N, hd]: a key tile that runs past N is
    zero-filled inside its own (b, h), never read from the next head. Every
    odd head's K and V hold NaN: a leaked key's logit is NaN even under the
    past-N code (NaN·0 − inf), and a leaked value row adds 0·NaN = NaN, so a
    leak into the even head before it poisons that head's output. A store
    of the even head's rows past N into the odd head after it would leave
    finite values where every output of an odd head is NaN. At hd 80 the
    last box of each row runs past hd: its pad columns are zero-filled,
    never read from the next row."""
    q, k, v, pad = _case(2, 4, N, hd, dtype, "tail", seed=N + hd)
    k[:, 1::2] = float("nan")
    v[:, 1::2] = float("nan")
    out = port.attention_fwd_cuda(q, k, v, pad, hd ** -0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out[:, 0::2]).all())
    assert bool(torch.isnan(out[:, 1::2]).all())
    ref = port.attention_reference(q, k, v, pad, hd ** -0.5)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out[:, 0::2].float(), ref[:, 0::2].float(), rtol=0, atol=atol)


@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_all_rows_in_one_partial_tile(hd, dtype):
    """N 40 < 64: every query row lies in one partial 64-row tile (rows past
    N zero-filled and never stored), with PAD tails and a fully masked row."""
    q, k, v, pad = _case(5, 3, 40, hd, dtype, "all_but_first", seed=hd)
    pad[1] = 1.0
    out = port.attention_fwd_cuda(q, k, v, pad, hd ** -0.5)
    torch.cuda.synchronize()
    ref = port.attention_reference(q, k, v, pad, hd ** -0.5)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


def test_wrapper_refuses_unaligned_base():
    """TMA takes 16-byte aligned bases: a q that starts one
    element into its storage is refused, not copied."""
    q, k, v, pad = _case(2, 2, 9, 64, torch.float32, "tail", seed=3)
    shifted = torch.empty(q.numel() + 1, device=q.device)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        port.attention_fwd_cuda(shifted, k, v, pad, 0.1)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, pad = _case(2, 2, 9, 64, torch.float32, "tail", seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        port.attention_fwd_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                v[..., :48].contiguous(), pad, 0.1)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_huge_head_dim_counts_by_instantiation(dtype):
    """head_dim 80 (M3AE-huge's encoder) counts under ``attention_fwd`` and
    under its own instantiation, nowhere else."""
    q, k, v, pad = _case(2, 16, 50, 80, dtype, "tail", seed=4)
    name = str(dtype).split(".")[-1]
    before = (dict(port.LAUNCHES), dict(port.LAUNCHES_BY_DTYPE), dict(port.LAUNCHES_BY_HEAD_DIM))
    port.attention_fwd_cuda(q, k, v, pad, 80 ** -0.5)
    torch.cuda.synchronize()
    assert port.LAUNCHES == {**before[0], "attention_fwd": before[0]["attention_fwd"] + 1}
    key = f"attention_fwd.{name}"
    assert port.LAUNCHES_BY_DTYPE == {**before[1], key: before[1][key] + 1}
    key = f"hd80.{name}"
    assert port.LAUNCHES_BY_HEAD_DIM == {**before[2], key: before[2][key] + 1}


def test_autograd_decoder_head_dim_counts_as_packed():
    """head_dim 32 (the decoder) launches under its own counter, the
    counterpart of ``_attention_kernel_packed``; the other stays put."""
    q, k, v, pad = _case(2, 16, 50, 32, torch.float32, "tail", seed=2)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(port.LAUNCHES)
    out = port.fused_attention(*leaves, pad, 32 ** -0.5)
    (out ** 2).sum().backward()
    assert port.LAUNCHES == {**before, "attention_fwd_packed": before["attention_fwd_packed"] + 1}
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (port.attention_reference(*ref_leaves, pad, 32 ** -0.5) ** 2).sum().backward()
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_allclose(a.grad.cpu().numpy(), b.grad.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


def _grouped(B, H, H_kv, N, dtype, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, N, 64, generator=g).cuda().to(dtype)
    k, v = (torch.randn(B, H_kv, N, 64, generator=g).cuda().to(dtype) for _ in range(2))
    return q, k, v


def _check_causal(q, k, v, pad):
    """One launch of the causal kernel, counted under its own instantiation
    and nowhere else, against the plain causal attention."""
    name = str(q.dtype).split(".")[-1]
    before = (dict(port.LAUNCHES), dict(port.LAUNCHES_BY_HEAD_DIM))
    out = port.grouped_attention(q, k, v, pad, 0.125)
    torch.cuda.synchronize()
    key = port.causal_key(64, name, q.shape[1] // k.shape[1])
    assert port.LAUNCHES == before[0]
    assert port.LAUNCHES_BY_HEAD_DIM == {**before[1], key: before[1][key] + 1}
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = port.attention_reference(q, k, v, pad, 0.125, causal=True)
    atol = 1e-4 if q.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [512, 64], ids=["entity", "description"])
def test_causal_grouped_kernel_at_lfm2_shapes(dtype, B):
    """LFM2-8B-A1B's attention: 32 query heads over 8 KV heads of 64,
    causal, at the entity sweep's B 512 and the relation sweep's B 64 of
    N 321."""
    _check_causal(*_grouped(B, 32, 8, 321, dtype, seed=B), None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["none", "tail"])
# N on either side of the 32-key tile and the 64- and 128-row query blocks:
# diagonal tiles cut anywhere, blocks with one row
@pytest.mark.parametrize("N", [1, 15, 16, 17, 31, 33, 63, 64, 65, 127, 128, 129, 130, 257, 321])
def test_causal_kernel_ragged(dtype, mask_kind, N):
    q, k, v = _grouped(3, 8, 2, N, dtype, seed=N)
    pad = None
    if mask_kind == "tail":
        pad = torch.zeros(3, N, device="cuda")
        pad[:, N - min(5, N - 1):] = 1.0
    _check_causal(q, k, v, pad)


def test_grouped_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = _grouped(2, 8, 4, 17, torch.float32, seed=0)
    with pytest.raises(ValueError, match="causal instantiation"):
        port.attention_fwd_causal_cuda(q, k, v, None, 0.1)      # 2 query heads per KV head
    q, k, v = _grouped(2, 8, 2, 17, torch.float32, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        port.grouped_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, None, 0.1)
