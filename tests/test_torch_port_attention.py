"""Port attention (mre_tpu_torch.ops.attention) vs the JAX package's.

The plain PyTorch twin is held against ``_attention_reference`` and against
the Pallas kernel in interpret mode, as tests/test_pallas_attention.py runs
it: ``_attention_kernel`` at head_dim 64 and 80, ``_attention_kernel_packed``
(heads packed block-diagonally, P = 2, 3 or 4) at head_dim 32. Tolerance
2e-5 (the JAX attention tests' own): both sides compute in float32 and
differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mre_tpu.ops.pallas.attention import _attention_reference, fused_attention
from mre_tpu_torch.ops import attention as port

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(B, H, N, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, N, hd)).astype(np.float32) for _ in range(3)]


def _mask(B, N, kind):
    if kind == "none":
        return None
    pad = np.zeros((B, N), np.float32)
    if kind == "tail":
        pad[:, -7:] = 1.0
    elif kind == "all_but_first":          # a row whose keys are all PAD but one
        pad[0, 1:] = 1.0
        pad[1:, -3:] = 1.0
    return pad


@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("kind", ["none", "tail", "all_but_first"])
def test_reference_matches_jax(hd, kind):
    B, H, N = 2, 3, 37
    q, k, v = _qkv(B, H, N, hd, seed=hd + len(kind))
    pad = _mask(B, N, kind)
    scale = hd ** -0.5
    jpad = None if pad is None else jnp.asarray(pad)
    ref = np.asarray(_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jpad, scale))
    pallas = np.asarray(fused_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jpad, scale, True))
    tpad = None if pad is None else torch.from_numpy(pad)
    out = port.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), tpad, scale).numpy()
    auto = port.fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), tpad, scale).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_array_equal(auto, out)   # CPU tensors take the plain twin


@pytest.mark.parametrize("H", [2, 16])
@pytest.mark.parametrize("kind", ["none", "tail", "all_but_first"])
def test_reference_matches_packed_kernel(H, kind):
    """The decoder's head_dim 32: the packed TPU kernel (pack 2 at H 2,
    4 at H 16) computes head for head the plain twin's function."""
    B, N, hd = 2, 37, 32
    q, k, v = _qkv(B, H, N, hd, seed=H + len(kind))
    pad = _mask(B, N, kind)
    scale = hd ** -0.5
    jpad = None if pad is None else jnp.asarray(pad)
    pallas = np.asarray(fused_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jpad, scale, True))
    ref = np.asarray(_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jpad, scale))
    out = port.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   None if pad is None else torch.from_numpy(pad),
                                   scale).numpy()
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("H", [2, 16])
def test_gradients_match_jax_packed(H):
    """Backward at head_dim 32 vs jax.grad through the packed kernel's
    custom VJP."""
    B, N, hd = 1, 16, 32
    q, k, v = _qkv(B, H, N, hd, seed=7 + H)
    pad = np.zeros((B, N), np.float32)
    pad[:, -3:] = 1.0
    scale = hd ** -0.5

    def loss_j(q, k, v):
        return jnp.sum(fused_attention(q, k, v, jnp.asarray(pad), scale, True) ** 2)

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port.FusedAttention.apply(tq, tk, tv, torch.from_numpy(pad), scale)
    (out ** 2).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)


def test_launch_key_follows_the_tpu_kernel_body():
    assert port.launch_key(32) == "attention_fwd_packed"
    assert port.launch_key(64) == port.launch_key(80) == "attention_fwd"
    assert set(port.LAUNCHES) == {"attention_fwd", "attention_fwd_packed"}


def test_fully_masked_row_is_uniform_average():
    """−1e7 is a where-select, not −inf: an all-PAD row averages V."""
    B, H, N, hd = 1, 2, 9, 64
    q, k, v = _qkv(B, H, N, hd, seed=3)
    pad = torch.ones(B, N)
    out = port.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), pad, hd ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(
        v.mean(axis=2, keepdims=True), v.shape), rtol=1e-5, atol=1e-6)


def test_gradients_match_jax():
    """Autograd Function backward (recompute through the plain twin) vs
    jax.grad through the custom VJP; tolerance as tests/test_pallas_attention.py."""
    B, H, N, hd = 1, 2, 16, 64
    q, k, v = _qkv(B, H, N, hd, seed=6)
    pad = np.zeros((B, N), np.float32)
    pad[:, -3:] = 1.0
    scale = hd ** -0.5

    def loss_j(q, k, v):
        return jnp.sum(fused_attention(q, k, v, jnp.asarray(pad), scale, True) ** 2)

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port.FusedAttention.apply(tq, tk, tv, torch.from_numpy(pad), scale)
    (out ** 2).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)


def test_kernel_impl_on_cpu_raises():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 4, 64, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        port.fused_attention(q, k, v, None, 0.125, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        port.attention_fwd_cuda(q, k, v, None, 0.125)
    with pytest.raises(ValueError, match="impl"):
        port.fused_attention(q, k, v, None, 0.125, impl="xla")


def _tf32(x):
    """float32 → TF32 as ``cvt.rna.tf32.f32`` rounds, and as the kernel's
    ``split_tf32`` makes hi: 10 mantissa bits, to nearest, ties away from
    zero (on the bit pattern: add half of the 13 dropped bits to the
    magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """float32 → TF32 toward zero: the kernel's lo = (x − hi) truncated."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b the way the kernel's float32 path runs it on the tensor cores:
    one TF32 pass, or three (hi·hi + hi·lo + lo·hi, split as split_tf32).
    The float32 operands are split, then the products are taken in float64:
    the result does not depend on the CPU BLAS's reduction order or on a
    float32 matmul-precision setting."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah.double() @ bh.double()
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al.double() @ bh.double() + ah.double() @ bl.double() + ah.double() @ bh.double()


def test_tf32_rounding_is_rna():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12])
    assert _tf32(x).tolist() == [1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0]
    assert _tf32_trunc(x).tolist() == [1.0, 1.0, 1 + 2 ** -10, -1.0, 1.0]


def test_three_tf32_passes_hold_float32(record_property):
    """The kernel's numerical choice, held on the CPU: attention with both
    products in three TF32 passes stays within 1e-5 of the float32
    reference at an entity-like shape; one pass would not stay inside the
    kernel's float32 tolerance (1e-4)."""
    B, H, N, hd = 2, 6, 321, 64
    q, k, v = (torch.from_numpy(x) for x in _qkv(B, H, N, hd, seed=11))
    rng = np.random.default_rng(12)
    pad = np.zeros((B, N), np.float32)
    for b in range(B):                       # entity text: 5-20 words of 64
        pad[b, N - 64 + int(rng.integers(5, 21)):] = 1.0
    pad = torch.from_numpy(pad)
    scale = hd ** -0.5
    # the reference (``attention_reference``'s math) in float64 from the
    # same float32 inputs
    att = (q.double() @ k.double().transpose(-1, -2)) * scale
    ref = torch.softmax(att.masked_fill(pad[:, None, None, :] > 0, -1e7), -1) @ v.double()

    def emulated(passes):
        s = _mm_tf32(q, k.transpose(-1, -2), passes) * scale
        s = s.masked_fill(pad[:, None, None, :] > 0, -1e7)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        # the kernel holds P in float32 registers before its P·V products
        return _mm_tf32(p.float(), v, passes) / p.sum(-1, keepdim=True)

    err3 = float((emulated(3) - ref).abs().max())
    err1 = float((emulated(1) - ref).abs().max())
    record_property("three_pass_max_abs_err", err3)
    record_property("one_pass_max_abs_err", err1)
    assert err3 <= 1e-5
    assert err1 > 1e-4


def test_build_report_parsers():
    """The ptxas and SASS readers that chip_smoke.py prints per
    instantiation, on report lines in nvcc's own format."""
    f32 = "_ZN12_GLOBAL__N_120attention_fwd_kernelILi64EfEEvPKT0_S3_S3_PKfPS1_iif"
    bf16 = "_ZN12_GLOBAL__N_120attention_fwd_kernelILi32E13__nv_bfloat16EEvPKT0_S4_S4_PKfPS2_iif"
    ptxas = (f"ptxas info    : Compiling entry function '{f32}' for 'sm_90a'\n"
             f"ptxas info    : Function properties for {f32}\n"
             "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
             "ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]\n"
             f"ptxas info    : Compiling entry function '{bf16}' for 'sm_90a'\n"
             f"ptxas info    : Function properties for {bf16}\n"
             "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
             "ptxas info    : Used 255 registers, used 1 barriers, 384 bytes cmem[0]\n")
    assert port.ptxas_report(ptxas) == {
        (64, "float32"): dict(registers=168, spill_stores=0, spill_loads=0),
        (32, "bfloat16"): dict(registers=255, spill_stores=4, spill_loads=12)}
    sass = (f"\t\tFunction : {f32}\n"
            "        /*0570*/     HMMA.1688.F32.TF32 R24, R36, R40, R24 ;\n"
            "        /*0580*/     HMMA.1688.F32.TF32 R28, R36, R42, R28 ;\n"
            "        /*0590*/     FFMA R1, R2, R3, R4 ;\n"
            f"\t\tFunction : {bf16}\n"
            "        /*0100*/     HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n")
    assert port.sass_hmma_counts(sass) == {(64, "float32"): 2, (32, "bfloat16"): 1}
