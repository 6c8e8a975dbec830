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
    none = dict(HGMMA=0, UTMALDG=0)
    assert port.sass_counts(sass) == {(64, "float32"): dict(none, HMMA=2),
                                      (32, "bfloat16"): dict(none, HMMA=1)}
    # the Hopper design's kernels (wgmma + TMA): their symbols take two
    # tensor maps, and their SASS has HGMMA and UTMALDG in place of HMMA
    hop = "_ZN12_GLOBAL__N_15wgmma20attention_fwd_kernelILi64E13__nv_bfloat16EEv14CUtensorMap_stS3_PKT0_PKfPS4_iif"
    sass += (f"\t\tFunction : {hop}\n"
             "        /*0200*/     UTMALDG.3D [UR8], [UR4] ;\n"
             "        /*0210*/     UTMALDG.3D [UR16], [UR12] ;\n"
             "        /*0300*/     HGMMA.64x64x16.F32.BF16 R24, R152, gdesc[UR4], RZ, !UPT ;\n"
             "        /*0310*/     HGMMA.64x64x16.F32.BF16 R24, R156, gdesc[UR8], R24 ;\n"
             "        /*0320*/     HGMMA.64x64x16.F32.BF16 R24, R160, gdesc[UR12], R24, gsb0 ;\n"
             "        /*0330*/     WARPGROUP.DEPBAR.LE gsb0, 0x0 ;\n")
    assert port.sass_counts(sass)[(64, "bfloat16")] == dict(HMMA=0, HGMMA=3, UTMALDG=2)


def test_tile_sweep_builds_every_tile():
    """The sweep's builds: one per (key tile, consumer warpgroups, stages),
    each named by its nvcc defines, so a result line says which tile it
    timed."""
    from mre_tpu_torch.tools import tile_sweep

    builds = tile_sweep.tiles([32, 64], [1, 2], [2, 4])
    assert len(builds) == 2 * 2 * 2
    assert all(len(defines) == 3 for defines in builds.values())
    assert builds["bk64_wg2_st4"] == ("ATTN_BLOCK_K=64", "ATTN_WG=2", "ATTN_STAGES=4")
    # every head_dim of the kernel is timed at a main-path shape, hd 80 at
    # M3AE-huge's entity sweep (one batch of 512, 16 heads, N 321)
    assert {shape[-1] for shape in tile_sweep.SHAPES.values()} == set(port.HEAD_DIMS)
    assert tile_sweep.SHAPES["huge_entity"] == (512, 16, 321, 80)


def test_one_design_at_every_head_dim():
    """Every instantiation the kernel has (head_dim × dtype) is built on
    wgmma + TMA: chip_smoke.py requires HGMMA and UTMALDG, and no HMMA, in
    each of these, and fails on an instantiation outside them."""
    assert port.HEAD_DIMS == (32, 64, 80)
    assert port.WGMMA_INSTANTIATIONS == {(hd, dtype) for hd in port.HEAD_DIMS
                                         for dtype in ("float32", "bfloat16")}
    assert set(port.LAUNCHES_BY_HEAD_DIM) == (
        {f"hd{hd}.{dtype}" for hd, dtype in port.WGMMA_INSTANTIATIONS}
        | {port.causal_key(*key) for key in port.CAUSAL_INSTANTIATIONS})
    assert port.CAUSAL_INSTANTIATIONS == {(64, "float32", 4), (64, "bfloat16", 4)}


def _per_head_causal(q, k, v, pad, scale):
    """Causal grouped attention one query head and one row at a time, in
    float64: query head h reads KV head h // (H // H_kv)."""
    B, H, N, _ = q.shape
    group = H // k.shape[1]
    out = np.zeros(q.shape)
    for b in range(B):
        for h in range(H):
            kh, vh = k[b, h // group].astype(np.float64), v[b, h // group].astype(np.float64)
            for i in range(N):
                s = kh[:i + 1] @ q[b, h, i].astype(np.float64) * scale
                if pad is not None:
                    s = np.where(pad[b, :i + 1] > 0, -1e7, s)
                p = np.exp(s - s.max())
                out[b, h, i] = p @ vh[:i + 1] / p.sum()
    return out


@pytest.mark.parametrize("kv_heads", [1, 2, 4])
@pytest.mark.parametrize("kind", ["none", "tail"])
def test_reference_causal_grouped(kv_heads, kind):
    """``attention_reference(..., causal=True)`` with fewer KV heads than
    query heads, and ``grouped_attention`` on CPU tensors (its plain path),
    against the attention worked out per head and per query row."""
    B, H, N, hd = 2, 4, 19, 32
    q = _qkv(B, H, N, hd, seed=kv_heads)[0]
    k, v = _qkv(B, kv_heads, N, hd, seed=10 + kv_heads)[:2]
    pad = _mask(B, N, kind)
    scale = hd ** -0.5
    want = _per_head_causal(q, k, v, pad, scale)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    tpad = None if pad is None else torch.from_numpy(pad)
    out = port.attention_reference(tq, tk, tv, tpad, scale, causal=True)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    auto = port.grouped_attention(tq, tk, tv, tpad, scale)
    np.testing.assert_array_equal(auto.numpy(), out.numpy())
    # not causal: the M3AE function with K and V repeated per group
    rep = H // kv_heads
    full = port.attention_reference(tq, tk.repeat_interleave(rep, 1),
                                    tv.repeat_interleave(rep, 1), tpad, scale)
    np.testing.assert_array_equal(port.attention_reference(tq, tk, tv, tpad, scale).numpy(),
                                  full.numpy())


def test_grouped_attention_refuses_what_it_does_not_take():
    q = torch.zeros(1, 4, 5, 32)
    k = torch.zeros(1, 2, 5, 32)
    with pytest.raises(ValueError, match="KV heads"):
        port.grouped_attention(q, k, q, None, 1.0)                 # k and v head counts differ
    with pytest.raises(ValueError, match="KV heads"):
        port.grouped_attention(q, torch.zeros(1, 3, 5, 32), torch.zeros(1, 3, 5, 32), None, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        port.grouped_attention(q, k, k, None, 1.0, impl="kernel")
    with pytest.raises(ValueError, match="unknown attention impl"):
        port.grouped_attention(q, k, k, None, 1.0, impl="pallas")


def test_build_report_parses_causal_instantiations():
    """The causal kernels' symbols carry the query heads per KV head after
    head_dim and type; the plain kernels' keys stay (head_dim, type)."""
    f32 = ("_ZN12_GLOBAL__N_15wgmma27attention_fwd_causal_kernelILi64EfLi4EEEv14CUtensorMap_st"
           "S2_PKT0_PKfPS3_iif")
    bf16 = ("_ZN12_GLOBAL__N_15wgmma27attention_fwd_causal_kernelILi64E13__nv_bfloat16Li4EEEv"
            "14CUtensorMap_stS3_PKT0_PKfPS4_iif")
    plain = "_ZN12_GLOBAL__N_15wgmma20attention_fwd_kernelILi64EfEEv14CUtensorMap_stS2_PKT0_PKfPS3_iif"
    ptxas = "".join(f"ptxas info    : Compiling entry function '{sym}' for 'sm_90a'\n"
                    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                    f"ptxas info    : Used {r} registers, used 1 barriers, 384 bytes cmem[0]\n"
                    for sym, r in ((f32, 240), (bf16, 168), (plain, 240)))
    assert port.ptxas_report(ptxas) == {
        (64, "float32", 4): dict(registers=240, spill_stores=0, spill_loads=0),
        (64, "bfloat16", 4): dict(registers=168, spill_stores=0, spill_loads=0),
        (64, "float32"): dict(registers=240, spill_stores=0, spill_loads=0)}
