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
