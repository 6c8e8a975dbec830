"""``ops/segment.py::segment_sum``: the RGCN's and the visual pivot's
segment sums. On the CPU it equals numpy's ``add.at`` (sequential, exact
order) and its gradient is the gathered upstream gradient; on a card
(marked ``cuda``, skipped without one) two calls give the same bits and
agree with the CPU within float32 summation order (atol 1e-2 on sums of
~15,000 unit-normal terms, of magnitude ~120)."""

import numpy as np
import pytest
import torch

from mre_tpu_torch.ops.segment import segment_sum


def _case(seed=0, rows=400, n=7, dim=5):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(rows, dim)).astype(np.float32)
    seg = rng.integers(0, n, rows)
    return vals, seg, n


@pytest.mark.parametrize("dim", [None, 5])
def test_segment_sum_equals_add_at_on_the_cpu(dim):
    vals, seg, n = _case(dim=dim or 1)
    vals = vals[:, 0] if dim is None else vals
    want = np.zeros((n, *vals.shape[1:]), np.float32)
    np.add.at(want, seg, vals)
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), n).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_sum_gradient_gathers():
    vals, seg, n = _case()
    x = torch.from_numpy(vals).requires_grad_()
    up = torch.randn(n, vals.shape[1], generator=torch.Generator().manual_seed(1))
    (segment_sum(x, torch.from_numpy(seg), n) * up).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), up.numpy()[seg])


def test_an_empty_segment_is_zero():
    got = segment_sum(torch.ones(3, 2), torch.tensor([0, 0, 2]), 4)
    np.testing.assert_array_equal(got.numpy(), [[2, 2], [0, 0], [1, 1], [0, 0]])


@pytest.mark.cuda
def test_segment_sum_on_the_card_is_deterministic():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    vals, seg, n = _case(rows=200_000, n=13, dim=64)
    x, s = torch.from_numpy(vals).cuda(), torch.from_numpy(seg).cuda()
    a, b = segment_sum(x, s, n), segment_sum(x, s, n)
    assert torch.equal(a, b)
    ref = segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), n)
    np.testing.assert_allclose(a.cpu().numpy(), ref.numpy(), rtol=0, atol=1e-2)
