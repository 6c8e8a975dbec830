"""Port KGE models vs the JAX package's, with carried parameters.

For each of the eleven models, JAX initializes the parameters; they are
carried into the port (``interop.kge_from_jax``) and every function is held
against JAX's on the same indices: ``score`` and ``predict`` (pointwise, per
negative and broadcast over every entity), the all-entity fast paths, the
regulariser, and the gradients of score + regulariser (autograd against
``jax.grad``); then the structured TransR / RotatE paths and the L3
regularisers. Floats agree within 1e-5 of the largest magnitude compared.
The port's own initializers are checked for their ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mre_tpu.models import kge as jkge
from mre_tpu.ops.sampling import NegativeBatch as JBatch
from mre_tpu_torch import interop
from mre_tpu_torch.models import kge as tkge
from mre_tpu_torch.ops.sampling import NegativeBatch as TBatch

N_ENT, N_REL, DIM = 30, 5, 16
REL = 1e-5


def close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |d| {err:.3g} > {rel} × {scale:.3g}"


def idx(rng, hi, shape):
    return rng.integers(0, hi, shape)


@pytest.fixture(scope="module")
def indices():
    rng = np.random.default_rng(5)
    B, N = 6, 4
    return dict(h=idx(rng, N_ENT, B), r=idx(rng, N_REL, B), t=idx(rng, N_ENT, B),
                nh=idx(rng, N_ENT, (B, N)), nt=idx(rng, N_ENT, (B, N)))


def both(name, **init):
    jm, tm = jkge.get(name), tkge.get(name)
    jp = jm.init(jax.random.key(0), N_ENT, N_REL, dim=DIM, **init)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    assert sorted(jp) == sorted(tm.init(torch.Generator().manual_seed(0), N_ENT, N_REL,
                                        dim=DIM, **init))
    return jm, tm, {k: jnp.asarray(v) for k, v in jp.items()}, interop.kge_from_jax(jp)


def J(x):
    return jnp.asarray(x, jnp.int32)


def T(x):
    return torch.tensor(np.asarray(x), dtype=torch.int64)


@pytest.mark.parametrize("name", sorted(jkge.MODELS))
def test_score_predict_and_fast_paths_equal_jax(name, indices):
    jm, tm, jp, tp = both(name)
    i = indices
    rb = np.broadcast_to(i["r"][:, None], i["nh"].shape)
    with torch.no_grad():
        close(tm.score(tp, T(i["h"]), T(i["r"]), T(i["t"])),
              jm.score(jp, J(i["h"]), J(i["r"]), J(i["t"])))
        close(tm.score(tp, T(i["nh"]), T(rb), T(i["nt"])),
              jm.score(jp, J(i["nh"]), J(rb), J(i["nt"])))
        close(tm.predict(tp, T(i["h"]), T(i["r"]), T(i["t"])),
              jm.predict(jp, J(i["h"]), J(i["r"]), J(i["t"])))
        ents = np.arange(N_ENT)[None, :]
        close(tm.predict(tp, T(i["h"][:, None]), T(i["r"][:, None]), T(ents)),
              jm.predict(jp, J(i["h"][:, None]), J(i["r"][:, None]), J(ents)))
        close(tm.regularization(tp, T(i["nh"]), T(rb), T(i["nt"])),
              jm.regularization(jp, J(i["nh"]), J(rb), J(i["nt"])))
        assert (tm.score_all_tails is None) == (jm.score_all_tails is None)
        if jm.score_all_tails is not None:
            close(tm.score_all_tails(tp, T(i["h"]), T(i["r"])),
                  jm.score_all_tails(jp, J(i["h"]), J(i["r"])))
            close(tm.score_all_heads(tp, T(i["t"]), T(i["r"])),
                  jm.score_all_heads(jp, J(i["t"]), J(i["r"])))
    assert tm.higher_is_better == jm.higher_is_better


@pytest.mark.parametrize("name", sorted(jkge.MODELS))
def test_gradients_equal_jax(name, indices):
    jm, tm, jp, tp = both(name)
    i = indices
    rb = np.broadcast_to(i["r"][:, None], i["nh"].shape)
    w = np.linspace(-1.0, 1.0, i["nh"].size).reshape(i["nh"].shape).astype(np.float32)

    def jloss(p):
        return (jnp.sum(jm.score(p, J(i["h"]), J(i["r"]), J(i["t"])))
                + jnp.sum(jnp.asarray(w) * jm.score(p, J(i["nh"]), J(rb), J(i["nt"])))
                + jm.regularization(p, J(i["h"]), J(i["r"]), J(i["t"])))

    grads = jax.grad(jloss)(jp)
    leaves = {k: v.clone().requires_grad_(k not in tkge.FROZEN) for k, v in tp.items()}
    loss = (tm.score(leaves, T(i["h"]), T(i["r"]), T(i["t"])).sum()
            + (torch.from_numpy(w) * tm.score(leaves, T(i["nh"]), T(rb), T(i["nt"]))).sum()
            + tm.regularization(leaves, T(i["h"]), T(i["r"]), T(i["t"])))
    loss.backward()
    close(loss.detach(), jloss(jp))
    for k, v in leaves.items():
        if k in tkge.FROZEN:
            assert v.grad is None
            assert float(jnp.abs(grads[k]).max()) == 0.0   # stop_gradient in JAX
        else:
            close(v.grad, grads[k])


def test_transe_hand_computed():
    params = {"ent": torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.6, 0.8]]),
              "rel": torch.tensor([[3.0, 4.0]])}
    s = tkge.get("transe").score(params, torch.tensor([0]), torch.tensor([0]), torch.tensor([2]))
    np.testing.assert_allclose(s.numpy(), [1.0], rtol=1e-5)


def test_hole_ccorr_bruteforce():
    params = tkge.get("hole").init(torch.Generator().manual_seed(1), 5, 2, dim=8)
    a, b, rr = params["ent"][1].numpy(), params["ent"][3].numpy(), params["rel"][0].numpy()
    n = len(a)
    ccorr = np.array([sum(a[i] * b[(i + k) % n] for i in range(n)) for k in range(n)])
    got = float(tkge.get("hole").score(params, torch.tensor([1]), torch.tensor([0]),
                                       torch.tensor([3]))[0])
    np.testing.assert_allclose(got, float(np.sum(ccorr * rr)), rtol=1e-4)


@pytest.mark.parametrize("norm_flag", [True, False])
def test_transr_structured_paths_equal_jax(norm_flag, indices):
    jm, tm, jp, tp = both("transr", rand_init=True)
    i = indices
    kw = dict(norm_flag=norm_flag)
    jb = JBatch(h=J(i["h"]), r=J(i["r"]), t=J(i["t"]), neg_h=J(i["nh"]), neg_t=J(i["nt"]))
    tb = TBatch(h=T(i["h"]), r=T(i["r"]), t=T(i["t"]), neg_h=T(i["nh"]), neg_t=T(i["nt"]))
    with torch.no_grad():
        for got, want in zip(tm.score_pos_neg(tp, tb, **kw), jm.score_pos_neg(jp, jb, **kw)):
            close(got, want)
        close(tkge.transr_all_tails(tp, T(i["h"]), T(i["r"]), **kw),
              jkge.transr_all_tails(jp, J(i["h"]), J(i["r"]), **kw))
        close(tkge.transr_all_heads(tp, T(i["t"]), T(i["r"]), **kw),
              jkge.transr_all_heads(jp, J(i["t"]), J(i["r"]), **kw))
        close(tm.regularization(tp, T(i["h"]), T(i["r"]), T(i["t"])),
              jm.regularization(jp, J(i["h"]), J(i["r"]), J(i["t"])))


@pytest.mark.parametrize("sided", [False, True])
def test_rotate_structured_path_and_gradients_equal_jax(sided, indices):
    jm, tm, jp, tp = both("rotate")
    i = indices
    side = np.random.default_rng(1).random(i["nh"].shape) < 0.5
    ent = np.where(side, i["nt"], i["nh"])
    nh = np.where(side, i["h"][:, None], ent)
    nt = np.where(side, ent, i["t"][:, None])
    extra_j = dict(neg_ent=J(ent), neg_side=jnp.asarray(side)) if sided else {}
    extra_t = dict(neg_ent=T(ent), neg_side=torch.from_numpy(side)) if sided else {}
    jb = JBatch(h=J(i["h"]), r=J(i["r"]), t=J(i["t"]), neg_h=J(nh), neg_t=J(nt), **extra_j)
    tb = TBatch(h=T(i["h"]), r=T(i["r"]), t=T(i["t"]), neg_h=T(nh), neg_t=T(nt), **extra_t)

    def jloss(p):
        pp, nn = jm.score_pos_neg(p, jb)
        return jnp.sum(pp) - 0.5 * jnp.sum(nn)

    grads = jax.grad(jloss)(jp)
    leaves = {k: v.clone().requires_grad_(k not in tkge.FROZEN) for k, v in tp.items()}
    pp, nn = tm.score_pos_neg(leaves, tb)
    loss = pp.sum() - 0.5 * nn.sum()
    loss.backward()
    jpp, jnn = jm.score_pos_neg(jp, jb)
    close(pp.detach(), jpp)
    close(nn.detach(), jnn)
    for k in ("ent", "rel"):
        close(leaves[k].grad, grads[k])
    # and the structured path equals the port's generic scorer
    with torch.no_grad():
        close(nn, tm.score(tp, T(nh), T(np.broadcast_to(i["r"][:, None], nh.shape)), T(nt)))


@pytest.mark.parametrize("name", ["distmult", "hole"])
def test_l3_regularization_equals_jax(name):
    _, _, jp, tp = both(name)
    jfn = {"distmult": jkge.distmult_l3_regularization, "hole": jkge.hole_l3_regularization}
    tfn = {"distmult": tkge.distmult_l3_regularization, "hole": tkge.hole_l3_regularization}
    close(tfn[name](tp), jfn[name](jp))


def test_port_initializers():
    """xavier_uniform limits, and the margin/epsilon uniform range when both
    are given (TransE.py:20-36 pattern)."""
    gen = torch.Generator().manual_seed(0)
    lim = (200.0 + 2.0) / 64
    for name in ("transe", "transh", "transd", "distmult", "hole"):
        m = tkge.get(name)
        ent = m.init(gen, 50, 5, dim=64, margin=200.0, epsilon=2.0)["ent"]
        assert ent.abs().max() <= lim and ent.abs().max() > 0.8 * lim, name
        x = m.init(gen, 50, 5, dim=64)["ent"]
        assert x.abs().max() <= np.sqrt(6.0 / (50 + 64)), name
    rot = tkge.get("rotate").init(gen, 40, 4, dim=8, margin=6.0, epsilon=2.0)
    assert rot["ent"].shape == (40, 16) and rot["ent"].abs().max() <= 8.0 / 16
    assert float(rot["margin"]) == 6.0 and float(rot["rel_range"]) == 1.0
    mat = tkge.get("transr").init(gen, 10, 3, dim_e=4, dim_r=6)["mat"]
    np.testing.assert_array_equal(mat.numpy(), np.broadcast_to(np.eye(4, 6), (3, 4, 6)))


def test_params_module_and_carry_roundtrip():
    jp = jkge.get("rotate").init(jax.random.key(3), N_ENT, N_REL, dim=DIM)
    arrays = {k: np.asarray(v) for k, v in jp.items()}
    module = tkge.Params(interop.kge_from_jax(arrays))
    assert sorted(n for n, _ in module.named_parameters()) == ["ent", "rel"]
    assert sorted(n for n, _ in module.named_buffers()) == ["margin", "rel_range"]
    back = interop.kge_to_jax(module)
    assert sorted(back) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    with pytest.raises(TypeError):
        interop.kge_from_jax({"ent": np.zeros((2, 2), np.float64)})


def test_rotate_predict_does_not_depend_on_summation_order():
    """RotatE's predict accumulates in float64: permuting the complex
    components (the same permutation of the real and imaginary halves and of
    the phases) gives the same float32 scores, bit for bit."""
    gen = torch.Generator().manual_seed(4)
    dim = 256
    params = tkge.get("rotate").init(gen, 300, 3, dim=dim)
    perm = torch.randperm(dim, generator=gen)
    permuted = dict(params, ent=torch.cat([params["ent"][:, :dim][:, perm],
                                           params["ent"][:, dim:][:, perm]], 1),
                    rel=params["rel"][:, perm])
    h, r = torch.arange(12)[:, None], (torch.arange(12) % 3)[:, None]
    ents = torch.arange(300)[None, :]
    pred = tkge.get("rotate").predict
    with torch.no_grad():
        np.testing.assert_array_equal(pred(params, h, r, ents).numpy(),
                                      pred(permuted, h, r, ents).numpy())


@pytest.mark.parametrize("norm_flag", [True, False])
@pytest.mark.parametrize("p_norm", [1, 2])
def test_transe_predict_does_not_depend_on_summation_order(norm_flag, p_norm):
    """TransE's predict sums its norms in float64: permuting the embedding
    columns gives the same float32 scores, bit for bit."""
    gen = torch.Generator().manual_seed(5)
    params = tkge.get("transe").init(gen, 400, 3, dim=200)
    perm = torch.randperm(200, generator=gen)
    permuted = {k: v[:, perm] for k, v in params.items()}
    h, r = torch.arange(16)[:, None], (torch.arange(16) % 3)[:, None]
    ents = torch.arange(400)[None, :]
    pred = tkge.get("transe").predict
    with torch.no_grad():
        np.testing.assert_array_equal(
            pred(params, h, r, ents, p_norm=p_norm, norm_flag=norm_flag).numpy(),
            pred(permuted, h, r, ents, p_norm=p_norm, norm_flag=norm_flag).numpy())
