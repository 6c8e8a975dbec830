"""Port KGE sampling and ranking losses vs the JAX package's.

The port accepts every random draw as an argument. Each test recomputes
JAX's draws from JAX's key (the same ``jax.random`` calls on the same key
splits as ``mre_tpu/ops/sampling.py``), feeds them to the port and requires
the same integers: negatives, tier-2 resolutions and truncation counts.
The properties of ``tests/test_sampling.py`` are then held on the port's
own draws from a ``torch.Generator``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mre_tpu.data.kg import DeviceKG as JDeviceKG
from mre_tpu.data.kg import TripleTable as JTripleTable
from mre_tpu.ops import losses as jlosses
from mre_tpu.ops import sampling as jsamp
from mre_tpu_torch.data.kg import DeviceKG, TripleTable
from mre_tpu_torch.ops import losses as tlosses
from mre_tpu_torch.ops import sampling as tsamp


def t64(x):
    return torch.tensor(np.asarray(x), dtype=torch.int64)


def port_kg(jtable, compact=None):
    table = TripleTable.build(jtable.triples, jtable.n_entities, jtable.n_relations)
    return table, DeviceKG.from_table(table, compact=compact)


@pytest.fixture(scope="module")
def kgs(tiny_kg):
    table, kg = port_kg(tiny_kg)
    return tiny_kg, JDeviceKG.from_table(tiny_kg), table, kg


@pytest.fixture(scope="module")
def big_kgs():
    """One (h, r) row of 200 true tails (> EXACT_PAD) among 3000 small rows:
    the tier-2 fixture of tests/test_sampling.py."""
    rng = np.random.default_rng(0)
    big = np.stack([np.zeros(200, np.int64), np.zeros(200, np.int64), np.arange(1, 201)], 1)
    small = np.stack([rng.integers(1, 3000, 3000), np.zeros(3000, np.int64) + 1,
                      rng.integers(1, 3000, 3000)], 1)
    tri = np.unique(np.concatenate([big, small]).astype(np.int32), axis=0)
    jtable = JTripleTable.build(tri, 3000, 2)
    table, kg = port_kg(jtable)
    return jtable, JDeviceKG.from_table(jtable), table, kg


def jax_batch_draws(key, jkg, h, r, t, n_neg, bern):
    """corrupt_batch's draws, as mre_tpu/ops/sampling.py:232-250 makes them."""
    k_side, k_u = jax.random.split(key)
    B = h.shape[0]
    side_u = jax.random.uniform(k_side, (B, n_neg))
    if bern:
        lm, rm = jkg.left_mean[r], jkg.right_mean[r]
        p = rm / jnp.maximum(lm + rm, 1e-9)
    else:
        p = jnp.full((B,), 0.5, jnp.float32)
    side = side_u < p[:, None]
    _, cnt_t, _ = jkg.hr_range(h.astype(jnp.int32) * jkg.n_relations + r.astype(jnp.int32))
    _, cnt_h, _ = jkg.tr_range(t.astype(jnp.int32) * jkg.n_relations + r.astype(jnp.int32))
    cnt = jnp.where(side, cnt_t[:, None], cnt_h[:, None])
    u = jax.random.randint(k_u, (B, n_neg), 0, jnp.maximum(jkg.n_entities - cnt, 1))
    return np.asarray(side_u), np.asarray(u)


def assert_batch_equal(jb, tb):
    for f in ("h", "r", "t", "neg_h", "neg_t", "neg_ent", "neg_side"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), f)
    assert int(tb.overflow_truncated) == int(jb.overflow_truncated)


@pytest.mark.parametrize("side", ["tail", "head"])
def test_corrupt_tails_heads_equal_jax_given_its_draws(kgs, side):
    jtable, jkg, _, kg = kgs
    h, r, t = (jnp.asarray(jtable.triples[:, i]) for i in range(3))
    for seed in range(3):
        key = jax.random.key(seed)
        if side == "tail":
            want = jsamp.corrupt_tails(key, jkg, h, r)
            _, cnt, _ = jkg.hr_range(h * jkg.n_relations + r)
        else:
            want = jsamp.corrupt_heads(key, jkg, t, r)
            _, cnt, _ = jkg.tr_range(t * jkg.n_relations + r)
        u = t64(jax.random.randint(key, h.shape, 0, jnp.maximum(jkg.n_entities - cnt, 1)))
        got = (tsamp.corrupt_tails(kg, t64(h), t64(r), u=u) if side == "tail"
               else tsamp.corrupt_heads(kg, t64(t), t64(r), u=u))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bern", [False, True])
def test_sample_training_batch_equals_jax_given_its_draws(kgs, bern):
    jtable, jkg, _, kg = kgs
    B, n_neg = 48, 5
    for seed in range(2):
        key = jax.random.key(seed)
        jb = jsamp.sample_training_batch(key, jkg, B, n_neg, bern)
        k_pick, k_corrupt = jax.random.split(key)
        idx = jax.random.randint(k_pick, (B,), 0, jkg.triples.shape[0])
        tri = jkg.triples[idx]
        side_u, u = jax_batch_draws(k_corrupt, jkg, tri[:, 0], tri[:, 1], tri[:, 2], n_neg, bern)
        tb = tsamp.sample_training_batch(kg, B, n_neg, bern, idx=t64(idx),
                                         side_u=torch.tensor(side_u), u=t64(u))
        assert_batch_equal(jb, tb)


def test_overflow_resolution_and_truncation_equal_jax(big_kgs):
    """Tier 2 on the oversized row: exact under 8192 draws, and above it the
    same truncated draws and the same (positive) truncation count."""
    jtable, jkg, _, kg = big_kgs
    for B, n_neg, seed in ((256, 8, 0), (2048, 8, 1)):
        h = jnp.zeros(B, jnp.int32)
        r = jnp.zeros(B, jnp.int32)
        t = jnp.ones(B, jnp.int32)
        key = jax.random.key(seed)
        jb = jsamp.corrupt_batch(key, jkg, h, r, t, n_neg=n_neg, bern=False)
        side_u, u = jax_batch_draws(key, jkg, h, r, t, n_neg, False)
        tb = tsamp.corrupt_batch(kg, t64(h), t64(r), t64(t), n_neg,
                                 side_u=torch.tensor(side_u), u=t64(u))
        assert_batch_equal(jb, tb)
        if B * n_neg > 8192:
            assert int(tb.overflow_truncated) > 0
        else:
            assert int(tb.overflow_truncated) == 0
            side = tb.neg_side.numpy()
            assert not np.isin(tb.neg_ent.numpy()[side], np.arange(1, 201)).any()


def pair_counts(table, h, t):
    keys = h.astype(np.int64) * table.n_entities + t.astype(np.int64)
    return (np.searchsorted(table.pair_keys, keys, side="right")
            - np.searchsorted(table.pair_keys, keys, side="left"))


@pytest.mark.parametrize("filtered", [False, True])
def test_corrupt_relations_equal_jax_given_its_draws(kgs, filtered):
    jtable, jkg, table, kg = kgs
    tri = jtable.triples[:60]
    h, r, t = (jnp.asarray(tri[:, i]) for i in range(3))
    n_neg = 16
    key = jax.random.key(4)
    if filtered:
        want = jsamp.corrupt_relations(key, jkg, r, n_neg, h=h, t=t)
        k = pair_counts(table, tri[:, 0], tri[:, 2])
        u = jax.random.randint(key, (len(tri), n_neg), 0,
                               jnp.maximum(jkg.n_relations - jnp.asarray(k, jnp.int32), 1)[:, None])
        got = tsamp.corrupt_relations(kg, t64(r), n_neg, h=t64(h), t=t64(t), u=t64(u))
    else:
        want = jsamp.corrupt_relations(key, jkg, r, n_neg)
        u = jax.random.randint(key, (len(tri), n_neg), 0, jkg.n_relations - 1, dtype=jnp.int32)
        got = tsamp.corrupt_relations(kg, t64(r), n_neg, u=t64(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_corrupt_relations_prob_equals_jax_given_its_draws(kgs):
    jtable, jkg, _, kg = kgs
    R = jtable.n_relations
    kl = np.random.default_rng(0).uniform(0.1, 3.0, (R, R - 1)).astype(np.float32)
    prob = jsamp.relation_prob_table(jnp.asarray(kl), 0.7)
    np.testing.assert_allclose(tsamp.relation_prob_table(kl, 0.7).numpy(), np.asarray(prob),
                               rtol=1e-6, atol=1e-7)
    tri = jtable.triples[:80]
    h, r, t = (jnp.asarray(tri[:, i]) for i in range(3))
    key = jax.random.key(2)
    want = jsamp.corrupt_relations_prob(key, jkg, h, t, r, prob, n_neg=6)
    u = jax.random.uniform(key, (len(tri), 6))
    got = tsamp.corrupt_relations_prob(kg, t64(h), t64(t), t64(r), np.asarray(prob), n_neg=6,
                                       u=torch.tensor(np.asarray(u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- properties of tests/test_sampling.py, on the port's own draws -------------

def test_corrupt_tails_heads_never_true(kgs):
    jtable, _, _, kg = kgs
    h, r, t = (t64(jtable.triples[:, i]) for i in range(3))
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        tails = tsamp.corrupt_tails(kg, h, r, generator=gen).numpy()
        heads = tsamp.corrupt_heads(kg, t, r, generator=gen).numpy()
        assert (tails >= 0).all() and (tails < jtable.n_entities).all()
        assert not jtable.contains(h.numpy(), r.numpy(), tails).any()
        assert not jtable.contains(heads, r.numpy(), t.numpy()).any()


def test_exact_path_uniform_over_complement(kgs):
    jtable, _, _, kg = kgs
    h0, r0 = int(jtable.triples[0, 0]), int(jtable.triples[0, 1])
    true = set(jtable.true_tails(h0, r0).tolist())
    B = 4000
    neg = tsamp.corrupt_tails(kg, torch.full((B,), h0), torch.full((B,), r0),
                              generator=torch.Generator().manual_seed(7)).numpy()
    seen = set(neg.tolist())
    complement = set(range(jtable.n_entities)) - true
    assert seen.isdisjoint(true)
    assert len(seen) >= len(complement) - 1
    assert np.bincount(neg, minlength=jtable.n_entities).max() <= 3 * B / len(complement)


def test_corrupt_batch_layout_and_filtered(kgs):
    jtable, _, _, kg = kgs
    batch = tsamp.sample_training_batch(kg, 32, 5, bern=True,
                                        generator=torch.Generator().manual_seed(3))
    assert batch.h.shape == (32,) and batch.neg_h.shape == (32, 5)
    nh, nt = batch.neg_h.numpy(), batch.neg_t.numpy()
    h, t = batch.h.numpy()[:, None], batch.t.numpy()[:, None]
    assert not ((nh != h) & (nt != t)).any()
    r = np.repeat(batch.r.numpy()[:, None], 5, 1)
    assert not jtable.contains(nh.ravel(), r.ravel(), nt.ravel()).any()
    assert int(batch.overflow_truncated) == 0
    # the sided view holds the same corruptions
    side = batch.neg_side.numpy()
    np.testing.assert_array_equal(np.where(side, h, batch.neg_ent.numpy()), nh)


def test_compact_kg_draws_equal_dense(kgs):
    jtable, _, table, kg = kgs
    ckg = DeviceKG.from_table(table, compact=True)
    assert ckg.hr_row_keys is not None
    h, r, t = (t64(jtable.triples[:, i]) for i in range(3))
    for seed in range(3):
        a = tsamp.corrupt_batch(kg, h, r, t, 4, bern=True,
                                generator=torch.Generator().manual_seed(seed))
        b = tsamp.corrupt_batch(ckg, h, r, t, 4, bern=True,
                                generator=torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(a.neg_h.numpy(), b.neg_h.numpy())
        np.testing.assert_array_equal(a.neg_t.numpy(), b.neg_t.numpy())
        np.testing.assert_array_equal(
            tsamp.corrupt_tails(kg, h, r, generator=torch.Generator().manual_seed(seed)).numpy(),
            tsamp.corrupt_tails(ckg, h, r, generator=torch.Generator().manual_seed(seed)).numpy())


def test_corrupt_relations_filtered_covers_complement(kgs):
    jtable, _, _, kg = kgs
    tri = jtable.triples[:40]
    h, r, t = (t64(tri[:, i]) for i in range(3))
    gen = torch.Generator().manual_seed(1)
    neg = tsamp.corrupt_relations(kg, r, 32, h=h, t=t, generator=gen).numpy()
    assert not jtable.contains(np.repeat(tri[:, 0], 32), neg.ravel(),
                               np.repeat(tri[:, 2], 32)).any()
    pair_true = {rr for (hh, rr, tt) in jtable.triples.tolist()
                 if hh == int(tri[0, 0]) and tt == int(tri[0, 2])}
    many = tsamp.corrupt_relations(kg, r[:1], 512, h=h[:1], t=t[:1], generator=gen).numpy()
    assert set(many.ravel().tolist()) == set(range(jtable.n_relations)) - pair_true
    unf = tsamp.corrupt_relations(kg, r, 8, generator=gen).numpy()
    assert not (unf == r.numpy()[:, None]).any() and (unf < jtable.n_relations).all()


def test_corrupt_relations_all_true_returns_positive(tiny_kg):
    R = tiny_kg.n_relations
    triples = np.array([[0, rr, 1] for rr in range(R)] + [[2, 0, 3], [3, 1, 4]], np.int32)
    table = TripleTable.build(triples, tiny_kg.n_entities, R)
    kg = DeviceKG.from_table(table)
    gen = torch.Generator().manual_seed(0)
    neg = tsamp.corrupt_relations(kg, torch.tensor([2, 0]), 8, h=torch.tensor([0, 2]),
                                  t=torch.tensor([1, 3]), generator=gen).numpy()
    assert (neg[0] == 2).all()
    assert (neg[1] != 0).all() and (neg[1] < R).all()
    prob = tsamp.relation_prob_table(np.ones((R, R - 1), np.float32), 1.0)
    negp = tsamp.corrupt_relations_prob(kg, torch.tensor([0, 2]), torch.tensor([1, 3]),
                                        torch.tensor([2, 0]), prob, 8, generator=gen).numpy()
    assert (negp[0] == 2).all() and (negp[1] != 0).all()


def test_randint_below_is_uniform_per_row():
    bound = torch.tensor([[1], [3], [7], [50]])
    draws = tsamp._randint_below(bound, (4, 20000), torch.Generator().manual_seed(0)).numpy()
    for row, b in zip(draws, (1, 3, 7, 50)):
        counts = np.bincount(row, minlength=b)
        assert len(counts) == b
        assert np.abs(counts / 20000 - 1 / b).max() < 0.01


# -- ranking losses --------------------------------------------------------------

@pytest.mark.parametrize("name", ["margin", "sigmoid", "softplus"])
@pytest.mark.parametrize("adv", [None, 1.5])
def test_losses_and_gradients_equal_jax(name, adv):
    rng = np.random.default_rng(0)
    p = rng.normal(size=(16, 1)).astype(np.float32) * 3
    n = rng.normal(size=(16, 7)).astype(np.float32) * 3
    kw = {"margin": 4.0} if name == "margin" else {}
    if adv is not None:
        kw["adv_temperature"] = adv
    jfn, tfn = jlosses.LOSSES[name], tlosses.LOSSES[name]
    want, (gp, gn) = jax.value_and_grad(lambda a, b: jfn(a, b, **kw), argnums=(0, 1))(
        jnp.asarray(p), jnp.asarray(n))
    tp = torch.tensor(p, requires_grad=True)
    tn = torch.tensor(n, requires_grad=True)
    got = tfn(tp, tn, **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(gn), rtol=1e-6, atol=1e-7)


def test_margin_loss_hand():
    out = float(tlosses.margin_loss(torch.tensor([[1.0], [2.0]]), torch.tensor([[3.0], [1.0]]),
                                    margin=6.0))
    np.testing.assert_allclose(out, 5.5, rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.sigmoid_loss(torch.zeros(1, 1), torch.zeros(1, 1))),
                               np.log(2), rtol=1e-6)
