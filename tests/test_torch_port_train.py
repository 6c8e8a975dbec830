"""The training slice's modules in the port vs the JAX package's, on the CPU.

Inputs come from numpy seeds; random parts are drawn on the JAX side and
fed to the port (``ids_shuffle``, the negative sampler's ``side`` and
``cand_local``). Tolerances:
* masking, DeviceKG, ``_contains``, ``corrupt_within_nodes``, the neighbor
  sampler and the training images: exact (integer or copied arithmetic);
* the losses: 1e-6 (float32, one reduction order each);
* the spectral-norm power step and the optimizer: 1e-6 (unit vectors,
  elementwise updates);
* the schedule: rtol 1e-6 (optax evaluates it in float32, the port in
  float64);
* M3AE and UnifiedModel training forwards with carried weights: 2e-5
  (float32 through two encoder and two decoder blocks; summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from mre_tpu.data import graph_sampler as jgs
from mre_tpu.data import kg as jkg
from mre_tpu.data import multimodal as jmm
from mre_tpu.data.fixtures import write_zsl_dataset
from mre_tpu.data.loaders import load_zsl_dataset
from mre_tpu.models import m3ae as jm3ae
from mre_tpu.models import spectral_norm as jsn
from mre_tpu.ops import losses as jlosses
from mre_tpu.ops import masking as jmasking
from mre_tpu.ops import sampling as jsampling
from mre_tpu.train.fusion import cosine_warm_restarts as j_schedule
from mre_tpu_torch.data import graph_sampler as tgs
from mre_tpu_torch.data import kg as tkg
from mre_tpu_torch.data import multimodal as tmm
from mre_tpu_torch.interop import load_flax
from mre_tpu_torch.models import m3ae as tm3ae
from mre_tpu_torch.models import spectral_norm as tsn
from mre_tpu_torch.models.transformer import Transformer
from mre_tpu_torch.models.unified import UnifiedModel, unified_config
from mre_tpu_torch.ops import losses as tlosses
from mre_tpu_torch.ops import masking as tmasking
from mre_tpu_torch.ops import sampling as tsampling
from mre_tpu_torch.train.fusion import cosine_warm_restarts as t_schedule

FWD = dict(rtol=2e-5, atol=2e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- masking -------------------------------------------------------------------


@pytest.mark.parametrize("with_pad", [True, False])
def test_masking_and_restore_equal_jax(with_pad):
    x = _rand((3, 10, 5), 0)
    pad = (np.random.default_rng(1).random((3, 10)) < 0.3).astype(np.float32) if with_pad else None
    key = jax.random.key(2)
    ref = jmasking.random_masking(key, jnp.asarray(x), 4,
                                  None if pad is None else jnp.asarray(pad))
    ids_shuffle = np.asarray(jax.random.permutation(key, 10))
    out = tmasking.random_masking(_t(x), 4, _t(ids_shuffle),
                                  None if pad is None else _t(pad))
    for a, b in zip(out, ref):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    token = _rand((1, 1, 5), 3)
    ref_full = jmasking.restore_with_mask_tokens(ref.kept, jnp.asarray(token), ref.ids_restore)
    out_full = tmasking.restore_with_mask_tokens(out.kept, _t(token), out.ids_restore)
    np.testing.assert_array_equal(out_full.numpy(), np.asarray(ref_full))


# -- losses ----------------------------------------------------------------------


def test_reconstruction_losses_equal_jax():
    rng = np.random.default_rng(4)
    out, target = _rand((4, 9, 12), 5), _rand((4, 9, 12), 6)
    valid = (rng.random((4, 9)) < 0.5).astype(np.float32)
    valid[0] = 0.0                                        # an all-invalid row
    for v in (valid, None):
        np.testing.assert_allclose(
            tlosses.patch_mse_loss(_t(out), _t(target), None if v is None else _t(v)).numpy(),
            np.asarray(jlosses.patch_mse_loss(jnp.asarray(out), jnp.asarray(target),
                                              None if v is None else jnp.asarray(v))),
            rtol=1e-6, atol=1e-6)
    # integer-valued logits: ties in argmax must break as in jnp (first index)
    logits = rng.integers(0, 3, (4, 7, 6)).astype(np.float32)
    tokens = rng.integers(0, 6, (4, 7)).astype(np.int32)
    tv = (rng.random((4, 7)) < 0.7).astype(np.float32)
    for v in (tv, None):
        ref = jlosses.cross_entropy_loss_and_accuracy(
            jnp.asarray(logits), jnp.asarray(tokens), None if v is None else jnp.asarray(v))
        got = tlosses.cross_entropy_loss_and_accuracy(
            _t(logits), _t(tokens), None if v is None else _t(v))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    m1, m2 = (rng.random((3, 5)) < 0.5).astype(np.float32), (rng.random((3, 5)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(tlosses.mask_intersection(_t(m1), _t(m2)).numpy(),
                                  np.asarray(jlosses.mask_intersection(m1, m2)))
    np.testing.assert_array_equal(tlosses.mask_not(_t(m1)).numpy(),
                                  np.asarray(jlosses.mask_not(m1)))


@pytest.mark.parametrize("row_mask", [None, "padded"])
@pytest.mark.parametrize("bidirect", [True, False])
def test_contrastive_loss_equals_jax(row_mask, bidirect):
    img, txt = _rand((8, 16), 7), _rand((8, 16), 8)
    img[5] = img[2]                                       # a duplicated (padded) row
    txt[5] = txt[2]
    rm = None if row_mask is None else np.array([1, 1, 1, 1, 1, 0, 0, 1], bool)
    ref = jlosses.contrastive_loss(jnp.asarray(img), jnp.asarray(txt), bidirect,
                                   row_mask=None if rm is None else jnp.asarray(rm))
    got = tlosses.contrastive_loss(_t(img), _t(txt), bidirect,
                                   row_mask=None if rm is None else _t(rm))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


# -- DeviceKG, _contains, corrupt_within_nodes ----------------------------------


@pytest.fixture(scope="module")
def big_row_table():
    """tiny_kg-like random triples plus one (h, r) row of 200 tails and one
    (t, r) row of 150 heads: both past EXACT_PAD, so the big-row tier runs."""
    rng = np.random.default_rng(10)
    n_ent, n_rel = 260, 5
    tri = np.stack([rng.integers(0, n_ent, 600), rng.integers(0, n_rel, 600),
                    rng.integers(0, n_ent, 600)], 1)
    big_t = np.stack([np.zeros(200), np.zeros(200), np.arange(200) + 30], 1)
    big_h = np.stack([np.arange(150) + 7, np.full(150, 1), np.full(150, 3)], 1)
    tri = np.unique(np.concatenate([tri, big_t, big_h]).astype(np.int32), axis=0)
    return tri, n_ent, n_rel


def _tables(tri, n_ent, n_rel, compact):
    jt = jkg.TripleTable.build(tri, n_ent, n_rel)
    tt = tkg.TripleTable.build(tri, n_ent, n_rel)
    return (jt, jkg.DeviceKG.from_table(jt, compact=compact),
            tt, tkg.DeviceKG.from_table(tt, "cpu", compact=compact))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("kg_name", ["tiny_kg", "big_rows"])
def test_device_kg_and_contains_equal_jax(tiny_kg, big_row_table, compact, kg_name):
    tri, n_ent, n_rel = ((tiny_kg.triples, tiny_kg.n_entities, tiny_kg.n_relations)
                         if kg_name == "tiny_kg" else big_row_table)
    jt, jd, tt, td = _tables(tri, n_ent, n_rel, compact)
    for name in ("triples", "hr_offsets", "tr_offsets", "hrt_tails", "trh_heads",
                 "left_mean", "right_mean", "hr_big_index", "hr_big_d", "tr_big_index",
                 "tr_big_d", "pair_keys", "pair_rels", "hr_row_keys", "tr_row_keys"):
        a, b = getattr(td, name), getattr(jd, name)
        if b is None:
            assert a is None, name
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert td.max_row_len() == jd.max_row_len()
    rng = np.random.default_rng(11)
    rows = rng.integers(0, n_ent * n_rel, 300).astype(np.int32)
    for a, b in zip(td.hr_range(_t(rows)), jd.hr_range(jnp.asarray(rows))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # true triples, random triples, and queries on the big rows
    q = np.concatenate([
        tri[rng.integers(0, len(tri), 200)],
        np.stack([rng.integers(0, n_ent, 300), rng.integers(0, n_rel, 300),
                  rng.integers(0, n_ent, 300)], 1),
        np.stack([np.zeros(100), np.zeros(100), rng.integers(0, n_ent, 100)], 1),
        np.stack([rng.integers(0, n_ent, 100), np.full(100, 1), np.full(100, 3)], 1),
    ]).astype(np.int32).reshape(35, 20, 3)
    ref = np.asarray(jsampling._contains(jd, *(jnp.asarray(q[..., i]) for i in range(3))))
    got = tsampling._contains(td, *(_t(q[..., i]) for i in range(3))).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got.ravel(), tt.contains(*q.reshape(-1, 3).T))


def _jax_draws(key, B, n_neg, n_local, rounds=jsampling.REJECTION_ROUNDS):
    """The draws jsampling.corrupt_within_nodes makes from ``key``."""
    k_side, k_draw = jax.random.split(key)
    side = jax.random.uniform(k_side, (B, n_neg)) < 0.5
    cand = [jax.random.randint(k, (B, n_neg), 0, n_local, dtype=jnp.int32)
            for k in jax.random.split(k_draw, rounds)]
    return np.asarray(side), np.stack([np.asarray(c) for c in cand])


@pytest.mark.parametrize("dense", [False, True])
def test_corrupt_within_nodes_equals_jax_with_its_draws(tiny_kg, dense):
    if dense:     # complete digraph: every proposal is true, every entry fails
        tri = np.asarray([[h, 0, t] for h in range(6) for t in range(6)], np.int32)
        n_ent, n_rel, n_local = 6, 1, 6
    else:
        tri, n_ent, n_rel, n_local = tiny_kg.triples, 50, 7, 20
    tri_l = tri[(tri[:, 0] < n_local) & (tri[:, 2] < n_local)]
    _, jd, _, td = _tables(tri, n_ent, n_rel, False)
    key = jax.random.key(12)
    n_id = np.arange(n_local, dtype=np.int32)[::-1].copy()   # local ≠ global ids
    h_l, t_l = n_local - 1 - tri_l[:, 0], n_local - 1 - tri_l[:, 2]
    ref = jsampling.corrupt_within_nodes(key, jd, jnp.asarray(n_id), jnp.asarray(h_l),
                                         jnp.asarray(tri_l[:, 1]), jnp.asarray(t_l), 4)
    side, cand = _jax_draws(key, len(tri_l), 4, n_local)
    got = tsampling.corrupt_within_nodes(td, _t(n_id), _t(h_l), _t(tri_l[:, 1]), _t(t_l), 4,
                                         side=_t(side), cand_local=_t(cand))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.asarray(ref[2]).all() == dense


def test_corrupt_within_nodes_own_draws_never_true(tiny_kg):
    """Property with the port's generator: a negative is a true triple only
    when it kept the positive, and exactly those entries are ``failed``."""
    _, _, tt, td = _tables(tiny_kg.triples, 50, 7, False)
    tri = tiny_kg.triples[(tiny_kg.triples[:, 0] < 20) & (tiny_kg.triples[:, 2] < 20)]
    gen = torch.Generator().manual_seed(0)
    neg_h, neg_t, failed = (x.numpy() for x in tsampling.corrupt_within_nodes(
        td, torch.arange(20), _t(tri[:, 0]), _t(tri[:, 1]), _t(tri[:, 2]), 6,
        generator=gen))
    assert (neg_h < 20).all() and (neg_t < 20).all()
    same = (neg_h == tri[:, :1]) & (neg_t == tri[:, 2:])
    is_true = tt.contains(neg_h.ravel(), np.repeat(tri[:, 1], 6),
                          neg_t.ravel()).reshape(neg_h.shape)
    assert not (is_true & ~same).any()
    np.testing.assert_array_equal(failed, same)
    changed = (neg_h != tri[:, :1]).astype(int) + (neg_t != tri[:, 2:]).astype(int)
    assert changed.max() <= 1                            # one side at a time


# -- host data: neighbor sampler, training images -------------------------------


@pytest.fixture(scope="module")
def zsl_data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("zsl_train_data"))
    write_zsl_dataset(path, n_ent=40, n_rel=6, n_unseen=2, triples_per_rel=20,
                      image_size=12, seed=13)
    return load_zsl_dataset(path, mode="train")


def test_neighbor_sampler_batches_equal_jax(zsl_data):
    ei, et = jgs.edges_from_tasks(np.asarray(zsl_data["triples"]).T)
    a = jgs.NeighborSampler(ei, et, 40, size=3, batch_size=5, seed=14)
    b = tgs.NeighborSampler(ei, et, 40, size=3, batch_size=5, seed=14)
    assert len(a) == len(b) and (a.n_max, a.e_max) == (b.n_max, b.e_max)
    for _ in range(2):                                   # two epochs: the rng carries on
        for ja, tb in zip(a, b, strict=True):
            assert set(ja) == set(tb)
            for k in ja:
                assert ja[k].dtype == tb[k].dtype, k
                np.testing.assert_array_equal(tb[k], ja[k], err_msg=k)


def test_train_images_equal_jax(zsl_data):
    kw = dict(image_size=16, vocab_size=100, tokenizer_max_length=6,
              unpaired_tokenizer_max_length=10, seed=15)
    js = jmm.MultimodalStore(zsl_data["mm_info"], zsl_data["rel_des"],
                             jmm.MultimodalPipelineConfig(**kw))
    ts = tmm.MultimodalStore(zsl_data["mm_info"], zsl_data["rel_des"],
                             tmm.MultimodalPipelineConfig(**kw))
    nodes = np.random.default_rng(16).integers(0, 40, 24)
    for _ in range(3):                                   # seeds come from the store's rng
        jb = js.generate_batch(nodes, [0, 1], train=True)
        tb = ts.generate_batch(nodes, [0, 1], train=True)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


# -- spectral norm, schedule, optimizer ------------------------------------------


def test_sndense_power_step_equals_jax():
    """Training forward: one power step on the stored u, σ from the NEW
    u, v, buffers updated without gradient; the gradient flows through W
    only."""
    x = _rand((4, 12), 17)
    jmod = jsn.SNDense(features=8)
    vars_ = jmod.init(jax.random.key(18), jnp.asarray(x))
    spectral = {"u": _rand((8,), 19), "v": _rand((12,), 20)}

    def loss(params):
        y, new = jmod.apply({"params": params, "spectral": spectral}, jnp.asarray(x),
                            update_stats=True, mutable=["spectral"])
        return jnp.sum(y ** 2), (y, new["spectral"])

    (_, (ref, new)), grads = jax.value_and_grad(loss, has_aux=True)(vars_["params"])
    tmod = load_flax(tsn.SNDense(12, 8), _np(vars_["params"]), spectral)
    out = tmod(_t(x), update_stats=True)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tmod.u.numpy(), np.asarray(new["u"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmod.v.numpy(), np.asarray(new["v"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmod.weight.grad.numpy().T, np.asarray(grads["kernel"]),
                               rtol=1e-5, atol=1e-6)
    assert not tmod.u.requires_grad and not tmod.v.requires_grad


def test_cosine_warm_restarts_equals_optax():
    t0 = 7
    for lr_max, lr_min in ((1e-4, 0.0), (3e-3, 1e-5)):
        ref, got = j_schedule(lr_max, lr_min, t0, total_steps=20 * t0), \
            t_schedule(lr_max, lr_min, t0, total_steps=20 * t0)
        for step in range(3 * t0 + 1):
            np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                       atol=1e-6 * lr_max, err_msg=str(step))
    # past the last boundary the last period holds its floor, as in join_schedules
    ref, got = j_schedule(1.0, 0.1, 2, total_steps=5), t_schedule(1.0, 0.1, 2, total_steps=5)
    for step in range(12):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6)


def test_adam_update_equals_optax():
    """torch Adam(betas (0.9, 0.999), eps 1e-8) with the rate set from the
    schedule before each step == optax.adam(schedule)."""
    p0 = {"a": _rand((5, 3), 21), "b": _rand((7,), 22)}
    grads = [{k: _rand(v.shape, 23 + i + j) for j, (k, v) in enumerate(p0.items())}
             for i in range(3)]
    tx = optax.adam(j_schedule(1e-2, 0.0, 2, total_steps=10))
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(params)
    sched = t_schedule(1e-2, 0.0, 2, total_steps=10)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt = torch.optim.Adam(tp.values(), lr=sched(0), betas=(0.9, 0.999), eps=1e-8)
    for step, g in enumerate(grads):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        for group in opt.param_groups:
            group["lr"] = sched(step)
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-6, atol=1e-6)


# -- models: M3AE and UnifiedModel training forwards ------------------------------


def test_nonzero_dropout_is_refused():
    """Nonzero rates build (ported); what is still refused is a
    non-deterministic pass with nonzero rates and no mask source."""
    x = torch.ones(2, 3, 32)
    block = Transformer(32, 1, 2, drop_path=0.1)
    assert block(x).shape == x.shape                      # deterministic by default
    with pytest.raises(ValueError, match="dropout rates needs drop"):
        block(x, deterministic=False)
    model = tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config("tiny", dict(att_drop=0.1)))
    assert model.encoder.Block_0.Attention_0.att_drop == 0.1
    with pytest.raises(ValueError, match="dropout rates needs drop"):
        model(None, torch.ones(2, 4, dtype=torch.int64), torch.zeros(2, 4),
              text_ids_shuffle=torch.arange(4))


def _ids(mask_row):
    """ids_shuffle with the same kept set as a JAX mask row (kept first)."""
    return _t(np.argsort(np.asarray(mask_row), kind="stable"))


@pytest.mark.parametrize("with_image", [True, False])
def test_m3ae_call_equals_flax(with_image):
    cfg = jm3ae.m3ae_config("tiny", dict(attention_impl="xla", image_mask_ratio=0.5,
                                         text_mask_ratio=0.75))
    jmod = jm3ae.M3AE(text_vocab_size=50, patch_size=8, image_output_dim=192, config=cfg)
    img, txt = _rand((3, 16, 192), 24), np.random.default_rng(25).integers(1, 50, (3, 8))
    pad = np.zeros((3, 8), np.float32)
    pad[:, 5:] = 1.0
    pad[2, 2:] = 1.0
    rngs = {"params": jax.random.key(26), "masking": jax.random.key(27)}
    jimg = jnp.asarray(img) if with_image else None
    params = jmod.init(rngs, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(pad))["params"]
    ref = jmod.apply({"params": params}, jimg, jnp.asarray(txt), jnp.asarray(pad),
                     rngs={"masking": jax.random.key(28)})
    tmod = load_flax(tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config(
        "tiny", dict(image_mask_ratio=0.5, text_mask_ratio=0.75))), _np(params))
    with torch.no_grad():
        out = tmod(_t(img) if with_image else None, _t(txt), _t(pad),
                   _ids(ref[2][0]) if with_image else None, _ids(ref[3][0]))
    for a, b in zip(out, ref):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)


def test_unified_training_call_equals_flax():
    trainer = graft._tiny_setup()
    db = {k: np.asarray(v) for k, v in
          trainer.prepare_device_batch(next(iter(trainer.sampler))).items()}
    keys = ("text", "text_padding_mask", "rel_des", "rel_des_padding_mask", "image_patches")
    (ref_x, ref_r, ref_out), new_vars = trainer.model.apply(
        {"params": trainer.params, "spectral": trainer.spectral},
        jnp.asarray(db["edge_index"]), jnp.asarray(db["edge_type"]),
        {k: jnp.asarray(db[k]) for k in keys}, False, edge_mask=jnp.asarray(db["edge_mask"]),
        update_sn=True, node_mask=jnp.asarray(db["node_mask"]), mutable=["spectral"],
        rngs={"masking": jax.random.key(29), "dropout": jax.random.key(30)})
    c = trainer.cfg
    port = UnifiedModel(trainer.store.vocab_size, trainer.table.n_relations,
                        unified_config(c.model_type, dict(
                            emb_dim=c.emb_dim, noise_dim=c.noise_dim, patch_size=c.patch_size,
                            image_mask_ratio=c.image_mask_ratio,
                            text_mask_ratio=c.text_mask_ratio)))
    load_flax(port, _np(trainer.params), _np(trainer.spectral))
    t = {k: _t(v) for k, v in db.items()}
    with torch.no_grad():
        x_gcn, rel_emb, out = port.forward_train(
            t["edge_index"], t["edge_type"], {k: t[k] for k in keys},
            _ids(ref_out["image_mask"][0]), _ids(ref_out["text_mask"][0]),
            edge_mask=t["edge_mask"], update_sn=True, node_mask=t["node_mask"])
    np.testing.assert_allclose(x_gcn.numpy(), np.asarray(ref_x), **FWD)
    np.testing.assert_allclose(rel_emb.numpy(), np.asarray(ref_r), **FWD)
    for k in ("image_output", "text_output", "image_mask", "text_mask",
              "contrastive_loss", "contrastive_accuracy"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref_out[k]), **FWD, err_msg=k)
    for name in ("des_rel_map_layer1", "des_rel_map_layer2"):
        for buf in ("u", "v"):
            np.testing.assert_allclose(getattr(getattr(port, name), buf).numpy(),
                                       np.asarray(new_vars["spectral"][name][buf]),
                                       rtol=0, atol=1e-6)
