"""ZSL training of the port vs the JAX package's, on the CPU.

Fixture as tests/test_zsl.py::setup (the tiny preset, emb 12). Both sides
get the same weights (the JAX fusion model's, Extractor's and
Discriminator's, carried with ``interop.load_flax``) and the same symbol
table. Random draws cannot match across frameworks, so the port takes the
JAX step's:

* the generator noise and the gradient penalty's α are recomputed from the
  keys the JAX step receives (zsl/module.py:189, :219, :425, :452-453);
* dropout: the real JAX steps run under ``flax.linen.intercept_methods``
  with an interceptor that draws each ``nn.Dropout`` keep mask with numpy
  while the jitted step is first traced, records it, and applies it as flax
  does. The port gets the recorded masks in call order (a fresh JAX module
  per comparison, so its steps are traced under the interceptor).

Tolerances (float32 on both sides, summation order only):
* step ``info`` terms and centroids: rtol 1e-4 / atol 1e-6 and atol 1e-5;
* adam moments after one step: atol 1e-4 × the leaf's max |mu| (as in
  tests/test_torch_port_train_step.py), 2e-4 × max |nu| (squared
  gradients);
* parameters after one step: atol 1e-6 (an adam step moves a weight by at
  most lr = 1e-4); after the three epochs of ``train_gan``: atol 1e-5, a
  tenth of lr (a weight whose gradient is within float32 noise of zero may
  take a different step; one of 149k generator weights moves by 1.1e-6);
* spectral buffers: atol 1e-6 (unit vectors).
"""

import copy

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mre_tpu.data.fixtures import write_zsl_dataset
from mre_tpu.data.kg import TripleTable as JTable
from mre_tpu.data.loaders import load_zsl_dataset
from mre_tpu.data.multimodal import MultimodalPipelineConfig as JPipe
from mre_tpu.data.multimodal import MultimodalStore as JStore
from mre_tpu.train.fusion import FusionConfig as JFusionConfig
from mre_tpu.train.fusion import FusionTrainer as JFusion
from mre_tpu.zsl import episodes as jepisodes
from mre_tpu.zsl.module import ZSLConfig as JZSLConfig
from mre_tpu.zsl.module import ZSLModule as JZSL
from mre_tpu_torch.data import loaders
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.interop import load_flax, module_to_flax
from mre_tpu_torch.models.extractor import Discriminator, Extractor
from mre_tpu_torch.models.transformer import DropoutMasks
from mre_tpu_torch.ops import attention
from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer
from mre_tpu_torch.zsl import episodes
from mre_tpu_torch.zsl.module import G_PARAM_KEYS, ZSLConfig, ZSLModule, piecewise_constant_schedule

PIPE = dict(image_size=16, vocab_size=100, tokenizer_max_length=6,
            unpaired_tokenizer_max_length=10)
MODEL = dict(model_type="tiny", emb_dim=12, noise_dim=4, patch_size=8)
ZSL = dict(emb_dim=12, noise_dim=4, test_sample=5, max_neighbor=10,
           pretrain_batch_size=4, pretrain_few=2, pretrain_subepoch=2,
           D_batch_size=8, G_batch_size=8, gan_batch_rela=2)
INFO = dict(rtol=1e-4, atol=1e-6)
D_KEYS = ("loss_D", "D_real", "D_fake", "D_real_class", "D_fake_class", "gp")
G_KEYS = ("loss_G", "G_fake", "G_class", "G_VP")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class DropoutRecorder:
    """flax interceptor: each non-deterministic ``nn.Dropout`` call draws its
    keep mask from a seeded numpy generator (at trace time: shapes are
    static), records it, and applies it as flax does."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.masks = []

    def __call__(self, next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, nn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        det = nn.merge_param("deterministic", mod.deterministic,
                             kwargs.get("deterministic", args[1] if len(args) > 1 else None))
        if det or mod.rate == 0.0:
            return next_fun(*args, **kwargs)
        x, keep = args[0], 1.0 - mod.rate
        mask = self.rng.random(x.shape) < keep
        self.masks.append(mask)
        return jnp.where(mask, x / keep, jnp.zeros_like(x))

    def take(self) -> list:
        out, self.masks = self.masks, []
        return out


def _tree_close(t, j, rel, abs_=0.0, what=""):
    flat_j = dict(jax.tree_util.tree_flatten_with_path(j)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(t)[0])
    assert set(flat_t) == set(flat_j), what
    for path, ref in flat_j.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(flat_t[path], ref, rtol=0,
                                   atol=rel * float(np.abs(ref).max()) + abs_,
                                   err_msg=what + jax.tree_util.keystr(path))


def _adam_trees(module, opt):
    """(mu, nu) of ``opt`` over ``module``'s parameters as flax trees."""
    mu_m, nu_m = copy.deepcopy(module), copy.deepcopy(module)
    with torch.no_grad():
        for p, a, b in zip(module.parameters(), mu_m.parameters(), nu_m.parameters()):
            st = opt.state.get(p, {})
            a.copy_(st.get("exp_avg", torch.zeros_like(p)))
            b.copy_(st.get("exp_avg_sq", torch.zeros_like(p)))
    return module_to_flax(mu_m)[0], module_to_flax(nu_m)[0]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("zsl_gan"))
    # n_candidates must exceed 20 or the GAN batcher skips every relation
    write_zsl_dataset(path, n_ent=40, n_rel=8, n_unseen=2, triples_per_rel=25,
                      image_size=8, n_candidates=22, seed=9)
    data = load_zsl_dataset(path, mode="train")
    triples = np.asarray(data["triples"]).T
    n_ent, n_rel = len(data["e2id"]), len(data["r2id"])
    jf = JFusion(JTable.build(triples, n_ent, n_rel),
                 JStore(data["mm_info"], data["rel_des"], JPipe(**PIPE)),
                 JFusionConfig(image_mask_ratio=0.5, text_mask_ratio=0.5, batch_size=4,
                               sample_size=2, neg_ent=2, epochs=1, **MODEL))
    tf = FusionTrainer(TripleTable.build(triples, n_ent, n_rel),
                       MultimodalStore(data["mm_info"], data["rel_des"],
                                       MultimodalPipelineConfig(**PIPE)),
                       FusionConfig(**MODEL), device="cpu")
    rng = np.random.default_rng(3)
    ent = rng.normal(size=(n_ent, 12)).astype(np.float32)
    rel = rng.normal(size=(n_rel, 12)).astype(np.float32)
    return dict(path=path, data=data, jf=jf, tf=tf, ent=ent, rel=rel)


def _pair(ds):
    """A fresh JAX ZSLModule and a port module with its weights, the same
    symbol table and the JAX fusion weights in the port trainer."""
    data = ds["data"]
    jz = JZSL(ds["path"], data["r2id"], data["e2id"], JZSLConfig(**ZSL), ds["jf"])
    tz = ZSLModule(ds["path"], data["r2id"], data["e2id"], ZSLConfig(**ZSL), device="cpu",
                   test_noises=np.asarray(jz.test_noises))
    load_flax(tz.extractor, _np(jz.ex_params))
    load_flax(tz.discriminator, _np(jz.d_params), _np(jz.d_spectral))
    load_flax(ds["tf"].model, _np(ds["jf"].params), _np(ds["jf"].spectral))
    jz.update_embed(ds["ent"], ds["rel"])
    tz.update_embed(ds["ent"], ds["rel"])
    return jz, tz


# -- host index math ---------------------------------------------------------


def test_episode_sampler_arrays_equal_jax(dataset):
    jz, tz = _pair(dataset)
    cfg = jz.cfg
    for _ in range(5):
        for a, b in zip(jz.episodes.extractor_episode(4, 2, 2),
                        tz.episodes.extractor_episode(4, 2, 2)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        for a, b in zip(jz.episodes.gan_batch(8, 2, jz.r2id),
                        tz.episodes.gan_batch(8, 2, tz.r2id)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        for a, b in zip(jz._padded_episode(), tz._padded_episode()):
            np.testing.assert_array_equal(b, a)
        for a, b in zip(jz._padded_gan_batch(), tz._padded_gan_batch()):
            np.testing.assert_array_equal(b, a)
    for rel in jz.train_tasks:
        for a, b in zip(jz.episodes.centroid_batch(rel), tz.episodes.centroid_batch(rel)):
            np.testing.assert_array_equal(b, a)
    assert tz.label_num == jz.label_num and cfg.G_batch_size == tz.cfg.G_batch_size


def test_false_for_fallbacks_equal_jax(dataset):
    """The rejection sampler's exhausted-pool branches, on pools where every
    draw is rejected (only the true tail, or names outside e2id)."""
    data, path = dataset["data"], dataset["path"]
    tasks = loaders.load_tasks(path, "train")
    r2c, e1r = loaders.load_rel2candidates(path), loaders.load_e1rel_e2(path)
    j = jepisodes.EpisodeSampler(tasks, r2c, e1r,
                                 jepisodes.SymbolTable(data["r2id"], data["e2id"]), seed=4)
    t = episodes.EpisodeSampler(tasks, r2c, e1r,
                                episodes.SymbolTable(data["r2id"], data["e2id"]), seed=4)
    tri = next(iter(tasks.values()))[0]
    for pool in ([tri[2]], ["no-such-entity", tri[2]], ["no-such-entity"],
                 r2c[tri[1]]):
        assert t._false_for(tri, pool) == j._false_for(tri, pool)


# -- models ------------------------------------------------------------------


def test_extractor_forward_matches_jax(dataset):
    jz, tz = _pair(dataset)
    rng = np.random.default_rng(11)
    n_sym = jz.symbols.num_symbols
    query = rng.integers(0, n_sym, (6, 2)).astype(np.int32)
    support = rng.integers(0, n_sym, (3, 2)).astype(np.int32)
    ql, qr = rng.integers(0, 40, 6), rng.integers(0, 40, 6)
    sl, sr = rng.integers(0, 40, 3), rng.integers(0, 40, 3)
    j_meta = lambda l, r: jz._meta(jnp.asarray(l), jnp.asarray(r))
    for det in (True, False):
        rec = DropoutRecorder(5)
        with nn.intercept_methods(rec):
            jq, js = jax.jit(lambda p: jz.extractor.apply(
                {"params": p}, jz.symbol_table, jnp.asarray(query), jnp.asarray(support),
                j_meta(ql, qr), j_meta(sl, sr), det,
                rngs={"dropout": jax.random.key(0)}))(jz.ex_params)
        masks = rec.take()
        assert len(masks) == (0 if det else 10)
        drop = None if det else DropoutMasks(masks=masks)
        with torch.no_grad():
            tq, ts = tz.extractor(tz.symbol_table, torch.from_numpy(query),
                                  torch.from_numpy(support), tz._meta(ql, qr),
                                  tz._meta(sl, sr), det, drop)
        if drop is not None:
            drop.check_all_used()
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)


def test_dropout_masks_refuse_a_count_or_shape_mismatch():
    x = torch.ones(2, 3)
    drop = DropoutMasks(masks=[np.ones((2, 3), bool)])
    np.testing.assert_array_equal(drop(x, 0.2).numpy(), np.full((2, 3), 1.25, np.float32))
    with pytest.raises(ValueError, match="only 1 masks"):
        drop(x, 0.2)
    with pytest.raises(ValueError, match="shape"):
        DropoutMasks(masks=[np.ones((3, 2), bool)])(x, 0.2)
    with pytest.raises(ValueError, match="2 masks given, 1 used"):
        d = DropoutMasks(masks=[np.ones((2, 3), bool)] * 2)
        d(x, 0.2)
        d.check_all_used()
    with pytest.raises(ValueError, match="exactly one"):
        DropoutMasks()
    with pytest.raises(ValueError, match="needs drop"):
        Extractor(4)(torch.zeros(3, 4), torch.zeros(1, 2), torch.zeros(1, 2),
                     None, None, deterministic=False)


@pytest.mark.parametrize("update_sn", [True, False])
def test_discriminator_matches_jax(dataset, update_sn):
    jz, tz = _pair(dataset)
    rng = np.random.default_rng(12)
    ep = rng.normal(size=(7, 12)).astype(np.float32)
    cent = rng.normal(size=(jz.label_num, 12)).astype(np.float32)
    (jm, jl, jc), new_vars = jz.discriminator.apply(
        {"params": jz.d_params, "spectral": jz.d_spectral}, jnp.asarray(ep),
        jnp.asarray(cent), update_sn, mutable=["spectral"])
    with torch.no_grad():
        tm, tl, tc = tz.discriminator(torch.from_numpy(ep), torch.from_numpy(cent),
                                      update_sn=update_sn)
    for t, j in ((tm, jm), (tl, jl), (tc, jc)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    _, t_spec = module_to_flax(tz.discriminator)
    _tree_close(t_spec, _np(new_vars["spectral"]), 0.0, 1e-6, "spectral ")


def test_discriminator_interop_round_trip_is_exact(dataset):
    jz, _ = _pair(dataset)
    d = load_flax(Discriminator(12), _np(jz.d_params), _np(jz.d_spectral))
    params, spectral = module_to_flax(d)
    _tree_close(params, _np(jz.d_params), 0.0, 0.0, "params ")
    _tree_close(spectral, _np(jz.d_spectral), 0.0, 0.0, "spectral ")
    assert set(spectral) == {"fc_middle", "fc_TF"}
    assert set(params) == {"fc_middle", "fc_TF", "layer_norm"}


@pytest.mark.parametrize("init,boundary", [(1e-4, 20000), (1e-4, 4000), (3e-3, 1)])
def test_schedule_equals_optax(init, boundary):
    ref = optax.piecewise_constant_schedule(init, {boundary: 0.2})
    ours = piecewise_constant_schedule(init, {boundary: 0.2})
    for count in (0, boundary - 1, boundary, boundary + 1):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6)


def test_module_schedules_switch_at_their_boundaries(dataset):
    _, tz = _pair(dataset)
    assert tz.d_schedule(19999) == 1e-4 and tz.d_schedule(20000) == pytest.approx(2e-5)
    assert tz.g_schedule(3999) == 1e-4 and tz.g_schedule(4000) == pytest.approx(2e-5)


# -- one step of each kind -----------------------------------------------------


@pytest.fixture(scope="module")
def steps(dataset):
    """One pretrain step, the centroids, one D step and one G step on a
    fresh pair, each compared right after it runs."""
    jf, tf = dataset["jf"], dataset["tf"]
    jz, tz = _pair(dataset)
    rec = DropoutRecorder(21)
    out = {}

    # pretrain (zsl/module.py:149-167)
    ep = jz._padded_episode()
    jz._rng, key = jax.random.split(jz._rng)
    put = jnp.asarray
    with nn.intercept_methods(rec):
        jz.ex_params, jz.opt_E_state, j_loss = jz._pretrain_step(
            jz.ex_params, jz.opt_E_state, key, jz.symbol_table, put(ep[0]), put(ep[1]),
            put(ep[2]), jz._meta(put(ep[3]), put(ep[4])), jz._meta(put(ep[5]), put(ep[6])),
            jz._meta(put(ep[7]), put(ep[8])), put(ep[9]))
    masks = rec.take()
    t_loss = tz.pretrain_step(ep, draws={"dropout": masks})
    out["pretrain"] = dict(n_masks=len(masks), j_loss=float(j_loss), t_loss=float(t_loss),
                           j_params=_np(jz.ex_params), t_params=module_to_flax(tz.extractor)[0],
                           j_adam=_np(jz.opt_E_state[0]), t_adam=_adam_trees(tz.extractor, tz.opt_E))

    out["centroids"] = (np.asarray(jz.compute_centroids()), tz.compute_centroids().numpy())

    # D step (zsl/module.py:422-435 then :186-236)
    batch = jz._padded_gan_batch()
    rng0 = jz._rng
    r, k_noise = jax.random.split(rng0)
    r, k_d = jax.random.split(r)
    Q = len(batch[1])
    noise = np.asarray(jax.random.normal(k_noise, (Q, jz.cfg.noise_dim)))
    alpha = np.asarray(jax.random.uniform(jax.random.split(k_d, 3)[2], (Q, 1)))
    g_params, _ = jz._split_g(jf.params)
    with nn.intercept_methods(rec):
        j_info = jz._run_d_step(jf, g_params, batch)
    masks = rec.take()
    t_info = tz.d_step(tf, batch, draws=dict(noise=noise, alpha=alpha, dropout=masks))
    out["d"] = dict(n_masks=len(masks), j_info={k: float(v) for k, v in j_info.items()},
                    t_info={k: float(v) for k, v in t_info.items()},
                    j_params=_np(jz.d_params), t_params=module_to_flax(tz.discriminator)[0],
                    j_spec=_np(jz.d_spectral), t_spec=module_to_flax(tz.discriminator)[1],
                    j_adam=_np(jz.opt_D_state[0]), t_adam=_adam_trees(tz.discriminator, tz.opt_D))

    # G step (zsl/module.py:437-521)
    batch = jz._padded_gan_batch()
    run_g, g_params, g_state = jz._make_g_step(jf)
    _, k_g = jax.random.split(jz._rng)
    noise = np.asarray(jax.random.normal(jax.random.split(k_g)[0], (Q, jz.cfg.noise_dim)))
    with nn.intercept_methods(rec):
        g_params, g_state, j_info = run_g(g_params, g_state, batch)
    masks = rec.take()
    tz.reset_g_optimizer(tf)
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = attention.FusedAttention.forward, attention.FusedAttention.backward

    def counting(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return staticmethod(wrapped)

    attention.FusedAttention.forward = counting("forward", fwd)
    attention.FusedAttention.backward = counting("backward", bwd)
    try:
        t_info = tz.g_step(tf, batch, draws=dict(noise=noise, dropout=masks))
    finally:
        attention.FusedAttention.forward = staticmethod(fwd)
        attention.FusedAttention.backward = staticmethod(bwd)
    model = tf.model
    out["g"] = dict(n_masks=len(masks), j_info={k: float(v) for k, v in j_info.items()},
                    t_info={k: float(v) for k, v in t_info.items()},
                    j_params={k: _np(g_params[k]) for k in G_PARAM_KEYS},
                    t_params={k: module_to_flax(getattr(model, k))[0] for k in G_PARAM_KEYS},
                    j_spec=_np(jf.spectral), t_spec=module_to_flax(model)[1],
                    j_adam=_np(g_state[0]),
                    t_adam={k: _adam_trees(getattr(model, k), tz.opt_G) for k in G_PARAM_KEYS},
                    attention_calls=calls,
                    fusion_adam_state=len(tf.optimizer.state),
                    grads_left=[n for n, p in model.named_parameters() if p.grad is not None])
    return out


def test_pretrain_step_matches_jax(steps):
    s = steps["pretrain"]
    assert s["n_masks"] == 20          # two Extractor calls, 10 dropout sites each
    np.testing.assert_allclose(s["t_loss"], s["j_loss"], **INFO)
    _tree_close(s["t_params"], s["j_params"], 0.0, 1e-6, "params ")
    _tree_close(s["t_adam"][0], s["j_adam"].mu, 1e-4, 1e-12, "mu ")
    _tree_close(s["t_adam"][1], s["j_adam"].nu, 2e-4, 1e-12, "nu ")


def test_centroids_match_jax(steps):
    j, t = steps["centroids"]
    assert t.shape == j.shape and np.abs(j).sum() > 0
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


def test_d_step_matches_jax(steps):
    s = steps["d"]
    assert s["n_masks"] == 20
    assert set(s["t_info"]) == set(s["j_info"]) == set(D_KEYS)
    for k in D_KEYS:
        assert np.isfinite(s["t_info"][k]), k
        np.testing.assert_allclose(s["t_info"][k], s["j_info"][k], **INFO, err_msg=k)
    assert s["j_info"]["gp"] > 0
    _tree_close(s["t_params"], s["j_params"], 0.0, 1e-6, "params ")
    _tree_close(s["t_spec"], s["j_spec"], 0.0, 1e-6, "spectral ")
    _tree_close(s["t_adam"][0], s["j_adam"].mu, 1e-4, 1e-12, "mu ")
    _tree_close(s["t_adam"][1], s["j_adam"].nu, 2e-4, 1e-12, "nu ")


def test_g_step_matches_jax(steps):
    s = steps["g"]
    assert s["n_masks"] == 10
    assert set(s["t_info"]) == set(s["j_info"]) == set(G_KEYS)
    for k in G_KEYS:
        assert np.isfinite(s["t_info"][k]), k
        np.testing.assert_allclose(s["t_info"][k], s["j_info"][k], **INFO, err_msg=k)
    _tree_close(s["t_params"], s["j_params"], 0.0, 1e-6, "params ")
    _tree_close(s["t_spec"], s["j_spec"], 0.0, 1e-6, "spectral ")
    for k in G_PARAM_KEYS:
        _tree_close(s["t_adam"][k][0], s["j_adam"].mu[k], 1e-4, 1e-12, f"mu {k} ")
        _tree_close(s["t_adam"][k][1], s["j_adam"].nu[k], 2e-4, 1e-12, f"nu {k} ")


def test_g_step_keeps_the_text_pass_out_of_autograd(steps):
    """The description encoding runs through the attention (forward calls)
    but builds no graph: no attention backward, no gradient left on any
    parameter, and the fusion trainer's own adam untouched."""
    s = steps["g"]
    assert s["attention_calls"]["forward"] > 0
    assert s["attention_calls"]["backward"] == 0
    assert s["grads_left"] == []
    assert s["fusion_adam_state"] == 0


# -- a short train_gan -----------------------------------------------------------


def test_train_gan_matches_jax(dataset):
    """train_gan(train_times=3, skip_pretrain=True) with JAX's draws fed in:
    equal histories and generator head."""
    jf, tf = dataset["jf"], dataset["tf"]
    jz, tz = _pair(dataset)
    rng = jz._rng
    Q = jz.cfg.gan_batch_rela * jz.cfg.G_batch_size
    noise_dim = jz.cfg.noise_dim
    keyed = []
    for _ in range(3):
        rng, k_noise = jax.random.split(rng)
        rng, k_d = jax.random.split(rng)
        rng, k_g = jax.random.split(rng)
        keyed.append((np.asarray(jax.random.normal(k_noise, (Q, noise_dim))),
                      np.asarray(jax.random.uniform(jax.random.split(k_d, 3)[2], (Q, 1))),
                      np.asarray(jax.random.normal(jax.random.split(k_g)[0], (Q, noise_dim)))))
    rec = DropoutRecorder(31)
    with nn.intercept_methods(rec):
        j_d, j_g = jz.train_gan(jf, train_times=3, log_every=0, skip_pretrain=True)
    masks = rec.take()
    assert len(masks) == 30            # traced once: the D step's 20, the G step's 10
    draws = []
    for d_noise, alpha, g_noise in keyed:
        draws.append(dict(noise=d_noise, alpha=alpha, dropout=masks[:20]))
        draws.append(dict(noise=g_noise, dropout=masks[20:]))
    t_d, t_g = tz.train_gan(tf, train_times=3, log_every=0, skip_pretrain=True, draws=draws)
    assert len(t_d) == len(j_d) == 3 and len(t_g) == len(j_g) == 3
    for t_hist, j_hist, keys in ((t_d, j_d, D_KEYS), (t_g, j_g, G_KEYS)):
        for t, j in zip(t_hist, j_hist):
            for k in keys:
                assert np.isfinite(t[k]), k
                np.testing.assert_allclose(t[k], j[k], **INFO, err_msg=k)
    for k in G_PARAM_KEYS:
        _tree_close(module_to_flax(getattr(tf.model, k))[0], _np(jf.params[k]), 0.0, 1e-5, k)
    _tree_close(module_to_flax(tf.model)[1], _np(jf.spectral), 0.0, 1e-6, "spectral ")
    _tree_close(module_to_flax(tz.discriminator)[0], _np(jz.d_params), 0.0, 1e-5, "D ")
    assert tz.d_steps == 3 and tz.g_steps == 3


@pytest.mark.parametrize("skip_centroids", [False, True])
def test_train_gan_skip_centroids(dataset, skip_centroids):
    """train_gan recomputes the centroids before its loop unless told to keep
    the last ones (how the loop is timed alone)."""
    tf = dataset["tf"]
    _, tz = _pair(dataset)
    kept = torch.full_like(tz.compute_centroids(), 0.5)
    tz.centroid_matrix = kept
    tz.train_gan(tf, train_times=1, log_every=0, skip_pretrain=True,
                 skip_centroids=skip_centroids)
    assert (tz.centroid_matrix is kept) == skip_centroids
    assert tz.d_steps == 1 and tz.g_steps == 1


def test_pretrain_extractor_logs_and_returns_the_mean(dataset, capsys):
    _, tz = _pair(dataset)
    loss = tz.pretrain_extractor(steps=4, log_every=2)
    assert np.isfinite(loss)
    assert capsys.readouterr().out.count("Extractor pretraining loss") == 2
