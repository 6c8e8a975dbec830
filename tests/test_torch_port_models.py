"""Port model modules vs the JAX package's, with carried weights, in float32.

Each case initialises the flax module, carries its parameters into the port
module with ``interop.load_flax`` and feeds both the same numpy inputs.
Tolerances: the two sides differ only in summation order (matmul
blocking, LayerNorm variance formula), so outputs of O(1) agree to ~1e-6;
stacks of blocks and layer norms amplify that, hence atol/rtol 1e-4 for
the transformer stacks and 1e-5 for single layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from mre_tpu.models import m3ae as jm3ae
from mre_tpu.models import rgcn as jrgcn
from mre_tpu.models import spectral_norm as jsn
from mre_tpu.models import transformer as jtr
from mre_tpu_torch.interop import load_flax
from mre_tpu_torch.models import m3ae as tm3ae
from mre_tpu_torch.models import rgcn as trgcn
from mre_tpu_torch.models import spectral_norm as tsn
from mre_tpu_torch.models import transformer as ttr
from mre_tpu_torch.models.unified import UnifiedModel, unified_config

LAYER = dict(rtol=1e-5, atol=1e-5)
STACK = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _tail_pad(B, N, n_pad):
    pad = np.zeros((B, N), np.float32)
    pad[:, N - n_pad:] = 1.0
    return pad


def test_block_matches_flax():
    x, pad = _rand((2, 11, 384), 0), _tail_pad(2, 11, 4)
    jb = jtr.Block(emb_dim=384, num_heads=6, attention_impl="xla")
    params = jb.init(jax.random.key(0), jnp.asarray(x), True, jnp.asarray(pad))["params"]
    ref = jb.apply({"params": params}, jnp.asarray(x), True, jnp.asarray(pad))
    tb = load_flax(ttr.Block(384, 6), _np(params))
    with torch.no_grad():
        out = tb(torch.from_numpy(x), torch.from_numpy(pad))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STACK)


@pytest.mark.parametrize("with_pad", [True, False])
def test_transformer_matches_flax(with_pad):
    x = _rand((2, 13, 384), 1)
    pad = _tail_pad(2, 13, 5) if with_pad else None
    jpad = None if pad is None else jnp.asarray(pad)
    jt = jtr.Transformer(emb_dim=384, depth=2, num_heads=6, attention_impl="xla")
    params = jt.init(jax.random.key(1), jnp.asarray(x), True, jpad)["params"]
    ref = jt.apply({"params": params}, jnp.asarray(x), True, jpad)
    tt = load_flax(ttr.Transformer(384, 2, 6), _np(params))
    with torch.no_grad():
        out = tt(torch.from_numpy(x), None if pad is None else torch.from_numpy(pad))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STACK)


@pytest.mark.parametrize("input_norm", [True, False])
def test_mlp_matches_flax(input_norm):
    x = _rand((5, 16), 2)
    jmod = jtr.MLP(hidden_dim=32, output_dim=10, depth=2, input_norm=input_norm)
    params = jmod.init(jax.random.key(2), jnp.asarray(x))["params"]
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = load_flax(ttr.MLP(16, 32, 10, 2, input_norm), _np(params))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER)


def test_support_encoder_matches_flax():
    x = _rand((7, 24), 3)
    jmod = jtr.SupportEncoder(d_model=24, d_inner=48)
    params = jmod.init(jax.random.key(3), jnp.asarray(x), True)["params"]
    ref = jmod.apply({"params": params}, jnp.asarray(x), True)
    tmod = load_flax(ttr.SupportEncoder(24, 48), _np(params))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER)


@pytest.mark.parametrize("shape", [(3, 8), (3, 1, 8)])
def test_layer_normalization_matches_flax(shape):
    """Unbiased std, eps on the std, identity when axis 1 has size 1."""
    x = _rand(shape, 4, scale=3.0)
    jmod = jtr.LayerNormalization(d_hid=8)
    params = jmod.init(jax.random.key(4), jnp.asarray(x))["params"]
    params = {"a_2": np.linspace(0.5, 1.5, 8, dtype=np.float32),
              "b_2": np.linspace(-1, 1, 8, dtype=np.float32)}
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = load_flax(ttr.LayerNormalization(8), params)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER)


def test_sndense_eval_matches_flax():
    """Eval divides by σ = uᵀWv from the stored buffers, no power step."""
    x = _rand((4, 12), 5)
    jmod = jsn.SNDense(features=8)
    vars_ = jmod.init(jax.random.key(5), jnp.asarray(x))
    # stored u, v that are NOT a power-iteration fixed point: eval must use them as given
    spectral = {"u": _rand((8,), 6), "v": _rand((12,), 7)}
    ref = jmod.apply({"params": vars_["params"], "spectral": spectral}, jnp.asarray(x))
    tmod = load_flax(tsn.SNDense(12, 8), _np(vars_["params"]), spectral)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER)


def test_rgcn_with_padded_edges_matches_flax():
    rng = np.random.default_rng(8)
    N, E, R = 10, 30, 4
    x = _rand((N, 16), 9)
    ei = rng.integers(0, N, (2, E)).astype(np.int32)
    et = rng.integers(0, R, E).astype(np.int32)
    em = np.ones(E, bool)
    em[-6:] = False                               # padded slots
    jmod = jrgcn.RGCNConv(16, 8, R, num_bases=3)
    params = jmod.init(jax.random.key(6), jnp.asarray(x), jnp.asarray(ei),
                       jnp.asarray(et), edge_mask=jnp.asarray(em))["params"]
    ref = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ei),
                     jnp.asarray(et), edge_mask=jnp.asarray(em))
    tmod = load_flax(trgcn.RGCNConv(16, 8, R, 3), _np(params))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), torch.from_numpy(ei), torch.from_numpy(et),
                   edge_mask=torch.from_numpy(em))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER)


@pytest.fixture(scope="module")
def m3ae_pair():
    cfg = jm3ae.m3ae_config("tiny", dict(attention_impl="xla"))
    jmod = jm3ae.M3AE(text_vocab_size=50, patch_size=8, image_output_dim=192, config=cfg)
    img, txt = _rand((2, 16, 192), 10), np.random.default_rng(11).integers(1, 50, (2, 8))
    pad = _tail_pad(2, 8, 3)
    params = jmod.init({"params": jax.random.key(7), "masking": jax.random.key(8)},
                       jnp.asarray(img), jnp.asarray(txt), jnp.asarray(pad), True)["params"]
    tmod = load_flax(tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config("tiny")), _np(params))
    return jmod, params, tmod, img, txt, pad


@pytest.mark.parametrize("with_image", [True, False])
def test_m3ae_forward_representation_matches_flax(m3ae_pair, with_image):
    jmod, params, tmod, img, txt, pad = m3ae_pair
    jimg = jnp.asarray(img) if with_image else None
    ref_cls, ref_all = jmod.apply(
        {"params": params}, jimg, jnp.asarray(txt), jnp.asarray(pad),
        method=jmod.forward_representation)
    with torch.no_grad():
        cls, allx = tmod.forward_representation(
            torch.from_numpy(img) if with_image else None,
            torch.from_numpy(txt), torch.from_numpy(pad))
    np.testing.assert_allclose(cls.numpy(), np.asarray(ref_cls), **STACK)
    np.testing.assert_allclose(allx.numpy(), np.asarray(ref_all), **STACK)


@pytest.fixture(scope="module")
def unified_pair():
    trainer = graft._tiny_setup()
    graph_batch = next(iter(trainer.sampler))
    db = {k: np.asarray(v) for k, v in trainer.prepare_device_batch(graph_batch).items()}
    c = trainer.cfg
    port = UnifiedModel(trainer.store.vocab_size, trainer.table.n_relations,
                        unified_config(c.model_type, dict(
                            emb_dim=c.emb_dim, noise_dim=c.noise_dim,
                            patch_size=c.patch_size)))
    load_flax(port, _np(trainer.params), _np(trainer.spectral))
    return trainer, db, port.eval()


def test_unified_is_evaluate_matches_flax(unified_pair):
    trainer, db, port = unified_pair
    keys = ("text", "text_padding_mask", "rel_des", "rel_des_padding_mask", "image_patches")
    ref_x, ref_r = trainer.model.apply(
        {"params": trainer.params, "spectral": trainer.spectral},
        jnp.asarray(db["edge_index"]), jnp.asarray(db["edge_type"]),
        {k: jnp.asarray(db[k]) for k in keys}, True, is_evaluate=True,
        edge_mask=jnp.asarray(db["edge_mask"]))
    t = {k: torch.tensor(db[k]) for k in db}
    with torch.no_grad():
        x_gcn, rel_emb = port(t["edge_index"], t["edge_type"], {k: t[k] for k in keys},
                              edge_mask=t["edge_mask"])
    np.testing.assert_allclose(x_gcn.numpy(), np.asarray(ref_x), **STACK)
    np.testing.assert_allclose(rel_emb.numpy(), np.asarray(ref_r), **STACK)


def test_unified_generate_matches_flax(unified_pair):
    trainer, db, port = unified_pair
    noise = _rand((db["rel_des"].shape[0], trainer.cfg.noise_dim), 12, scale=0.1)
    ref = trainer.model.apply(
        {"params": trainer.params, "spectral": trainer.spectral},
        jnp.asarray(db["rel_des"]), jnp.asarray(db["rel_des_padding_mask"]),
        jnp.asarray(noise), method=trainer.model.generate)
    with torch.no_grad():
        out = port.generate(torch.tensor(db["rel_des"]),
                            torch.tensor(db["rel_des_padding_mask"]),
                            torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STACK)
