"""flax → torch → flax carries every parameter bitwise (mre_tpu_torch.interop).

Loading is strict, so the round trip also proves the port's module names
mirror the flax tree leaf for leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as graft
from mre_tpu.models.extractor import Extractor as JExtractor
from mre_tpu_torch.interop import flax_to_state_dict, load_flax, module_to_flax
from mre_tpu_torch.models.extractor import Extractor
from mre_tpu_torch.models.unified import UnifiedModel, unified_config


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_unified_round_trip_is_bitwise():
    trainer = graft._tiny_setup()
    c = trainer.cfg
    params, spectral = _np(trainer.params), _np(trainer.spectral)
    port = UnifiedModel(trainer.store.vocab_size, trainer.table.n_relations,
                        unified_config(c.model_type, dict(
                            emb_dim=c.emb_dim, noise_dim=c.noise_dim,
                            patch_size=c.patch_size)))
    load_flax(port, params, spectral)
    sd = port.state_dict()
    # Dense kernels arrive transposed into Linear.weight [out, in]
    k = params["M3AEmodel"]["encoder"]["Block_0"]["Attention_0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(
        sd["M3AEmodel.encoder.Block_0.Attention_0.Dense_0.weight"].numpy(), k.T)
    back_params, back_spectral = module_to_flax(port)
    _assert_trees_equal(back_params, params)
    _assert_trees_equal(back_spectral, spectral)


def test_extractor_round_trip_is_bitwise():
    D = 12
    rng = np.random.default_rng(0)
    symbols = jnp.asarray(rng.normal(size=(20, D)).astype(np.float32))
    conns = jnp.asarray(rng.integers(0, 19, (6, 4, 2)).astype(np.int32))
    degs = jnp.asarray(rng.integers(1, 4, 6).astype(np.float32))
    pairs = jnp.asarray(rng.integers(0, 19, (2, 2)).astype(np.int32))
    meta = (conns[:2], degs[:2], conns[:2], degs[:2])
    params = _np(JExtractor(embed_dim=D).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        symbols, pairs, pairs, meta, meta, False)["params"])
    port = load_flax(Extractor(D), params)
    back, spectral = module_to_flax(port)
    assert spectral == {}
    _assert_trees_equal(back, params)
    assert set(flax_to_state_dict(params)) == set(port.state_dict())
    assert all(t.dtype == torch.float32 for t in port.state_dict().values())
