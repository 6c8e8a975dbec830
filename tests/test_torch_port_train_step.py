"""One fusion training step of the port vs the JAX package's, on the CPU.

Fixture as tests/test_fusion.py, at the ``tiny`` preset (depth 2, decoder
depth 2 with 16 heads of 32). The port's trainer gets the JAX trainer's
initial params and spectral buffers (``interop.load_flax``), the same
sampled subgraph, and the JAX step's draws: the key is split as
fusion.py:254 and :174 split it; the negatives come from
``sampling.corrupt_within_nodes(k_neg, ...)``; the masks are read from the
model's output under ``k_mask`` and handed to the port as ``ids_shuffle`` =
a stable argsort of each mask (kept positions first; only the kept set
matters, since positions are added before masking and the encoder is
permutation-equivariant). The training images come from each side's own
store, seeded alike, and must be the same.

Tolerances (float32 on both sides, summation order only):
* every ``info`` term: rtol 1e-4;
* adam's first moment after one step (optax ``mu`` = 0.1·g, torch
  ``exp_avg``): atol 1e-4 × the leaf's max |mu|: gradients through two
  encoder passes, the decoder and the RGCN, relative to the leaf's scale;
* the spectral buffers after the power step: atol 1e-6 (unit vectors).

``train_epoch`` itself (the port's own, no JAX twin at this size): its mean
equals the mean of its steps' ``info`` to rtol 1e-6; a producer error is
re-raised; an epoch with no batch returns ``{}``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mre_tpu.data.fixtures import write_zsl_dataset
from mre_tpu.data.kg import TripleTable as JTable
from mre_tpu.data.loaders import load_zsl_dataset
from mre_tpu.data.multimodal import MultimodalPipelineConfig as JPipe
from mre_tpu.data.multimodal import MultimodalStore as JStore
from mre_tpu.ops import sampling as jsampling
from mre_tpu.train.fusion import FusionConfig as JFusionConfig
from mre_tpu.train.fusion import FusionTrainer as JFusion
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.interop import load_flax, module_to_flax
from mre_tpu_torch.train.fusion import INFO_KEYS, FusionConfig, FusionTrainer

PIPE = dict(image_size=32, vocab_size=200, tokenizer_max_length=8,
            unpaired_tokenizer_max_length=16)
CFG = dict(model_type="tiny", emb_dim=16, noise_dim=4, patch_size=8,
           image_mask_ratio=0.5, text_mask_ratio=0.5, batch_size=4, sample_size=2,
           neg_ent=3, epochs=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def first_step_pair(path, pipe, cfg):
    """The JAX and the port trainer on the dataset at ``path`` (the port
    with the JAX trainer's parameters and spectral vectors), the first
    sampled subgraph, its JAX device batch, and the JAX step's draws in the
    port's form."""
    data = load_zsl_dataset(path, mode="train")
    triples = np.asarray(data["triples"]).T
    n_ent, n_rel = len(data["e2id"]), len(data["r2id"])
    jf = JFusion(JTable.build(triples, n_ent, n_rel),
                 JStore(data["mm_info"], data["rel_des"], JPipe(**pipe)),
                 JFusionConfig(**cfg))
    tf = FusionTrainer(TripleTable.build(triples, n_ent, n_rel),
                       MultimodalStore(data["mm_info"], data["rel_des"],
                                       MultimodalPipelineConfig(**pipe)),
                       FusionConfig(**cfg), device="cpu")
    load_flax(tf.model, _np(jf.params), _np(jf.spectral))

    graph_batch = next(iter(jf.sampler))
    db = jf.prepare_device_batch(graph_batch)

    # the JAX step's draws (fusion.py:254 then :174)
    _, sub = jax.random.split(jf._rng)
    k_mask, k_drop, k_neg = jax.random.split(sub, 3)
    ei = db["edge_index"]
    neg_h, neg_t, failed = jsampling.corrupt_within_nodes(
        k_neg, jf.kg, db["n_id"], ei[0], db["edge_type"], ei[1], jf.cfg.neg_ent)
    keys = ("text", "text_padding_mask", "rel_des", "rel_des_padding_mask", "image_patches")
    (_, _, out), _ = jax.jit(lambda p, s: jf.model.apply(
        {"params": p, "spectral": s}, ei, db["edge_type"], {k: db[k] for k in keys},
        False, edge_mask=db["edge_mask"], update_sn=True, node_mask=db["node_mask"],
        mutable=["spectral"], rngs={"masking": k_mask, "dropout": k_drop}))(
            jf.params, jf.spectral)
    draws = {
        "image_ids_shuffle": torch.from_numpy(
            np.argsort(np.asarray(out["image_mask"])[0], kind="stable")),
        "text_ids_shuffle": torch.from_numpy(
            np.argsort(np.asarray(out["text_mask"])[0], kind="stable")),
        "neg_h": torch.from_numpy(np.array(neg_h)),
        "neg_t": torch.from_numpy(np.array(neg_t)),
        "neg_failed": torch.from_numpy(np.array(failed)),
    }
    return jf, tf, graph_batch, db, draws


@pytest.fixture(scope="module")
def one_step(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("zsl_train"))
    write_zsl_dataset(path, n_ent=30, n_rel=6, n_unseen=2, triples_per_rel=12,
                      image_size=8, seed=5)
    jf, tf, graph_batch, db, draws = first_step_pair(path, PIPE, CFG)
    params, spectral, opt_state, _, j_info = jf._step_fn(
        jf.params, jf.spectral, jf.opt_state, jf._rng, db)
    tb = tf.prepare_device_batch(graph_batch)
    t_info = {k: float(v) for k, v in tf.step(tb, draws).items()}
    return dict(tf=tf, db=_np(db), tb={k: v.numpy() for k, v in tb.items()},
                j_info={k: float(v) for k, v in j_info.items()}, t_info=t_info,
                mu=_np(opt_state[0].mu), spectral=_np(spectral))


def test_device_batch_equals_jax(one_step):
    """Same subgraph, and the same training images (crop + flip draws from
    each store's own seeded generator), bit for bit."""
    db, tb = one_step["db"], one_step["tb"]
    assert set(tb) == set(db)
    for k in db:
        np.testing.assert_array_equal(tb[k], db[k], err_msg=k)


def test_info_terms_match_jax(one_step):
    j, t = one_step["j_info"], one_step["t_info"]
    assert set(t) == set(j) == set(INFO_KEYS)
    for k in INFO_KEYS:
        assert np.isfinite(t[k]), k
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_adam_first_moment_matches_jax(one_step):
    tf, mu = one_step["tf"], one_step["mu"]
    shadow = copy.deepcopy(tf.model)
    state = tf.optimizer.state
    with torch.no_grad():
        for p, q in zip(tf.model.parameters(), shadow.parameters()):
            q.copy_(state[p]["exp_avg"] if p in state else torch.zeros_like(p))
    t_mu, _ = module_to_flax(shadow)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(mu)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(t_mu)[0])
    assert set(flat_t) == set(flat_j)
    nonzero = 0
    for path, ref in flat_j.items():
        scale = float(np.abs(ref).max())
        nonzero += scale > 0
        np.testing.assert_allclose(flat_t[path], ref, rtol=0, atol=1e-4 * scale + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))
    assert nonzero > 0.9 * len(flat_j)


@pytest.fixture(scope="module")
def port_trainer(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("zsl_epoch"))
    write_zsl_dataset(path, n_ent=20, n_rel=6, n_unseen=2, triples_per_rel=12,
                      image_size=8, seed=6)
    data = load_zsl_dataset(path, mode="train")
    return FusionTrainer(TripleTable.build(np.asarray(data["triples"]).T,
                                           len(data["e2id"]), len(data["r2id"])),
                         MultimodalStore(data["mm_info"], data["rel_des"],
                                         MultimodalPipelineConfig(**PIPE)),
                         FusionConfig(**CFG), device="cpu")


def test_train_epoch_averages_its_steps(port_trainer):
    steps = []
    mean = port_trainer.train_epoch(on_step=steps.append)
    assert len(steps) == port_trainer.steps_per_epoch == 5
    assert set(mean) == set(INFO_KEYS)
    for k in INFO_KEYS:
        np.testing.assert_allclose(mean[k], np.mean([float(s[k]) for s in steps]),
                                   rtol=1e-6, err_msg=k)
        assert np.isfinite(mean[k]), k


def test_train_epoch_reraises_a_producer_error(port_trainer, monkeypatch):
    """A batch that fails to assemble stops the epoch with its own error
    (the stop sentinel still reaches the consumer, so nothing hangs)."""
    def broken(graph_batch):
        raise OSError("corrupt image")

    steps_before = port_trainer.steps
    monkeypatch.setattr(port_trainer, "prepare_device_batch", broken)
    with pytest.raises(OSError, match="corrupt image"):
        port_trainer.train_epoch()
    assert port_trainer.steps == steps_before


def test_train_epoch_with_no_batch_returns_empty(port_trainer, monkeypatch):
    monkeypatch.setattr(port_trainer, "sampler", [])
    assert port_trainer.train_epoch() == {}


def test_spectral_power_step_matches_jax(one_step):
    tf, spectral = one_step["tf"], one_step["spectral"]
    for name in ("des_rel_map_layer1", "des_rel_map_layer2", "generate_fc_layer"):
        layer = getattr(tf.model, name)
        np.testing.assert_allclose(layer.u.numpy(), spectral[name]["u"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(layer.v.numpy(), spectral[name]["v"], rtol=0, atol=1e-6)
