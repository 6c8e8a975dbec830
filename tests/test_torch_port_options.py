"""The port's ``--pretrained_m3ae`` loader, image cache and nonzero dropout
vs the JAX package's, on the CPU.

* ``load_cc12m_checkpoint``: the JAX side pickles a flax ``TrainState``
  (``apply_fn`` and ``tx`` set to None, adam's state kept) over a tiny
  M3AE tree, as the upstream CC12M file holds one; the port's loader,
  which resolves only the globals such a file names, must leave the module
  with leaves bit-equal to JAX's ``load_cc12m_checkpoint``. A pickle naming
  any other global is refused; a subtree of another structure raises.
* The image cache: the uint8 cache and ``_img_cache_map`` are bit-equal to
  JAX's (PIL on its side), and so are the cached crops of
  ``entity_images`` in training and evaluation, placeholders included.
* Dropout: one M3AE training forward with ``att_drop``, ``drop`` and
  ``drop_path`` > 0 equals JAX's given JAX's masks (recorded by a flax
  interceptor in call order, ``nn.Dropout`` and ``DropPath`` alike) and
  JAX's masking permutations; tolerance 1e-4 as the float32 stacks of
  tests/test_torch_port_models.py.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from flax.training import train_state

from mre_tpu.data.fixtures import write_zsl_dataset
from mre_tpu.data.loaders import load_zsl_dataset
from mre_tpu.data.multimodal import MultimodalPipelineConfig as JPipe
from mre_tpu.data.multimodal import MultimodalStore as JStore
from mre_tpu.models import m3ae as jm3ae
from mre_tpu.models import transformer as jtr
from mre_tpu_torch.cli import main as tmain
from mre_tpu_torch.cli.args import read_options
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.interop import load_flax, module_to_flax
from mre_tpu_torch.models import m3ae as tm3ae
from mre_tpu_torch.models import transformer as ttr
from mre_tpu_torch.models.transformer import DropoutMasks
from mre_tpu_torch.train.fusion import INFO_KEYS, FusionConfig, FusionTrainer

STACK = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _flat(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


# -- --pretrained_m3ae ------------------------------------------------------------


def _jax_m3ae(seed, vocab=50):
    cfg = jm3ae.m3ae_config("tiny", dict(attention_impl="xla"))
    mod = jm3ae.M3AE(text_vocab_size=vocab, patch_size=8, image_output_dim=192, config=cfg)
    img, txt = _rand((2, 4, 192), 0), np.ones((2, 6), np.int32)
    return mod, mod.init({"params": jax.random.key(seed), "masking": jax.random.key(1)},
                         jnp.asarray(img), jnp.asarray(txt), jnp.zeros((2, 6)), True)["params"]


def write_train_state(path, params, variant=None):
    """The upstream file's form: ``{'state': TrainState, 'variant': ...}``
    with ``state.params['params']`` the M3AE tree, pickled after
    ``jax.device_get`` with the unpicklable ``apply_fn`` / ``tx`` dropped."""
    st = train_state.TrainState.create(apply_fn=None, params={"params": params},
                                       tx=optax.adam(1e-3))
    st = jax.device_get(st).replace(tx=None)
    with open(path, "wb") as f:
        pickle.dump({"state": st, "variant": variant or {"model_type": "tiny"}}, f)


@pytest.fixture(scope="module")
def cc12m(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cc12m") / "m3ae_tiny.pkl")
    _, saved = _jax_m3ae(seed=3)
    saved = _np(saved)
    # a leaf saved in another dtype is cast to the initialised leaf's
    saved["cls_token"] = saved["cls_token"].astype(np.float64)
    write_train_state(path, saved)
    _, fresh = _jax_m3ae(seed=4)
    return path, _np(fresh)


def test_cc12m_loader_equals_jax(cc12m):
    path, fresh = cc12m
    ref = _np(jm3ae.load_cc12m_checkpoint(path, fresh))
    port = load_flax(tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config("tiny")), fresh)
    assert tm3ae.load_cc12m_checkpoint(path, port) is port
    got, want = _flat(module_to_flax(port)[0]), _flat(ref)
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert got[key].dtype == leaf.dtype == np.float32, key
        np.testing.assert_array_equal(got[key], leaf, err_msg=jax.tree_util.keystr(key))
    # the copied side moved, the rest kept its init
    with open(path, "rb") as f:
        saved = pickle.load(f)["state"].params["params"]
    for name in ("decoder_text_type_embedding", "image_mask_embedding"):
        np.testing.assert_array_equal(ref[name], saved[name])
    np.testing.assert_array_equal(ref["decoder"]["LayerNorm_0"]["scale"],
                                  fresh["decoder"]["LayerNorm_0"]["scale"])
    assert not np.array_equal(ref["encoder"]["Block_0"]["Attention_0"]["Dense_0"]["kernel"],
                              fresh["encoder"]["Block_0"]["Attention_0"]["Dense_0"]["kernel"])


class _Shell:
    def __reduce__(self):
        return (os.system, ("true",))


def test_cc12m_loader_refuses_a_foreign_global(tmp_path):
    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps({"state": _Shell()}))
    port = tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config("tiny"))
    with pytest.raises(pickle.UnpicklingError, match=r"(posix|os)\.system"):
        tm3ae.load_cc12m_checkpoint(str(path), port)


def test_cc12m_loader_raises_on_another_structure(tmp_path, cc12m):
    _, fresh = cc12m
    saved = jax.tree_util.tree_map(np.copy, fresh)
    del saved["encoder"]["Block_1"]
    path = str(tmp_path / "short.pkl")
    write_train_state(path, saved)
    with pytest.raises(ValueError):
        jm3ae.load_cc12m_checkpoint(path, fresh)
    port = tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config("tiny"))
    with pytest.raises(ValueError, match="encoder"):
        tm3ae.load_cc12m_checkpoint(path, port)


TINY_CLI = ["--dataset", "tiny-zs", "--data_root", "data", "--model_type", "tiny",
            "--emb_dim", "12", "--noise_dim", "4", "--patch_size", "8", "--image_size", "16",
            "--image_mask_ratio", "0.5", "--text_mask_ratio", "0.5", "--batch_size", "4",
            "--sample_size", "2", "--vocab_size", "100", "--output_dir", "runs",
            "--device", "cpu"]


def test_cli_trains_an_epoch_from_a_cc12m_file(tmp_path, monkeypatch):
    """``--pretrained_m3ae`` loads before training; one epoch runs (no ZSL
    round: ``--save_epochs`` beyond ``--epochs``)."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(min(n_threads, 2))
    try:
        write_zsl_dataset(str(tmp_path / "data" / "tiny-zs"), n_ent=30, n_rel=6, n_unseen=2,
                          triples_per_rel=12, image_size=8, n_candidates=22, seed=3)
        monkeypatch.chdir(tmp_path)
        _, saved = _jax_m3ae(seed=5, vocab=100)
        write_train_state("m3ae.pkl", _np(saved))
        built = []
        build = tmain.build_pipeline
        monkeypatch.setattr(tmain, "build_pipeline",
                            lambda args: built.append(build(args)) or built[-1])
        tmain.main(read_options(TINY_CLI + ["--pretrained_m3ae", "m3ae.pkl", "--epochs", "1",
                                            "--save_epochs", "2"]))
    finally:
        torch.set_num_threads(n_threads)
    fusion = built[0][3]
    assert fusion.steps == fusion.steps_per_epoch > 0
    assert os.path.isfile("saved_models/tiny-zs/mre_tpu_small.ckpt")
    # the checkpoint's cls token went in and trained on from there
    cls = fusion.model.M3AEmodel.cls_token.detach().numpy()
    assert np.abs(cls - np.asarray(saved["cls_token"])).max() < 2e-3


# -- the image cache ----------------------------------------------------------------

PIPE = dict(image_size=16, vocab_size=100, tokenizer_max_length=6,
            unpaired_tokenizer_max_length=10, seed=11)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cache"))
    write_zsl_dataset(path, n_ent=30, n_rel=6, n_unseen=2, triples_per_rel=12,
                      image_size=12, seed=4)
    data = load_zsl_dataset(path, mode="train")

    def pair():
        return (JStore(data["mm_info"], data["rel_des"], JPipe(**PIPE)),
                MultimodalStore(data["mm_info"], data["rel_des"],
                                MultimodalPipelineConfig(**PIPE)))

    return data, pair


def test_image_cache_equals_jax(stores):
    _, pair = stores
    js, ts = pair()
    js.precompute_image_cache()
    secs = ts.precompute_image_cache()
    assert secs >= 0.0
    assert ts._img_cache.dtype == np.uint8 and ts._img_cache.shape[1:] == (18, 18, 3)
    np.testing.assert_array_equal(ts._img_cache, js._img_cache)
    np.testing.assert_array_equal(ts._img_cache_map, js._img_cache_map)
    assert ts._cache_size == js._cache_size
    assert (ts._img_cache_map < 0).any() and (ts._img_cache_map >= 0).any()


@pytest.mark.parametrize("train", [True, False])
def test_cached_crops_equal_jax(stores, train):
    """Two batches over every entity (text-only ones get the placeholder);
    in training the slots' seeds come from each store's own generator."""
    data, pair = stores
    js, ts = pair()
    js.precompute_image_cache()
    ts.precompute_image_cache()
    nodes = np.arange(len(data["e2id"]))[::-1]
    for _ in range(2):
        a = js.entity_images(nodes, train=train)
        b = ts.entity_images(nodes, train=train)
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a)


def test_image_cache_refuses_above_8_gb(stores):
    data, _ = stores
    big = MultimodalStore(data["mm_info"], data["rel_des"],
                          MultimodalPipelineConfig(**dict(PIPE, image_size=20000)))
    with pytest.raises(MemoryError, match="GB"):
        big.precompute_image_cache()
    assert big._img_cache is None


def test_defaults_are_the_training_form_as_in_jax(stores):
    """``entity_images`` and ``generate_batch`` without ``train``: JAX's
    default (training) on both sides, so the same arrays."""
    data, pair = stores
    js, ts = pair()
    nodes = np.arange(len(data["e2id"]))
    np.testing.assert_array_equal(ts.entity_images(nodes), js.entity_images(nodes))
    a = js.generate_batch(nodes, [0, 1])
    b = ts.generate_batch(nodes, [0, 1])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("text_only", [False, True])
def test_fusion_config_image_cache_builds_and_steps(stores, text_only):
    data, _ = stores
    table = TripleTable.build(np.asarray(data["triples"]).T, len(data["e2id"]),
                              len(data["r2id"]))
    store = MultimodalStore(data["mm_info"], data["rel_des"],
                            MultimodalPipelineConfig(**dict(PIPE, text_only=text_only)))
    tf = FusionTrainer(table, store, FusionConfig(
        model_type="tiny", emb_dim=12, noise_dim=4, patch_size=8, image_mask_ratio=0.5,
        text_mask_ratio=0.5, batch_size=8, sample_size=2, neg_ent=2, epochs=1,
        text_only=text_only, image_cache=True), device="cpu")
    assert (store._img_cache is None) == text_only
    info = tf.train_epoch()
    assert set(info) == set(INFO_KEYS) and all(np.isfinite(v) for v in info.values())


# -- dropout ---------------------------------------------------------------------------

RATES = dict(att_drop=0.1, drop=0.2, drop_path=0.15)


class DropRecorder:
    """flax interceptor: each non-deterministic ``nn.Dropout`` draws its keep
    mask, each ``DropPath`` its per-sample ``floor(keep + U)``, from a
    seeded numpy generator; both are recorded in call order and applied as
    flax applies them (tests/test_torch_port_zsl_train.py records dropout
    alone)."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.masks = []
        self.kinds = []

    def __call__(self, next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__" or not isinstance(mod, (nn.Dropout, jtr.DropPath)):
            return next_fun(*args, **kwargs)
        x = args[0]
        if isinstance(mod, nn.Dropout):
            det = nn.merge_param("deterministic", mod.deterministic,
                                 kwargs.get("deterministic", args[1] if len(args) > 1 else None))
            if det or mod.rate == 0.0:
                return next_fun(*args, **kwargs)
            keep = 1.0 - mod.rate
            mask = self.rng.random(x.shape) < keep
            self.masks.append(mask)
            self.kinds.append("dropout")
            return jnp.where(mask, x / keep, jnp.zeros_like(x))
        det = kwargs.get("deterministic", args[1] if len(args) > 1 else True)
        if det or mod.dropout_prob == 0.0:
            return next_fun(*args, **kwargs)
        keep = 1.0 - mod.dropout_prob
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = np.floor(keep + self.rng.random(shape, dtype=np.float32)).astype(np.float32)
        self.masks.append(mask)
        self.kinds.append("drop_path")
        return x / keep * jnp.asarray(mask)


def _full(mdl, image, text, pad):
    enc = mdl.forward_encoder(image, text, pad, False)
    dec = mdl.forward_decoder(enc[0], enc[1], enc[2], enc[5], enc[6], pad, False)
    return enc, dec


@pytest.fixture(scope="module")
def dropped():
    cfg = jm3ae.m3ae_config("tiny", dict(attention_impl="xla", **RATES))
    jmod = jm3ae.M3AE(text_vocab_size=50, patch_size=8, image_output_dim=192, config=cfg)
    img, txt = _rand((2, 16, 192), 10), np.random.default_rng(11).integers(1, 50, (2, 8))
    pad = np.zeros((2, 8), np.float32)
    pad[:, 6:] = 1.0
    args = (jnp.asarray(img), jnp.asarray(txt), jnp.asarray(pad))
    params = jmod.init({"params": jax.random.key(7), "masking": jax.random.key(8),
                        "dropout": jax.random.key(9)}, *args, True)["params"]
    rec = DropRecorder(5)
    with nn.intercept_methods(rec):
        enc, dec = jmod.apply({"params": params}, *args, method=_full,
                              rngs={"masking": jax.random.key(2), "dropout": jax.random.key(3)})
    port = load_flax(tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config("tiny", RATES)), _np(params))
    plain = load_flax(tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config("tiny")), _np(params))
    return dict(jmod=jmod, params=params, img=img, txt=txt, pad=pad, rec=rec, enc=enc,
                dec=dec, port=port, plain=plain)


def test_dropout_forward_equals_jax(dropped):
    d = dropped
    rec, enc = d["rec"], d["enc"]
    depth = d["port"].cfg.depth + d["port"].cfg.dec_depth
    # per block: probabilities, proj_drop, DropPath, MLP ×2, DropPath
    assert rec.kinds == ["dropout", "dropout", "drop_path", "dropout", "dropout",
                         "drop_path"] * depth
    shuffles = [torch.from_numpy(np.argsort(np.asarray(r))) for r in (enc[5], enc[6])]
    drop = DropoutMasks(masks=rec.masks)
    with torch.no_grad():
        img_out, txt_out, img_mask, txt_mask = d["port"](
            torch.from_numpy(d["img"]), torch.from_numpy(d["txt"]), torch.from_numpy(d["pad"]),
            *shuffles, deterministic=False, drop=drop)
    drop.check_all_used()
    np.testing.assert_array_equal(img_mask.numpy(), np.asarray(enc[3]))
    np.testing.assert_array_equal(txt_mask.numpy(), np.asarray(enc[4]))
    np.testing.assert_allclose(img_out.numpy(), np.asarray(d["dec"][0]), **STACK)
    np.testing.assert_allclose(txt_out.numpy(), np.asarray(d["dec"][1]), **STACK)


def _count_kernel_calls(monkeypatch):
    calls = []
    real = ttr.fused_attention
    monkeypatch.setattr(ttr, "fused_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("rates", [RATES, dict(drop=0.2, drop_path=0.15)])
def test_dropped_attention_takes_no_kernel(dropped, monkeypatch, rates):
    """A non-deterministic pass with ``att_drop`` > 0 takes the plain
    attention (transformer.py:124); with only ``drop`` / ``drop_path`` the
    kernel path stays, as in JAX."""
    port = load_flax(tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config("tiny", rates)),
                     _np(dropped["params"]))
    calls = _count_kernel_calls(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        port(torch.from_numpy(dropped["img"]), torch.from_numpy(dropped["txt"]),
             torch.from_numpy(dropped["pad"]), torch.arange(16), torch.arange(8),
             deterministic=False, drop=DropoutMasks(generator=gen))
    depth = port.cfg.depth + port.cfg.dec_depth
    assert len(calls) == (0 if rates.get("att_drop") else depth)


def test_deterministic_passes_are_unchanged_by_rates(dropped, monkeypatch):
    """``forward_representation`` (always deterministic) and a deterministic
    masked pass equal the rate-0 model's, bit for bit, through the kernel
    path."""
    d = dropped
    calls = _count_kernel_calls(monkeypatch)
    x = (torch.from_numpy(d["img"]), torch.from_numpy(d["txt"]), torch.from_numpy(d["pad"]))
    with torch.no_grad():
        a = d["port"].forward_representation(*x)[1]
        b = d["plain"].forward_representation(*x)[1]
        c = d["port"](*x, torch.arange(16), torch.arange(8), deterministic=True)[0]
        e = d["plain"](*x, torch.arange(16), torch.arange(8))[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(c.numpy(), e.numpy())
    cfg = d["port"].cfg
    assert len(calls) == 2 * cfg.depth + 2 * (cfg.depth + cfg.dec_depth)
