"""``compute_dtype="bfloat16"`` in the port vs the JAX package's, on the CPU.

Both sides run the M3AE transformers' Dense layers in bfloat16 over float32
parameters (flax ``Dense(dtype=bf16)``), keep every LayerNorm and the
residual stream in float32, and JAX takes its XLA attention on the CPU
while the port takes its plain twin of the Hopper kernel. Weights are
carried from JAX with ``interop.load_flax``.

Tolerances (bfloat16 has an 8-bit mantissa: one rounding is a relative
2⁻⁹, and a summation order that differs flips the rounding of a few
elements by one unit in the last place, 2⁻⁸, which the following blocks
carry on):
* the Attention module: bit-equal to JAX's XLA branch and to
  ``fused_attention(interpret=True)`` (the same roundings on both sides);
* the M3AE representation: median relative error below 0.005 and max |Δ|
  below 0.05 (values up to ~4; measured 0.0012 and 0.015): the matmuls sum
  in another order, so a few bf16 roundings differ;
* the port's bfloat16 vs its own float32: median relative error below
  0.05 (the gate of tests/test_bf16.py), parameters float32;
* one fusion training step with JAX's draws: every ``info`` term within
  rtol 2e-2 (measured ≤ 1.7e-3); adam's first moment within 0.1 of the
  leaf's largest |mu| (bias gradients sum many positions; measured ≤
  0.094); after adam's first step (±lr per element, the gradient's sign)
  at least 99% of the parameter elements equal JAX's to 1e-3·lr, and none
  more than 2·lr away.

``evaluate(compute_dtype="bfloat16")``: tests/test_torch_port_options_bf16_eval.py.
"""

import functools

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
from mre_tpu.models import m3ae as jm3ae
from mre_tpu.models import transformer as jtr
from mre_tpu.ops import sampling as jsampling
from mre_tpu.ops.pallas import attention as jpallas
from mre_tpu.train.fusion import FusionConfig as JFusionConfig
from mre_tpu.train.fusion import FusionTrainer as JFusion
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.interop import load_flax
from mre_tpu_torch.models import m3ae as tm3ae
from mre_tpu_torch.models import transformer as ttr
from mre_tpu_torch.train.fusion import INFO_KEYS, FusionConfig, FusionTrainer

BF16 = "bfloat16"
REP_MEDIAN_REL, REP_MAX_ABS = 0.005, 0.05
GATE_MEDIAN_REL = 0.05
INFO_RTOL = 2e-2
MU_REL = 0.1
PARAM_EQUAL_MIN = 0.99


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _median_rel(a, ref):
    return float(np.median(np.abs(a - ref) / (np.abs(ref) + 1e-3)))


# -- modules --------------------------------------------------------------------


@pytest.mark.parametrize("branch", ["xla", "pallas_interpret"])
def test_attention_module_bf16_equals_jax(branch, monkeypatch):
    """q, k, v in bf16 from ``Dense_0``; JAX's XLA branch returns float32
    and its Pallas kernel bf16, the port's plain twin bf16: ``Dense_1``
    casts to bf16 in every case, so the outputs are bit-equal."""
    x, pad = _rand((2, 11, 64), 0), np.zeros((2, 11), np.float32)
    pad[:, 8:] = 1.0
    impl = "xla"
    if branch == "pallas_interpret":
        monkeypatch.setattr(jpallas, "fused_attention",
                            functools.partial(jpallas.fused_attention, interpret=True))
        impl = "pallas"
    ja = jtr.Attention(64, 2, True, dtype=jnp.bfloat16, attention_impl=impl)
    params = ja.init(jax.random.key(0), jnp.asarray(x), True, jnp.asarray(pad))["params"]
    ref = ja.apply({"params": params}, jnp.asarray(x), True, jnp.asarray(pad))
    ta = load_flax(ttr.Attention(64, 2, True, dtype=torch.bfloat16), _np(params))
    with torch.no_grad():
        out = ta(torch.from_numpy(x), torch.from_numpy(pad))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in ta.parameters())
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.fixture(scope="module")
def m3ae_models():
    cfg = jm3ae.m3ae_config("tiny", dict(attention_impl="xla", compute_dtype=BF16))
    jmod = jm3ae.M3AE(text_vocab_size=50, patch_size=8, image_output_dim=192, config=cfg)
    img, txt = _rand((2, 16, 192), 10), np.random.default_rng(11).integers(1, 50, (2, 8))
    pad = np.zeros((2, 8), np.float32)
    pad[:, 5:] = 1.0
    params = _np(jax.jit(jmod.init, static_argnums=4)(
        {"params": jax.random.key(7), "masking": jax.random.key(8)},
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(pad), True)["params"])
    ports = {dt: load_flax(tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config(
        "tiny", dict(compute_dtype=dt))), params) for dt in ("float32", BF16)}
    return jmod, params, ports, img, txt, pad


@pytest.mark.parametrize("with_image", [True, False])
def test_m3ae_representation_bf16_matches_jax(m3ae_models, with_image):
    jmod, params, ports, img, txt, pad = m3ae_models
    _, ref = jmod.apply({"params": params}, jnp.asarray(img) if with_image else None,
                        jnp.asarray(txt), jnp.asarray(pad),
                        method=jmod.forward_representation)
    with torch.no_grad():
        _, out = ports[BF16].forward_representation(
            torch.from_numpy(img) if with_image else None, torch.from_numpy(txt),
            torch.from_numpy(pad))
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and ref.dtype == np.float32   # the final LayerNorm
    assert _median_rel(out.numpy(), ref) < REP_MEDIAN_REL
    assert float(np.abs(out.numpy() - ref).max()) < REP_MAX_ABS


def test_m3ae_bf16_close_to_its_float32(m3ae_models):
    """The gate of tests/test_bf16.py on the port; parameters stay float32."""
    _, _, ports, img, txt, pad = m3ae_models
    with torch.no_grad():
        outs = {dt: m.forward_representation(torch.from_numpy(img), torch.from_numpy(txt),
                                             torch.from_numpy(pad))[0].numpy()
                for dt, m in ports.items()}
    assert all(p.dtype == torch.float32 for p in ports[BF16].parameters())
    assert _median_rel(outs[BF16], outs["float32"]) < GATE_MEDIAN_REL
    assert not np.array_equal(outs[BF16], outs["float32"])


def test_unknown_compute_dtype_is_refused():
    with pytest.raises(ValueError, match="compute_dtype"):
        tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config("tiny", dict(compute_dtype="float16")))


# -- one fusion training step ---------------------------------------------------

PIPE = dict(image_size=32, vocab_size=200, tokenizer_max_length=8,
            unpaired_tokenizer_max_length=16)
CFG = dict(model_type="tiny", emb_dim=16, noise_dim=4, patch_size=8,
           image_mask_ratio=0.5, text_mask_ratio=0.5, batch_size=4, sample_size=2,
           neg_ent=3, epochs=2, compute_dtype=BF16)


@pytest.fixture(scope="module")
def bf16_step(tmp_path_factory):
    """As tests/test_torch_port_train_step.py::one_step, in bfloat16."""
    path = str(tmp_path_factory.mktemp("bf16_step"))
    write_zsl_dataset(path, n_ent=30, n_rel=6, n_unseen=2, triples_per_rel=12,
                      image_size=8, seed=5)
    data = load_zsl_dataset(path, mode="train")
    triples = np.asarray(data["triples"]).T
    n_ent, n_rel = len(data["e2id"]), len(data["r2id"])
    jf = JFusion(JTable.build(triples, n_ent, n_rel),
                 JStore(data["mm_info"], data["rel_des"], JPipe(**PIPE)), JFusionConfig(**CFG))
    tf = FusionTrainer(TripleTable.build(triples, n_ent, n_rel),
                       MultimodalStore(data["mm_info"], data["rel_des"],
                                       MultimodalPipelineConfig(**PIPE)),
                       FusionConfig(**CFG), device="cpu")
    params0 = _np(jf.params)
    load_flax(tf.model, params0, _np(jf.spectral))

    graph_batch = next(iter(jf.sampler))
    db = jf.prepare_device_batch(graph_batch)
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
    params, _, opt_state, _, j_info = jf._step_fn(jf.params, jf.spectral, jf.opt_state,
                                                  jf._rng, db)
    lr = float(tf.optimizer.param_groups[0]["lr"])
    t_info = {k: float(v) for k, v in tf.step(tf.prepare_device_batch(graph_batch),
                                              draws).items()}
    return dict(tf=tf, lr=lr, params0=params0, params=_np(params),
                mu=_np(opt_state[0].mu), j_info={k: float(v) for k, v in j_info.items()},
                t_info=t_info)


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_bf16_step_info_terms_match_jax(bf16_step):
    j, t = bf16_step["j_info"], bf16_step["t_info"]
    assert set(t) == set(j) == set(INFO_KEYS)
    for k in INFO_KEYS:
        assert np.isfinite(t[k]), k
        np.testing.assert_allclose(t[k], j[k], rtol=INFO_RTOL, atol=1e-6, err_msg=k)


def test_bf16_step_adam_moment_and_parameters_match_jax(bf16_step):
    from mre_tpu_torch.interop import module_to_flax

    tf, lr = bf16_step["tf"], bf16_step["lr"]
    state = tf.optimizer.state
    mu_t = {}
    for name, p in tf.model.named_parameters():
        mu_t[name] = state[p]["exp_avg"].numpy() if p in state else np.zeros(p.shape, np.float32)
    shadow = module_to_flax(tf.model)[0]          # the parameters after the step
    assert all(p.dtype == torch.float32 for p in tf.model.parameters())
    flat_params = _flat(shadow)
    flat_ref = _flat(bf16_step["params"])
    assert set(flat_params) == set(flat_ref)
    close = total = 0
    for path, ref in flat_ref.items():
        d = np.abs(flat_params[path] - ref)
        assert d.max() <= 2 * lr + 1e-7, (jax.tree_util.keystr(path), float(d.max()))
        close += int((d <= 1e-3 * lr).sum())
        total += d.size
    assert close >= PARAM_EQUAL_MIN * total, close / total

    # the first moment (0.1·g), leaf by leaf, through the flax names
    import copy
    moved = copy.deepcopy(tf.model)
    with torch.no_grad():
        for (name, q) in moved.named_parameters():
            q.copy_(torch.from_numpy(mu_t[name]))
    flat_mu, flat_jmu = _flat(module_to_flax(moved)[0]), _flat(bf16_step["mu"])
    for path, ref in flat_jmu.items():
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(flat_mu[path], ref, rtol=0,
                                   atol=MU_REL * scale + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))
