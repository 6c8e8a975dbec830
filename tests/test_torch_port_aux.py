"""The port's remaining host modules and small models vs the JAX package's,
on the CPU: ``ops/ranking.candidate_ranks``, ``eval/structural.py``,
``models/exp.py`` (the no-GCN ablation), ``train/pretrain.py``,
``ops/patches.py`` (merge / mask_select), ``utils/images.py``,
``data/prep.py`` and ``utils/eval_fixtures.py``.

Ranks, metrics, host arrays and written files are equal; model outputs and
losses within 2e-5 (float32 summation order, as the other port tests). The
JAX model's random parts reach the port as its draws: the masking
permutations from the JAX masks, the dropout masks recorded by the flax
interceptor of tests/test_torch_port_zsl_train.py.
"""

import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mre_tpu.core.config import Config as JConfig
from mre_tpu.data import prep as jprep
from mre_tpu.eval.structural import evaluate_structural as j_structural
from mre_tpu.models import m3ae as jm3ae
from mre_tpu.models.exp import ExpModel as JExpModel
from mre_tpu.ops import patches as jpatches
from mre_tpu.ops.ranking import candidate_ranks as j_candidate_ranks
from mre_tpu.train.pretrain import m3ae_pretrain_loss as j_pretrain_loss
from mre_tpu.utils import eval_fixtures as jfix
from mre_tpu.utils import images as jimages
from mre_tpu_torch.core.config import Config
from mre_tpu_torch.data import prep
from mre_tpu_torch.eval.structural import evaluate_structural
from mre_tpu_torch.interop import load_flax
from mre_tpu_torch.models import m3ae as tm3ae
from mre_tpu_torch.models.exp import ExpModel
from mre_tpu_torch.models.transformer import DropoutMasks
from mre_tpu_torch.ops import patches
from mre_tpu_torch.ops.ranking import candidate_ranks
from mre_tpu_torch.train.pretrain import m3ae_pretrain_loss
from mre_tpu_torch.utils import eval_fixtures, images
from test_torch_port_zsl_train import DropoutRecorder

FWD = dict(rtol=2e-5, atol=2e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ids(mask_row):
    """ids_shuffle with the same kept set as a JAX mask row (kept first)."""
    return _t(np.argsort(np.asarray(mask_row), kind="stable"))


# -- ranking and the structural evaluator ----------------------------------------


@pytest.mark.parametrize("lower_is_better", [True, False])
def test_candidate_ranks_equal_jax(lower_is_better):
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (6, 9)).astype(np.float32)     # many ties
    mask = rng.random((6, 9)) < 0.8
    mask[:, 0] = True
    ref = j_candidate_ranks(jnp.asarray(scores), jnp.asarray(mask), lower_is_better)
    out = candidate_ranks(_t(scores), _t(mask), lower_is_better)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_evaluate_structural_equals_jax():
    rng = np.random.default_rng(1)
    n_ent, dim = 20, 6
    ent = rng.integers(-2, 3, (n_ent, dim)).astype(np.float32)  # integer embeddings: ties
    rel = rng.integers(-2, 3, (3, dim)).astype(np.float32)
    e2id = {f"e{i}": i for i in range(n_ent)}
    r2id = {f"r{i}": i for i in range(3)}
    cands = {"r0": {}, "r1": {}, "r2": {}}
    for rel_name in ("r0", "r1"):
        for _ in range(7):
            h, t = rng.integers(0, n_ent, 2)
            n = int(rng.integers(3, 9))
            cands[rel_name][f"e{h}\t{rel_name}\te{t}"] = (
                [f"e{t}"] + [f"e{j}" for j in rng.choice(n_ent, n, replace=False)])
    ref = j_structural(cands, ent, rel, e2id, r2id, query_chunk=4, verbose=False)
    out = evaluate_structural(cands, ent, rel, e2id, r2id, query_chunk=4, verbose=False,
                              device="cpu")
    assert out == ref
    with pytest.raises(ValueError, match="no evaluable"):
        evaluate_structural({"r0": {}}, ent, rel, e2id, r2id, device="cpu")


# -- ExpModel and the M3AE pretraining loss ----------------------------------------


def _exp_batch(rng):
    img = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    p = patches.extract_patches(img, 8)
    pad = np.zeros((3, 6), np.float32)
    pad[1, 4:] = 1.0
    return {"image_patches_head": p, "image_patches_tail": p[::-1].copy(),
            "text_head": rng.integers(1, 50, (3, 6)).astype(np.int32),
            "text_tail": rng.integers(1, 50, (3, 6)).astype(np.int32),
            "text_padding_mask_head": pad, "text_padding_mask_tail": pad[::-1].copy(),
            "rel_des": rng.integers(1, 50, (3, 8)).astype(np.int32),
            "rel_des_padding_mask": np.zeros((3, 8), np.float32)}


@pytest.mark.parametrize("is_evaluate", [True, False])
def test_exp_model_equals_jax(is_evaluate):
    cfg = dict(model_type="tiny", emb_dim=12, patch_size=8, image_mask_ratio=0.5,
               text_mask_ratio=0.5)
    jmod = JExpModel(text_vocab_size=50, config=JConfig(cfg))
    batch = _exp_batch(np.random.default_rng(2))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jmod.init, static_argnums=2)(
        {"params": jax.random.key(0), "masking": jax.random.key(1),
         "dropout": jax.random.key(2)}, jb, False)["params"]
    rec = DropoutRecorder(3)
    apply = jax.jit(jmod.apply, static_argnums=(2, 3))     # masks drawn while tracing
    with nn.intercept_methods(rec):
        ref = apply({"params": params}, jb, False, is_evaluate,
                    rngs={"masking": jax.random.key(3), "dropout": jax.random.key(4)})
    masks = rec.take()
    assert len(masks) == 3                          # head, tail, relation
    tmod = load_flax(ExpModel(50, Config(cfg)), _np(params))
    ids = {} if is_evaluate else dict(image_ids_shuffle=_ids(ref[3]["image_mask"][0]),
                                      text_ids_shuffle=_ids(ref[3]["text_mask"][0]))
    drop = DropoutMasks(masks=masks)
    with torch.no_grad():
        out = tmod({k: _t(v) for k, v in batch.items()}, is_evaluate, drop=drop, **ids)
    drop.check_all_used()
    for a, b in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)
    if not is_evaluate:
        for k in ("image_output", "text_output", "image_mask", "text_mask"):
            np.testing.assert_allclose(out[3][k].numpy(), np.asarray(ref[3][k]), **FWD,
                                       err_msg=k)
        assert out[3]["contrastive_loss"] == ref[3]["contrastive_loss"] == 0.0


@pytest.mark.parametrize("all_tokens", [False, True])
def test_m3ae_pretrain_loss_equals_jax(all_tokens):
    cfg = jm3ae.m3ae_config("tiny", dict(attention_impl="xla", image_mask_ratio=0.5,
                                         text_mask_ratio=0.5))
    jmod = jm3ae.M3AE(text_vocab_size=50, patch_size=8, image_output_dim=192, config=cfg)
    rng = np.random.default_rng(5)
    batch = {"image_patches": rng.normal(size=(3, 4, 192)).astype(np.float32),
             "text": rng.integers(1, 50, (3, 6)).astype(np.int32),
             "text_padding_mask": np.zeros((3, 6), np.float32),
             "unpaired_text": rng.integers(1, 50, (3, 10)).astype(np.int32),
             "unpaired_text_padding_mask": np.zeros((3, 10), np.float32)}
    batch["text_padding_mask"][0, 4:] = 1.0
    batch["unpaired_text_padding_mask"][2, 7:] = 1.0
    params = jax.jit(jmod.init)({"params": jax.random.key(6), "masking": jax.random.key(7)},
                                jnp.asarray(batch["image_patches"]), jnp.asarray(batch["text"]),
                                jnp.asarray(batch["text_padding_mask"]))["params"]
    calls = []
    apply = jax.jit(jmod.apply)

    def j_apply(image, text, pad):
        out = apply({"params": params}, image, text, pad,
                    rngs={"masking": jax.random.key(8 + len(calls))})
        calls.append(out)
        return out

    flags = dict(image_all_token_loss=all_tokens, text_all_token_loss=all_tokens)
    j_loss, j_info = j_pretrain_loss(j_apply, {k: jnp.asarray(v) for k, v in batch.items()},
                                     **flags)
    tmod = load_flax(tm3ae.M3AE(50, 8, 192, tm3ae.m3ae_config(
        "tiny", dict(image_mask_ratio=0.5, text_mask_ratio=0.5))), _np(params))
    done = []

    def t_apply(image, text, pad):
        ref = calls[len(done)]
        done.append(1)
        return tmod(image, text, pad, None if image is None else _ids(ref[2][0]),
                    _ids(ref[3][0]))

    with torch.no_grad():
        loss, info = m3ae_pretrain_loss(t_apply, {k: _t(v) for k, v in batch.items()},
                                        **flags)
    assert set(info) == set(j_info)
    np.testing.assert_allclose(float(loss), float(j_loss), **FWD)
    for k, v in j_info.items():
        np.testing.assert_allclose(float(info[k]), float(v), **FWD, err_msg=k)


# -- patches and image helpers -------------------------------------------------------


def test_patch_helpers_equal_jax():
    rng = np.random.default_rng(9)
    p = rng.normal(size=(2, 16, 12)).astype(np.float32)
    mask = (rng.random((2, 16)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(patches.merge_patches(p, 2),
                                  np.asarray(jpatches.merge_patches(jnp.asarray(p), 2)))
    other = rng.normal(size=p.shape).astype(np.float32)
    for args in ((mask, p), (mask, p[..., 0]), (mask, p, other)):
        np.testing.assert_array_equal(
            patches.mask_select(*args),
            np.asarray(jpatches.mask_select(*(jnp.asarray(a) for a in args))))


def test_image_helpers_equal_jax():
    rng = np.random.default_rng(10)
    imgs = [rng.random((3, 8, 8, 3)).astype(np.float32) for _ in range(3)]
    kw = dict(mean=(0.4, 0.5, 0.6), std=(0.2, 0.3, 0.1), n=2)
    np.testing.assert_array_equal(images.create_log_images(imgs, **kw),
                                  jimages.create_log_images(imgs, **kw))
    image = rng.random((2, 16, 16, 3)).astype(np.float32)
    out = rng.normal(size=(2, 4, 192)).astype(np.float32)
    mask = np.array([[0, 1, 1, 0], [1, 0, 0, 1]], np.float32)
    ref = jimages.patch_predict(lambda p, t, pad, key: (jnp.asarray(out), None,
                                                         jnp.asarray(mask), None),
                                image, None, None, 8, None)
    got = images.patch_predict(lambda p, t, pad: (_t(out), None, _t(mask), None),
                               image, None, None, 8)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- offline prep and eval fixtures --------------------------------------------------


def _tasks(seed=11, n_rel=8, n_ent=30):
    rng = np.random.default_rng(seed)
    out = {}
    for r in range(n_rel):
        rel = f"/r/{r}"
        out[rel] = [[f"e{rng.integers(n_ent)}", rel, f"e{rng.integers(n_ent)}"]
                    for _ in range(int(rng.integers(3, 70)))]
    return out


PREP_CASES = {
    "seen_unseen_split": lambda m, t: m.seen_unseen_split(t, n_unseen=3, seed=4),
    "frequency_split": lambda m, t: m.frequency_split(t, n_unseen=2, min_count=5,
                                                      max_count=60, seed=4),
    "train_valid_split": lambda m, t: m.train_valid_split(t, ratio=0.8, seed=4),
    "build_id_maps": lambda m, t: m.build_id_maps(t),
    "gen_e1rel_e2": lambda m, t: m.gen_e1rel_e2(t, _tasks(12)),
    "gen_rel2candidates": lambda m, t: m.gen_rel2candidates(
        t, sorted({row[0] for rows in t.values() for row in rows}), n=10, seed=4),
    "gen_mode_candidates": lambda m, t: m.gen_mode_candidates(
        t, m.gen_rel2candidates(t, [f"e{i}" for i in range(30)], n=12, seed=5),
        m.gen_e1rel_e2(t), max_candidates=6),
    "type_constraints": lambda m, t: m.type_constraints(
        np.asarray([[int(h[1:]), i, int(x[1:])] for i, rows in enumerate(t.values())
                    for h, _, x in rows]), len(t)),
    "embed_relation_texts": lambda m, t: m.embed_relation_texts(
        [" ".join(r.split("/")) + " of the thing" for r in t], dim=16, vocab_size=97),
    "ids_to_names": lambda m, t: m.ids_to_names(
        [[0, 1, 2], [3, 0, 1]], {f"e{i}": i for i in range(5)},
        {f"r{i}": i for i in range(2)}),
}


@pytest.mark.parametrize("case", sorted(PREP_CASES))
def test_prep_equals_jax(case):
    out, ref = PREP_CASES[case](prep, _tasks()), PREP_CASES[case](jprep, _tasks())
    if isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(out, ref)
    else:
        assert out == ref


def test_prep_files_equal_jax(tmp_path):
    head, tail, _ = jprep.type_constraints(
        np.asarray([[0, 0, 1], [2, 0, 1], [1, 1, 3], [1, 1, 4]]), 2)
    with open(tmp_path / "rel2id.txt", "w") as f:
        f.write("2\n/r/a\t0\n/r/b\t1\n")
    for mod, sub in ((prep, "port"), (jprep, "jax")):
        (tmp_path / sub).mkdir()
        mod.write_type_constrain_file(str(tmp_path / sub / "type_constrain.txt"), head, tail)
        mod.id_txt_to_json(str(tmp_path / "rel2id.txt"), str(tmp_path / sub / "rel2ids.json"))
        np.testing.assert_array_equal(
            mod.embed_relation_texts(["a b c", "d"], str(tmp_path / sub / "emb.npz"), dim=8,
                                     vocab_size=31), np.load(tmp_path / sub / "emb.npz")["embeddings"])
    for name in ("type_constrain.txt", "rel2ids.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert prep.read_clean_lines(str(tmp_path / "rel2id.txt")) == \
        jprep.read_clean_lines(str(tmp_path / "rel2id.txt"))


def test_eval_fixture_files_equal_jax(tmp_path):
    rng = np.random.default_rng(13)
    tri = np.stack([rng.integers(0, 40, 200), rng.integers(0, 4, 200),
                    rng.integers(0, 40, 200)], 1)
    for mod, sub in ((eval_fixtures, "port"), (jfix, "jax")):
        samples = mod.generate_fix_samples(tri, 40, str(tmp_path / sub / "sub_test_samples.json"),
                                           neg_ent=2, seed=3, max_batches=3)
        mod.subgraph_to_candidates(samples, str(tmp_path / sub / "sample_candidates.json"))
    for name in ("sub_test_samples.json", "sample_candidates.json"):
        port_bytes = (tmp_path / "port" / name).read_bytes()
        assert port_bytes == (tmp_path / "jax" / name).read_bytes(), name
        assert json.loads(port_bytes)
