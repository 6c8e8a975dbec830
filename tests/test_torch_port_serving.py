"""The ported zero-shot serving slice end to end vs the JAX package.

Fixture as tests/test_zsl.py::setup. Both sides get the same weights (the
JAX trainer's and Extractor's, carried with ``interop``) and the JAX
module's ``test_noises``; then

    generate_ent_embeddings → generate_rel_embeddings → update_embed →
    evaluate(eval_path="rel_shared")

must give embeddings within 1e-4 (float32, summation order only, through a
two-block transformer and the RGCN) and EQUAL ranks.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mre_tpu.data.fixtures import write_zsl_dataset
from mre_tpu.data.kg import TripleTable as JTable
from mre_tpu.data.loaders import load_zsl_dataset
from mre_tpu.data.multimodal import MultimodalPipelineConfig as JPipe
from mre_tpu.data.multimodal import MultimodalStore as JStore
from mre_tpu.train.fusion import FusionConfig as JFusionConfig
from mre_tpu.train.fusion import FusionTrainer as JFusion
from mre_tpu.zsl.module import ZSLConfig as JZSLConfig
from mre_tpu.zsl.module import ZSLModule as JZSL
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.interop import load_flax
from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer
from mre_tpu_torch.zsl.module import ZSLConfig, ZSLModule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
PIPE = dict(image_size=16, vocab_size=100, tokenizer_max_length=6,
            unpaired_tokenizer_max_length=10)
MODEL = dict(model_type="tiny", emb_dim=12, noise_dim=4, patch_size=8)
ZSL = dict(emb_dim=12, noise_dim=4, test_sample=5, max_neighbor=10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("zsl_port"))
    write_zsl_dataset(path, n_ent=40, n_rel=8, n_unseen=2, triples_per_rel=25,
                      image_size=8, n_candidates=22, seed=9)
    data = load_zsl_dataset(path, mode="train")
    triples = np.asarray(data["triples"]).T
    n_ent, n_rel = len(data["e2id"]), len(data["r2id"])

    jf = JFusion(JTable.build(triples, n_ent, n_rel),
                 JStore(data["mm_info"], data["rel_des"], JPipe(**PIPE)),
                 JFusionConfig(image_mask_ratio=0.5, text_mask_ratio=0.5, batch_size=4,
                               sample_size=2, neg_ent=2, epochs=1, **MODEL))
    jz = JZSL(path, data["r2id"], data["e2id"], JZSLConfig(
        pretrain_batch_size=4, pretrain_few=2, pretrain_subepoch=2,
        D_batch_size=8, G_batch_size=8, gan_batch_rela=2, **ZSL), jf)

    tf = FusionTrainer(TripleTable.build(triples, n_ent, n_rel),
                       MultimodalStore(data["mm_info"], data["rel_des"],
                                       MultimodalPipelineConfig(**PIPE)),
                       FusionConfig(**MODEL), device="cpu")
    load_flax(tf.model, _np(jf.params), _np(jf.spectral))
    tz = ZSLModule(path, data["r2id"], data["e2id"], ZSLConfig(**ZSL), device="cpu",
                   test_noises=np.asarray(jz.test_noises))
    load_flax(tz.extractor, _np(jz.ex_params))
    return jf, jz, tf, tz


@pytest.fixture(scope="module")
def embeddings(slice_pair):
    jf, jz, tf, tz = slice_pair
    j_ent = np.asarray(jf.generate_ent_embeddings(batch_size=16))
    j_rel = np.asarray(jf.generate_rel_embeddings(batch_size=4))
    t_ent = tf.generate_ent_embeddings(batch_size=16).numpy()
    t_rel = tf.generate_rel_embeddings(batch_size=4).numpy()
    return j_ent, j_rel, t_ent, t_rel


def test_triple_order_matches(slice_pair):
    jf, _, tf, _ = slice_pair
    np.testing.assert_array_equal(tf.table.triples, jf.table.triples)


def test_entity_and_relation_embeddings_match(embeddings):
    j_ent, j_rel, t_ent, t_rel = embeddings
    assert t_ent.shape == j_ent.shape and t_rel.shape == j_rel.shape
    np.testing.assert_allclose(t_ent, j_ent, **TOL)
    np.testing.assert_allclose(t_rel, j_rel, **TOL)


def test_generated_relation_vectors_match(slice_pair):
    jf, jz, tf, tz = slice_pair
    rel_ids = np.full(jz.cfg.test_sample, 6)
    ref = np.asarray(jz._generate(jf, jf.params, rel_ids, jz.test_noises))
    with torch.no_grad():
        out = tf.generate(rel_ids, tz.test_noises).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_rel_shared_ranks_equal(slice_pair, embeddings):
    jf, jz, tf, tz = slice_pair
    j_ent, j_rel, t_ent, t_rel = embeddings
    jz.update_embed(j_ent, j_rel)
    tz.update_embed(t_ent, t_rel)
    np.testing.assert_allclose(tz.symbol_table.numpy(), np.asarray(jz.symbol_table), **TOL)
    a = jz.evaluate(jf, mode="test", verbose=False, query_chunk=8,
                    eval_path="rel_shared", return_ranks=True)
    b = tz.evaluate(tf, mode="test", verbose=False, query_chunk=8,
                    eval_path="rel_shared", return_ranks=True)
    assert b["n"] == a["n"] > 0
    np.testing.assert_array_equal(b["ranks"], a["ranks"])
    for m in ("hits10", "hits5", "hits1", "mrr"):
        assert b[m] == a[m], m
    assert set(b["per_relation"]) == set(a["per_relation"])


def test_other_eval_paths_are_refused(slice_pair):
    """An eval_path outside rel_shared / head_shared / factored raises (JAX
    would quietly rank it as factored)."""
    _, _, tf, tz = slice_pair
    with pytest.raises(ValueError, match="rel_shared"):
        tz.evaluate(tf, eval_path="pairwise")


@pytest.mark.parametrize("option", [dict(mesh=object()),
                                    dict(compute_dtype="bfloat16")])
def test_unported_evaluate_options_are_refused(slice_pair, option):
    """A mesh on a path other than ``rel_shared`` raises JAX's ValueError
    (zsl/module.py:598-600; the mesh itself: tests/test_torch_port_mesh.py);
    ``compute_dtype="bfloat16"`` (ported) ranks the same queries with a
    bfloat16 Extractor copy, leaving the module's own parameters float32
    (its ranks against JAX's: tests/test_torch_port_options_bf16.py)."""
    _, _, tf, tz = slice_pair
    if "mesh" in option:
        with pytest.raises(ValueError, match="eval_path='rel_shared' only"):
            tz.evaluate(tf, verbose=False, **option)
        return
    ref = tz.evaluate(tf, verbose=False, query_chunk=8, eval_path="rel_shared",
                      return_ranks=True)
    got = tz.evaluate(tf, verbose=False, query_chunk=8, eval_path="rel_shared",
                      return_ranks=True, **option)
    assert got["n"] == ref["n"] > 0 and got["ranks"].shape == ref["ranks"].shape
    assert 0.0 < got["mrr"] <= 1.0
    assert all(p.dtype == torch.float32 for p in tz.extractor.parameters())


def test_entry_points_need_a_card_unless_told(slice_pair, monkeypatch):
    """No device given and no card: raise, never drop to the CPU."""
    _, _, tf, tz = slice_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusionTrainer(tf.table, tf.store, FusionConfig(**MODEL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ZSLModule(tz.data_path, tz.r2id, tz.e2id, ZSLConfig(**ZSL))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_imports_no_jax_flax_pil_or_mre_tpu():
    """In a fresh interpreter (tests/conftest.py imports jax here): import
    every port module (the parallel layer and its dry run among them) and
    chip_smoke.py, then look at sys.modules."""
    code = r"""
import importlib, pkgutil, sys
import mre_tpu_torch
for m in pkgutil.walk_packages(mre_tpu_torch.__path__, "mre_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
for name in ("mre_tpu_torch.parallel.mesh", "mre_tpu_torch.tools.dryrun_multichip",
             "mre_tpu_torch.utils.build", "mre_tpu_torch.tools.zsl_learnability"):
    assert name in sys.modules, name
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "PIL")
             or n == "mre_tpu" or n.startswith("mre_tpu."))
print("BAD", bad)
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
