"""The learnability configuration's serving and ranking, port vs JAX, on the
CPU.

The learnable fixture at the experiment's arguments and
experiments/zsl_learnability.py's configuration (``tiny4``, FusionConfig
emb 32 / noise 8, ZSLConfig test_sample 8, max_neighbor 20). Both sides get
the JAX trainer's weights and the JAX ZSL module's Extractor and
``test_noises``:

* the entity sweep (64 per batch, 33 tokens) and the relation sweep (16
  per batch, 17 tokens) agree within rtol 1e-4, atol 1e-4 (float32,
  summation order only, through four blocks and the RGCN:
  tests/test_torch_port_serving.py's bound);
* with JAX's embeddings in both symbol tables, the ranks of the 59 test
  queries on ``factored``, ``head_shared`` and ``rel_shared`` are EQUAL to
  JAX's;
* with the true tail appended twice to some candidate lists, every such
  rank grows by exactly 2 on every path (the exact pessimistic rank),
  while JAX's float32 comparison may count each duplicate or not.
"""

import json
import shutil

import jax
import numpy as np
import pytest

from mre_tpu.data.fixtures import write_learnable_zsl_dataset
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
from mre_tpu_torch.zsl.module import EVAL_PATHS, ZSLConfig, ZSLModule

# experiments/zsl_learnability.py:52-87
PIPE = dict(image_size=32, vocab_size=512, tokenizer_max_length=16,
            unpaired_tokenizer_max_length=16)
FUSION = dict(model_type="tiny4", emb_dim=32, noise_dim=8, patch_size=8,
              image_mask_ratio=0.5, text_mask_ratio=0.5, batch_size=8, sample_size=4,
              neg_ent=8, lr_maximum=3e-4, epochs=4, seed=0)
ZSL = dict(emb_dim=32, noise_dim=8, test_sample=8, max_neighbor=20, pretrain_batch_size=16,
           pretrain_few=4, pretrain_subepoch=4, D_batch_size=64, G_batch_size=64,
           gan_batch_rela=3, seed=0)
TOL = dict(rtol=1e-4, atol=1e-4)
DUPS = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("learnable"))
    write_learnable_zsl_dataset(path, n_types=6, ents_per_type=20, n_rel=14, n_unseen=3,
                                triples_per_rel=40, n_candidates=30, seed=0)
    data = load_zsl_dataset(path, mode="train")
    triples = np.asarray(data["triples"]).T
    n_ent, n_rel = len(data["e2id"]), len(data["r2id"])
    jf = JFusion(JTable.build(triples, n_ent, n_rel),
                 JStore(data["mm_info"], data["rel_des"], JPipe(**PIPE)),
                 JFusionConfig(**FUSION))
    tf = FusionTrainer(TripleTable.build(triples, n_ent, n_rel),
                       MultimodalStore(data["mm_info"], data["rel_des"],
                                       MultimodalPipelineConfig(**PIPE)),
                       FusionConfig(**FUSION), device="cpu")
    load_flax(tf.model, _np(jf.params), _np(jf.spectral))
    sweeps = dict(j_ent=np.asarray(jf.generate_ent_embeddings(batch_size=64)),
                  j_rel=np.asarray(jf.generate_rel_embeddings(batch_size=16)),
                  t_ent=tf.generate_ent_embeddings(batch_size=64).numpy(),
                  t_rel=tf.generate_rel_embeddings(batch_size=16).numpy())

    def modules(data_path):
        jz = JZSL(data_path, data["r2id"], data["e2id"], JZSLConfig(**ZSL), jf)
        tz = ZSLModule(data_path, data["r2id"], data["e2id"], ZSLConfig(**ZSL), device="cpu",
                       test_noises=np.asarray(jz.test_noises))
        load_flax(tz.extractor, _np(jz.ex_params))
        jz.update_embed(sweeps["j_ent"], sweeps["j_rel"])
        tz.update_embed(sweeps["j_ent"], sweeps["j_rel"])
        return jz, tz

    # the same dataset with the true tail appended DUPS times to every
    # third query's candidate list
    dup_path = str(tmp_path_factory.mktemp("learnable_dups"))
    shutil.copytree(path, dup_path, dirs_exist_ok=True)
    with open(f"{dup_path}/test_candidates.json") as f:
        cands = json.load(f)
    dups = []
    for queries in cands.values():
        for i, (key, lst) in enumerate(queries.items()):
            extra = DUPS if i % 3 == 0 else 0
            lst += [lst[0]] * extra
            dups.append(extra)
    with open(f"{dup_path}/test_candidates.json", "w") as f:
        json.dump(cands, f)
    return dict(jf=jf, tf=tf, sweeps=sweeps, plain=modules(path),
                dup=modules(dup_path), dups=np.asarray(dups))


def test_sweeps_match_jax(pair):
    s = pair["sweeps"]
    assert s["t_ent"].shape == (120, 32) and s["t_rel"].shape == (14, 32)
    np.testing.assert_allclose(s["t_ent"], s["j_ent"], **TOL)
    np.testing.assert_allclose(s["t_rel"], s["j_rel"], **TOL)


def _ranks(pair, which, path):
    jz, tz = pair[which]
    kw = dict(mode="test", verbose=False, query_chunk=16, eval_path=path, return_ranks=True)
    return jz.evaluate(pair["jf"], **kw), tz.evaluate(pair["tf"], **kw)


@pytest.mark.parametrize("path", EVAL_PATHS)
def test_ranks_equal_jax(pair, path):
    a, b = _ranks(pair, "plain", path)
    assert b["n"] == a["n"] == 59
    np.testing.assert_array_equal(b["ranks"], a["ranks"])
    for m in ("hits10", "hits5", "hits1", "mrr"):
        assert b[m] == a[m], m


@pytest.mark.parametrize("path", EVAL_PATHS)
def test_duplicated_true_tails_count_exactly(pair, path):
    """Each appended copy of the true tail raises the exact pessimistic rank
    by one; JAX's own float32 comparison lands between the two."""
    base = _ranks(pair, "plain", path)[1]["ranks"]
    a, b = _ranks(pair, "dup", path)
    dups = pair["dups"]
    assert dups.sum() > 0 and b["n"] == 59
    np.testing.assert_array_equal(b["ranks"], base + dups)
    j = np.asarray(a["ranks"])
    assert np.all((j >= base) & (j <= base + dups))
    np.testing.assert_array_equal(j[dups == 0], base[dups == 0])
