"""The port's three zero-shot eval paths vs the JAX package's, on the CPU.

Fixture as tests/test_zsl.py::setup. Both sides get the same weights (the
JAX trainer's and Extractor's, carried with ``interop``), the JAX module's
``test_noises`` and the same symbol table (seeded random embeddings). Ranks
must be EQUAL to JAX's on ``factored``, ``head_shared`` and ``rel_shared``;
float outputs of the Extractor's eval methods agree to 1e-5 (float32,
summation order only).
"""

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
from mre_tpu.eval import zero_shot as jzs
from mre_tpu.train.fusion import FusionConfig as JFusionConfig
from mre_tpu.train.fusion import FusionTrainer as JFusion
from mre_tpu.zsl.module import ZSLConfig as JZSLConfig
from mre_tpu.zsl.module import ZSLModule as JZSL
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.eval import zero_shot as tzs
from mre_tpu_torch.interop import load_flax
from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer
from mre_tpu_torch.zsl.module import EVAL_PATHS, ZSLConfig, ZSLModule

PIPE = dict(image_size=16, vocab_size=100, tokenizer_max_length=6,
            unpaired_tokenizer_max_length=10)
MODEL = dict(model_type="tiny", emb_dim=12, noise_dim=4, patch_size=8)
ZSL = dict(emb_dim=12, noise_dim=4, test_sample=5, max_neighbor=10)
ATOL = dict(rtol=0, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("zsl_eval"))
    write_zsl_dataset(path, n_ent=40, n_rel=8, n_unseen=2, triples_per_rel=25,
                      image_size=8, n_candidates=22, seed=9)
    data = load_zsl_dataset(path, mode="train")
    triples = np.asarray(data["triples"]).T
    n_ent, n_rel = len(data["e2id"]), len(data["r2id"])
    jf = JFusion(JTable.build(triples, n_ent, n_rel),
                 JStore(data["mm_info"], data["rel_des"], JPipe(**PIPE)),
                 JFusionConfig(image_mask_ratio=0.5, text_mask_ratio=0.5, batch_size=4,
                               sample_size=2, neg_ent=2, epochs=1, **MODEL))
    jz = JZSL(path, data["r2id"], data["e2id"], JZSLConfig(**ZSL), jf)
    tf = FusionTrainer(TripleTable.build(triples, n_ent, n_rel),
                       MultimodalStore(data["mm_info"], data["rel_des"],
                                       MultimodalPipelineConfig(**PIPE)),
                       FusionConfig(**MODEL), device="cpu")
    load_flax(tf.model, _np(jf.params), _np(jf.spectral))
    tz = ZSLModule(path, data["r2id"], data["e2id"], ZSLConfig(**ZSL), device="cpu",
                   test_noises=np.asarray(jz.test_noises))
    load_flax(tz.extractor, _np(jz.ex_params))
    rng = np.random.default_rng(7)
    ent = rng.normal(size=(n_ent, 12)).astype(np.float32)
    rel = rng.normal(size=(n_rel, 12)).astype(np.float32)
    jz.update_embed(ent, rel)
    tz.update_embed(ent, rel)
    return jf, jz, tf, tz


@pytest.fixture(scope="module")
def tables(pair):
    """The Extractor's eval tables on both sides: (nbr, L, R) each."""
    _, jz, _, tz = pair
    ex, p = jz.extractor, {"params": jz.ex_params}
    ent_sym = tz._entity_symbols()
    j_nbr = ex.apply(p, jz.symbol_table, jz.connections, jz.degrees,
                     method=ex.encode_neighbors)
    j_L, j_R = ex.apply(p, jz.symbol_table, j_nbr, jnp.asarray(ent_sym.numpy()),
                        method=ex.precompute_pair_tables)
    with torch.no_grad():
        t_nbr = tz.extractor.encode_neighbors(tz.symbol_table, tz.connections, tz.degrees)
        t_L, t_R = tz.extractor.precompute_pair_tables(tz.symbol_table, t_nbr, ent_sym)
    return (j_nbr, j_L, j_R), (t_nbr, t_L, t_R)


@pytest.mark.parametrize("eval_path", EVAL_PATHS)
def test_ranks_equal_jax(pair, eval_path):
    jf, jz, tf, tz = pair
    a = jz.evaluate(jf, mode="test", verbose=False, query_chunk=8,
                    eval_path=eval_path, return_ranks=True)
    b = tz.evaluate(tf, mode="test", verbose=False, query_chunk=8,
                    eval_path=eval_path, return_ranks=True)
    assert b["n"] == a["n"] > 0
    np.testing.assert_array_equal(b["ranks"], a["ranks"])
    for m in ("hits10", "hits5", "hits1", "mrr"):
        assert b[m] == a[m], m
    assert b["per_relation"] == a["per_relation"]


def test_default_eval_path_is_head_shared(pair):
    _, _, tf, tz = pair
    a = tz.evaluate(tf, verbose=False, query_chunk=8, return_ranks=True)
    b = tz.evaluate(tf, verbose=False, query_chunk=8, eval_path="head_shared",
                    return_ranks=True)
    np.testing.assert_array_equal(a["ranks"], b["ranks"])


def test_evaluate_prints_per_relation_and_overall(pair, capsys):
    _, _, tf, tz = pair
    res = tz.evaluate(tf, query_chunk=8, eval_path="factored")
    out = capsys.readouterr().out
    assert out.count("Hits10:") == len(res["per_relation"]) == 2
    assert out.count("OVERALL HITS10") == 1


def test_embed_pairs_head_shared_matches_jax(pair, tables):
    _, jz, _, tz = pair
    (_, j_L, j_R), (_, t_L, t_R) = tables
    rng = np.random.default_rng(1)
    heads, cands = rng.integers(0, 40, 5), rng.integers(0, 40, (5, 9))
    ex = jz.extractor
    ref = ex.apply({"params": jz.ex_params}, j_L, j_R, jnp.asarray(heads),
                   jnp.asarray(cands), method=ex.embed_pairs_head_shared)
    with torch.no_grad():
        out = tz.extractor.embed_pairs_head_shared(t_L, t_R, torch.from_numpy(heads),
                                                   torch.from_numpy(cands))
        flat = tz.extractor.embed_pairs_factored(
            t_L, t_R, torch.from_numpy(np.repeat(heads, 9)), torch.from_numpy(cands.ravel()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATOL)
    np.testing.assert_allclose(out.numpy().reshape(-1, 12), flat.numpy(), **ATOL)


def test_embed_pairs_precomputed_matches_jax(pair, tables):
    _, jz, _, tz = pair
    (j_nbr, _, _), (t_nbr, _, _) = tables
    rng = np.random.default_rng(2)
    ent_sym = tz._entity_symbols().numpy()
    left, right = rng.integers(0, 40, 11), rng.integers(0, 40, 11)
    pairs = np.stack([ent_sym[left], ent_sym[right]], 1)
    ex = jz.extractor
    ref = ex.apply({"params": jz.ex_params}, jz.symbol_table, j_nbr, jnp.asarray(pairs),
                   jnp.asarray(left), jnp.asarray(right), method=ex.embed_pairs_precomputed)
    with torch.no_grad():
        out = tz.extractor.embed_pairs_precomputed(
            tz.symbol_table, t_nbr, *(torch.from_numpy(a) for a in (pairs, left, right)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATOL)


def test_score_and_rank_matches_jax_with_ties():
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(6, 10, 8)).astype(np.float32)
    emb[0, 3] = emb[0, 0]             # a tie with the true tail
    emb[1, 5:] = 2 * emb[1, 0]        # ties after normalization
    emb[2] = emb[2, :1]               # every candidate tied
    rv = rng.normal(size=(5, 8)).astype(np.float32)
    mask = rng.random((6, 10)) < 0.8
    mask[:, 0] = True
    mask[2] = True
    ref = np.asarray(jzs._score_and_rank(jnp.asarray(emb), jnp.asarray(rv), jnp.asarray(mask)))
    out = tzs._score_and_rank(torch.from_numpy(emb), torch.from_numpy(rv),
                              torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out[2] == 10                # pessimistic: 1 + every tied candidate


@pytest.mark.parametrize("block", [False, True])
def test_empty_candidate_file_gives_zeros(block):
    def never(*a):
        raise AssertionError("nothing to embed")

    kw = dict(embed_query_block=never) if block else {}
    for cands in ({}, {"rel": {}}):
        res = tzs.evaluate_zero_shot(cands, {}, {}, {}, never,
                                     lambda rel: np.ones((3, 4), np.float32),
                                     verbose=False, return_ranks=True, device="cpu", **kw)
        assert res["n"] == 0 and res["mrr"] == 0.0 and res["hits10"] == 0.0
        assert res["ranks"].shape == (0,) and res["per_relation"] == {}


def test_generate_entity_pair_emb_matches_jax(pair):
    _, jz, _, tz = pair
    rels = list(jz.test_tasks) + ["no-such-relation"]
    j_embs, j_rels, j_extra = jz.generate_entity_pair_emb(rels)
    t_embs, t_rels, t_extra = tz.generate_entity_pair_emb(rels)
    assert t_rels == j_rels and t_extra == j_extra == []
    assert len(t_embs) == len(j_embs) == len(jz.test_tasks)
    for t, j in zip(t_embs, j_embs):
        np.testing.assert_allclose(t, np.asarray(j), **ATOL)
