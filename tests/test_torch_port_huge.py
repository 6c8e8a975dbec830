"""The zero-shot serving round at M3AE-huge's head width vs the JAX package.

M3AE-huge's encoder is 16 heads of 80 (``TRANSFORMER_PRESETS["huge"]``),
the one head_dim the attention kernel runs at no other preset. Here the
``huge`` entry of both packages is patched (``monkeypatch.setitem``; no JAX
file changes) to a narrow copy that keeps heads of 80: 2 of them, depth 2,
decoder depth 1. Both sides get the same weights (the JAX trainer's and
Extractor's, carried with ``interop``) and the JAX module's
``test_noises``; then

    generate_ent_embeddings → generate_rel_embeddings → update_embed →
    evaluate(eval_path="rel_shared")

must give embeddings within the tolerance of tests/test_torch_port_serving.py
(1e-4: float32, summation order only) and EQUAL ranks, with every attention
call of the port's round at head_dim 80.
"""

import jax
import numpy as np
import pytest

from mre_tpu.core import config as jconfig
from mre_tpu.data.fixtures import write_zsl_dataset
from mre_tpu.data.kg import TripleTable as JTable
from mre_tpu.data.loaders import load_zsl_dataset
from mre_tpu.data.multimodal import MultimodalPipelineConfig as JPipe
from mre_tpu.data.multimodal import MultimodalStore as JStore
from mre_tpu.train.fusion import FusionConfig as JFusionConfig
from mre_tpu.train.fusion import FusionTrainer as JFusion
from mre_tpu.zsl.module import ZSLConfig as JZSLConfig
from mre_tpu.zsl.module import ZSLModule as JZSL
from mre_tpu_torch.core import config as tconfig
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.interop import load_flax
from mre_tpu_torch.models.transformer import Attention
from mre_tpu_torch.ops import attention as port_attention
from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer
from mre_tpu_torch.zsl.module import ZSLConfig, ZSLModule

TOL = dict(rtol=1e-4, atol=1e-4)
# M3AE-huge's head width (80) and MLP ratio, narrowed in heads and depth
HUGE = dict(emb_dim=160, dec_emb_dim=64, depth=2, dec_depth=1, num_heads=2,
            dec_num_heads=2, mlp_ratio=4)
PIPE = dict(image_size=16, vocab_size=100, tokenizer_max_length=6,
            unpaired_tokenizer_max_length=10)
MODEL = dict(model_type="huge", emb_dim=12, noise_dim=4, patch_size=8)
ZSL = dict(emb_dim=12, noise_dim=4, test_sample=5, max_neighbor=10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def huge_pair(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        for presets in (jconfig.TRANSFORMER_PRESETS, tconfig.TRANSFORMER_PRESETS):
            mp.setitem(presets, "huge", HUGE)
        path = str(tmp_path_factory.mktemp("zsl_huge"))
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
        yield jf, jz, tf, tz


@pytest.fixture(scope="module")
def huge_round(huge_pair):
    """Both rounds; the port's attention calls' head widths recorded."""
    jf, jz, tf, tz = huge_pair
    head_dims = []
    plain = port_attention.attention_reference

    def recording(q, k, v, padding_mask, scale):
        head_dims.append(q.shape[-1])
        return plain(q, k, v, padding_mask, scale)

    j_ent = np.asarray(jf.generate_ent_embeddings(batch_size=16))
    j_rel = np.asarray(jf.generate_rel_embeddings(batch_size=4))
    jz.update_embed(j_ent, j_rel)
    j_res = jz.evaluate(jf, mode="test", verbose=False, query_chunk=8,
                        eval_path="rel_shared", return_ranks=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "attention_reference", recording)
        t_ent = tf.generate_ent_embeddings(batch_size=16).numpy()
        t_rel = tf.generate_rel_embeddings(batch_size=4).numpy()
        tz.update_embed(t_ent, t_rel)
        t_res = tz.evaluate(tf, mode="test", verbose=False, query_chunk=8,
                            eval_path="rel_shared", return_ranks=True)
    return dict(j_ent=j_ent, j_rel=j_rel, j_res=j_res, t_ent=t_ent, t_rel=t_rel,
                t_res=t_res, head_dims=head_dims)


def test_huge_encoder_has_heads_of_80(huge_pair):
    _, _, tf, _ = huge_pair
    layers = [m for m in tf.model.modules() if isinstance(m, Attention)]
    widths = {m.dim // m.num_heads for m in layers}
    assert 80 in widths and widths <= {80, 32}   # encoder 80, the decoder's 64 / 2


def test_huge_round_runs_attention_at_head_dim_80(huge_round):
    """The serving round runs the encoder alone: every attention call is
    one of 80-wide heads (the kernel's hd-80 instantiation on the card),
    depth per entity batch, relation batch and unseen relation."""
    dims = huge_round["head_dims"]
    assert dims and set(dims) == {80}
    assert len(dims) == HUGE["depth"] * (3 + 2 + 2)   # 40 / 16, 8 / 4, 2 unseen


def test_huge_embeddings_match(huge_round):
    r = huge_round
    assert r["t_ent"].shape == r["j_ent"].shape and r["t_rel"].shape == r["j_rel"].shape
    np.testing.assert_allclose(r["t_ent"], r["j_ent"], **TOL)
    np.testing.assert_allclose(r["t_rel"], r["j_rel"], **TOL)


def test_huge_rel_shared_ranks_equal(huge_pair, huge_round):
    _, jz, _, tz = huge_pair
    a, b = huge_round["j_res"], huge_round["t_res"]
    np.testing.assert_allclose(tz.symbol_table.numpy(), np.asarray(jz.symbol_table), **TOL)
    assert b["n"] == a["n"] > 0
    np.testing.assert_array_equal(b["ranks"], a["ranks"])
    for m in ("hits10", "hits5", "hits1", "mrr"):
        assert b[m] == a[m], m

