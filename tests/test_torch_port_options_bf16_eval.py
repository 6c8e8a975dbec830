"""``ZSLModule.evaluate(compute_dtype="bfloat16")`` in the port vs the JAX
package's, on the CPU.

Fixture as tests/test_torch_port_eval_paths.py::pair, with bfloat16 fusion
trainers on both sides (the generator's text pass runs in their dtype) and
weights carried from JAX. Both sides cast the L/R tables and every
Extractor parameter to bfloat16 and rank in float32.

Tolerance: JAX's own bf16 paths, op by op (``jax.disable_jit``) and
jitted (where XLA may skip a bf16 rounding between fused ops,
``xla_allow_excess_precision``), rank this fixture's near-ties differently:
75-96% of the ranks equal between two of them. So on each path the port
must share at least as many ranks with JAX's, op by op and jitted, as the
least pair of JAX's six rank arrays shares, and move none by more than 2;
on ``head_shared`` it equals JAX's op-by-op ranks.
"""

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
from mre_tpu_torch.zsl.module import EVAL_PATHS, ZSLConfig, ZSLModule

BF16 = "bfloat16"
RANK_MAX_DIFF = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


EVAL_PIPE = dict(image_size=16, vocab_size=100, tokenizer_max_length=6,
                 unpaired_tokenizer_max_length=10)
EVAL_MODEL = dict(model_type="tiny", emb_dim=12, noise_dim=4, patch_size=8,
                  compute_dtype=BF16)
ZSL = dict(emb_dim=12, noise_dim=4, test_sample=5, max_neighbor=10)


@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bf16_eval"))
    write_zsl_dataset(path, n_ent=40, n_rel=8, n_unseen=2, triples_per_rel=25,
                      image_size=8, n_candidates=22, seed=9)
    data = load_zsl_dataset(path, mode="train")
    triples = np.asarray(data["triples"]).T
    n_ent, n_rel = len(data["e2id"]), len(data["r2id"])
    jf = JFusion(JTable.build(triples, n_ent, n_rel),
                 JStore(data["mm_info"], data["rel_des"], JPipe(**EVAL_PIPE)),
                 JFusionConfig(image_mask_ratio=0.5, text_mask_ratio=0.5, batch_size=4,
                               sample_size=2, neg_ent=2, epochs=1, **EVAL_MODEL))
    jz = JZSL(path, data["r2id"], data["e2id"], JZSLConfig(**ZSL), jf)
    tf = FusionTrainer(TripleTable.build(triples, n_ent, n_rel),
                       MultimodalStore(data["mm_info"], data["rel_des"],
                                       MultimodalPipelineConfig(**EVAL_PIPE)),
                       FusionConfig(**EVAL_MODEL), device="cpu")
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
def jax_bf16_ranks(eval_pair):
    """JAX's bf16 ranks on the three paths, op by op (``jax.disable_jit``:
    under jit XLA may skip a bf16 rounding between fused ops,
    ``xla_allow_excess_precision``) and jitted, and the lowest share of
    equal ranks between two of these six rank arrays."""
    jf, jz, _, _ = eval_pair
    out = {}
    for mode in ("eager", "jit"):
        with jax.disable_jit(mode == "eager"):
            out[mode] = {p: jz.evaluate(jf, mode="test", verbose=False, query_chunk=8,
                                        eval_path=p, compute_dtype=BF16,
                                        return_ranks=True)["ranks"] for p in EVAL_PATHS}
    ranks = [out[m][p] for m in ("eager", "jit") for p in EVAL_PATHS]
    out["floor"] = min(float(np.mean(a == b)) for a in ranks for b in ranks)
    return out


@pytest.mark.parametrize("eval_path", EVAL_PATHS)
def test_bf16_evaluate_ranks_match_jax(eval_pair, jax_bf16_ranks, eval_path):
    """Against JAX's bf16 ranks, op by op and jitted: at least as many
    ranks equal as JAX's own bf16 paths and modes share with each other (a
    bf16 rounding that a summation order flips moves a near-tie), none
    moved by more than 2; ``head_shared`` equal to JAX's op-by-op ranks."""
    _, _, tf, tz = eval_pair
    b = tz.evaluate(tf, mode="test", verbose=False, query_chunk=8, eval_path=eval_path,
                    compute_dtype=BF16, return_ranks=True)
    for mode in ("eager", "jit"):
        a = jax_bf16_ranks[mode][eval_path]
        assert len(b["ranks"]) == len(a) > 0
        assert float(np.mean(b["ranks"] == a)) >= jax_bf16_ranks["floor"], mode
        assert int(np.abs(b["ranks"] - a).max()) <= RANK_MAX_DIFF, mode
    if eval_path == "head_shared":
        np.testing.assert_array_equal(b["ranks"], jax_bf16_ranks["eager"][eval_path])
    # the Extractor itself stays float32: evaluate casts a copy
    assert all(p.dtype == torch.float32 for p in tz.extractor.parameters())
