"""The first fusion step of the learnability configuration, port vs JAX, on
the CPU.

The learnable fixture at the experiment's arguments (120 entities, 14
relations) and experiments/zsl_learnability.py's configuration: ``tiny4``
(M3AE-small's widths, encoder and decoder depth 4), image 32 / patch 8,
16 text and 16 description tokens, vocab 512, FusionConfig emb 32, noise 8,
8 seeds × 4 edges, 8 negatives, lr 3e-4. The harness is
tests/test_torch_port_train_step.py's ``first_step_pair``: the port takes
the JAX trainer's initial parameters and spectral vectors
(``interop.load_flax``), the same sampled subgraph, and the JAX step's
draws (masking permutations from the masks under ``k_mask``, negatives
from ``corrupt_within_nodes(k_neg)``).
The attention runs at the learnability path's short sequences: 17 tokens
in the masked encoder and the descriptions, 33 in the decoder.

Tolerances (float32 on both sides, summation order only): the device batch
bit for bit; every ``info`` term rtol 1e-4, atol 1e-6 (the train-step
file's bound).
"""

import jax
import numpy as np
import pytest

from mre_tpu.data.fixtures import write_learnable_zsl_dataset
from mre_tpu_torch.ops import attention
from mre_tpu_torch.train.fusion import INFO_KEYS
from test_torch_port_train_step import first_step_pair

# experiments/zsl_learnability.py:52-73
PIPE = dict(image_size=32, vocab_size=512, tokenizer_max_length=16,
            unpaired_tokenizer_max_length=16)
CFG = dict(model_type="tiny4", emb_dim=32, noise_dim=8, patch_size=8,
           image_mask_ratio=0.5, text_mask_ratio=0.5, batch_size=8, sample_size=4,
           neg_ent=8, lr_maximum=3e-4, epochs=4, seed=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def one_step(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("learnable"))
    write_learnable_zsl_dataset(path, n_types=6, ents_per_type=20, n_rel=14, n_unseen=3,
                                triples_per_rel=40, n_candidates=30, seed=0)
    jf, tf, graph_batch, db, draws = first_step_pair(path, PIPE, CFG)
    _, _, _, _, j_info = jf._step_fn(jf.params, jf.spectral, jf.opt_state, jf._rng, db)

    shapes = []
    apply = attention.FusedAttention.apply

    def record(q, k, v, pad, scale):
        shapes.append(tuple(q.shape))
        return apply(q, k, v, pad, scale)

    tb = tf.prepare_device_batch(graph_batch)
    attention.FusedAttention.apply = record
    try:
        t_info = {k: float(v) for k, v in tf.step(tb, draws).items()}
    finally:
        attention.FusedAttention.apply = apply
    return dict(db=_np(db), tb={k: v.numpy() for k, v in tb.items()}, shapes=shapes,
                j_info={k: float(v) for k, v in j_info.items()}, t_info=t_info)


def test_device_batch_equals_jax(one_step):
    db, tb = one_step["db"], one_step["tb"]
    assert set(tb) == set(db)
    for k in db:
        np.testing.assert_array_equal(tb[k], db[k], err_msg=k)


def test_first_step_losses_match_jax(one_step):
    j, t = one_step["j_info"], one_step["t_info"]
    assert set(t) == set(j) == set(INFO_KEYS)
    for k in INFO_KEYS:
        assert np.isfinite(t[k]), k
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_step_runs_the_attention_at_the_short_sequences(one_step):
    """Per step: depth 4 × (masked encoder N 17, unmasked encoder N 33,
    edge descriptions N 17) at head_dim 64 and depth 4 × the decoder (N 33,
    16 heads of 32) — the shapes the card's kernel is held at."""
    n_nodes, n_edges = one_step["tb"]["n_id"].shape[0], one_step["tb"]["edge_type"].shape[0]
    want = sorted([(n_nodes, 6, 17, 64)] * 4 + [(n_nodes, 6, 33, 64)] * 4
                  + [(n_edges, 6, 17, 64)] * 4 + [(n_nodes, 16, 33, 32)] * 4)
    assert sorted(one_step["shapes"]) == want
