"""Port KGETrainer vs the JAX package's: one optimizer step per model.

Each of the eleven models trains under its OpenKE recipe's loss and
optimizer (tools/train_kge.py RECIPES) at a tiny width. JAX's trainer
initializes the parameters and draws the batches; the port's trainer takes
both, and two ``step_with_batch`` calls must give JAX's losses and
parameters within 1e-5 (of the largest magnitude of each table).
"""

import jax
import numpy as np
import pytest
import torch

from mre_tpu.data.kg import TripleTable as JTripleTable
from mre_tpu.ops import sampling as jsamp
from mre_tpu.train.kge import KGETrainer as JTrainer
from mre_tpu.train.kge import KGETrainerConfig as JConfig
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.ops.sampling import NegativeBatch
from mre_tpu_torch.train.kge import KGETrainer, KGETrainerConfig

# model → the loss and optimizer of its recipe (examples/train_kge.py)
RECIPE = {
    "transe": dict(loss="margin", margin=5.0, opt_method="sgd", alpha=1.0),
    "transh": dict(loss="margin", margin=4.0, opt_method="sgd", alpha=0.5),
    "transr": dict(loss="margin", margin=4.0, opt_method="sgd", alpha=1.0),
    "transd": dict(loss="margin", margin=4.0, opt_method="sgd", alpha=1.0),
    "rescal": dict(loss="margin", margin=1.0, opt_method="adagrad", alpha=0.1),
    "distmult": dict(loss="softplus", regul_rate=1.0, opt_method="adagrad", alpha=0.5),
    "complex": dict(loss="softplus", regul_rate=1.0, opt_method="adagrad", alpha=0.5),
    "analogy": dict(loss="softplus", regul_rate=1.0, opt_method="adagrad", alpha=0.5),
    "simple": dict(loss="softplus", regul_rate=1.0, opt_method="adagrad", alpha=0.5),
    "hole": dict(loss="softplus", regul_rate=1.0, opt_method="adagrad", alpha=0.5),
    "rotate": dict(loss="sigmoid", adv_temperature=2.0, opt_method="adam", alpha=2e-5,
                   bern=False, init_kwargs=dict(margin=6.0, epsilon=2.0)),
}


def close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |d| {err:.3g} > {rel} × {scale:.3g}"


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(0)
    tri = np.unique(np.stack([rng.integers(0, 40, 300), rng.integers(0, 5, 300),
                              rng.integers(0, 40, 300)], 1).astype(np.int32), axis=0)
    return JTripleTable.build(tri, 40, 5), TripleTable.build(tri, 40, 5)


def port_batch(jb) -> NegativeBatch:
    return NegativeBatch(*(torch.tensor(np.asarray(x), dtype=torch.bool if x.dtype == bool
                                        else torch.int64) for x in jb))


def step_pair(tables, cfg_kw, steps=2, seed=7):
    """JAX and port trainers on one config; ``steps`` steps on JAX's batches.
    Returns (jax losses, port losses, jax params, port trainer)."""
    jtable, table = tables
    jt = JTrainer(jtable, JConfig(**cfg_kw))
    tt = KGETrainer(table, KGETrainerConfig(**cfg_kw), device="cpu")
    tt.load_params({k: np.asarray(v) for k, v in jt.params.items()})
    params, opt_state = jt.params, jt.opt_state
    jl, tl = [], []
    for k in jax.random.split(jax.random.key(seed), steps):
        jb = jsamp.sample_training_batch(k, jt.kg, cfg_kw["batch_size"], cfg_kw["neg_ent"],
                                         cfg_kw.get("bern", True))
        params, opt_state, value = jt._step_with_batch(params, opt_state, jb)
        jl.append(float(value))
        tl.append(float(tt.step_with_batch(port_batch(jb))))
    return jl, tl, {k: np.asarray(v) for k, v in params.items()}, tt


@pytest.mark.parametrize("name", sorted(RECIPE))
def test_step_with_batch_equals_jax_under_recipe(tables, name):
    cfg = dict(model=name, dim=8, batch_size=24, neg_ent=3, **RECIPE[name])
    jl, tl, jparams, tt = step_pair(tables, cfg)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    got = tt.params
    assert sorted(got) == sorted(jparams)
    for k in jparams:
        close(got[k].detach().numpy(), jparams[k], what=f"{name}.{k}")
