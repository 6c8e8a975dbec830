"""The port's KGE trainer and filtered link prediction under a process mesh
(``train/kge.py``, ``ops/ranking.py``, ``parallel/mesh.py``) on spawned
gloo worlds on the CPU, against the port's 1-rank run and the JAX
package's ``KGETrainer(mesh=)`` on the 8 virtual CPU devices.

One world of 4 ranks and one of 1 run the same cases (one spawn each):
* distmult, data parallel (4 × 1), on JAX's sampled batch with JAX's
  initial parameters: ``tests/test_sharding.py::test_kge_step_sharded_batch``
  (JAX's loss on an 8-way mesh and on one device; rtol 2e-5);
* transe on 2 × 2 (entity rows over ``model``): ``_dryrun_impl``'s dp×mp
  step (loss rtol 2e-4 of JAX's sharded and 1-device steps) and its sharded
  filtered link prediction on the initial table (metrics equal to JAX's,
  rtol 1e-6, and to the 1-rank run's);
* rotate (the structured scorer, float64 ranking), distmult with the L2 and
  L3 regularisers (the matrix-product ranking path) and transr (a squared
  regulariser, the whole-table projection) on 2 × 2, two steps each:
  losses rtol 2e-5 and parameters within 1e-5 of each table's largest
  magnitude (summation order only), ranks equal to the 1-rank run's.

``python -m mre_tpu_torch.tools.dryrun_multichip --world 4 --device cpu``
runs as a subprocess and prints the seven equalities of ``_dryrun_impl``.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mre_tpu.data.kg import TripleTable as JTable
from mre_tpu.ops import sampling as jsamp
from mre_tpu.parallel import mesh as jmesh
from mre_tpu.train.kge import KGETrainer as JTrainer
from mre_tpu.train.kge import KGETrainerConfig as JConfig
from mre_tpu_torch.ops.sampling import NegativeBatch
from mre_tpu_torch.tools import dryrun_multichip as dry

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_RTOL = 2e-5


def _table(n_ent, n_rel, n, seed):
    rng = np.random.default_rng(seed)
    tri = np.stack([rng.integers(0, n_ent, n), rng.integers(0, n_rel, n),
                    rng.integers(0, n_ent, n)], 1).astype(np.int32)
    return JTable.build(tri, n_ent, n_rel)


def _port_batch(jb) -> NegativeBatch:
    return NegativeBatch(*(torch.tensor(np.asarray(x), dtype=torch.bool if x.dtype == bool
                                        else torch.int64) for x in jb))


def _jax_step(table, cfg, mesh):
    """(initial params, the step's sampled batch, loss on ``mesh``, loss
    on one device): the trainers of test_kge_step_sharded_batch."""
    jt = JTrainer(table, JConfig(**cfg), mesh=mesh)
    init = {k: np.asarray(v) for k, v in jt.params.items()}
    batch = jsamp.sample_training_batch(jax.random.split(jt._rng)[1], jt.kg,
                                        cfg["batch_size"], cfg["neg_ent"], cfg.get("bern", True))
    repl = NamedSharding(mesh, P())
    out = jt._step(jax.device_put(jt.params, repl), jax.device_put(jt.opt_state, repl), jt._rng)
    ref = JTrainer(table, JConfig(**cfg))
    ref_out = ref._step(ref.params, ref.opt_state, ref._rng)
    return init, batch, float(out[-1]["loss"]), float(ref_out[-1]["loss"])


def _jax_dpmp():
    """_dryrun_impl's dp×mp KGE step (2 × 2, entity rows over ``model``)
    and its sharded link prediction on the initial parameters."""
    table = _table(32, 4, 200, 0)
    spec = dry.dryrun_config(WORLD)["kge"]
    mesh2 = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    kge = JTrainer(table, JConfig(**spec["cfg"]), mesh=mesh2)
    host = {k: np.asarray(v) for k, v in kge.params.items()}
    batch = jsamp.sample_training_batch(jax.random.split(kge._rng)[1], kge.kg,
                                        spec["cfg"]["batch_size"], spec["cfg"]["neg_ent"], True)
    ent_sh = NamedSharding(mesh2, P(jmesh.MODEL_AXIS, None))
    repl = NamedSharding(mesh2, P())
    params = {"ent": jax.device_put(host["ent"], ent_sh),
              "rel": jax.device_put(host["rel"], repl)}
    out = kge._step(params, kge.tx.init(params), jax.random.wrap_key_data(
        jax.device_put(np.asarray(jax.random.key_data(kge._rng)), repl)))
    rng = np.random.default_rng(spec["test_seed"])
    test = np.stack([rng.integers(0, 32, spec["n_test"]), rng.integers(0, 4, spec["n_test"]),
                     rng.integers(0, 32, spec["n_test"])], 1).astype(np.int32)
    kge.params = {"ent": jax.device_put(host["ent"], ent_sh),
                  "rel": jax.device_put(host["rel"], repl)}
    res = kge.link_prediction(test, filter_table=table, chunk=spec["chunk"])
    return dict(spec=spec, init=host, batch=batch, loss=float(out[-1]["loss"]),
                metrics={s: (float(res[s].mr), float(res[s].mrr), float(res[s].hits10))
                         for s in ("raw", "filter")})


TWO_STEP = {
    "rotate": dict(model="rotate", dim=8, loss="sigmoid", adv_temperature=2.0, neg_ent=3,
                   batch_size=24, bern=False, opt_method="adam", alpha=0.01,
                   init_kwargs=dict(margin=6.0, epsilon=2.0)),
    "distmult": dict(model="distmult", dim=8, loss="softplus", regul_rate=1.0,
                     l3_regul_rate=0.01, neg_ent=3, batch_size=24, opt_method="adagrad",
                     alpha=0.5),
    "transr": dict(model="transr", dim=8, loss="margin", margin=4.0, regul_rate=0.5,
                   neg_ent=3, batch_size=24, opt_method="sgd", alpha=0.5),
}


@pytest.fixture(scope="module")
def runs():
    dm_cfg = dict(model="distmult", dim=16, batch_size=64, neg_ent=4, train_times=1,
                  nbatches=2, loss="sigmoid", opt_method="adam", alpha=1e-3)
    dm_init, dm_batch, dm_mesh, dm_single = _jax_step(_table(64, 6, 600, 0), dm_cfg,
                                                      jmesh.make_mesh(n_data=8))
    dpmp = _jax_dpmp()
    cases = [
        dict(n_ent=64, n_rel=6, n_train=600, seed=0, n_model=1, cfg=dm_cfg, init=dm_init,
             batch=_port_batch(dm_batch)),
        dict(dpmp["spec"], init=dpmp["init"], batch=_port_batch(dpmp["batch"]),
             lp_init=dpmp["init"]),
    ] + [dict(n_ent=40, n_rel=5, n_train=300, seed=2, n_test=20, test_seed=3, chunk=8,
              n_model=2, steps=2, cfg=cfg) for cfg in TWO_STEP.values()]
    cfg = {"kge_cases": cases}
    sharded = dry.spawn(dry.run_checks, WORLD, cfg, device="cpu")
    single = dry.spawn(dry.run_checks, 1, cfg, device="cpu")
    return dict(sharded=sharded, single=single, dm=(dm_mesh, dm_single), dpmp=dpmp)


def _case(runs, i):
    return runs["sharded"][0]["kge_cases"][i], runs["single"][0]["kge_cases"][i]


def test_dp_step_loss_matches_jax_sharded_batch(runs):
    got, one = _case(runs, 0)
    j_mesh, j_single = runs["dm"]
    assert got["mesh"] == (4, 1) and one["mesh"] == (1, 1)
    for loss in (got["losses"][0], one["losses"][0]):
        np.testing.assert_allclose(loss, j_mesh, rtol=STEP_RTOL, atol=1e-6)
        np.testing.assert_allclose(loss, j_single, rtol=STEP_RTOL, atol=1e-6)


def test_dpmp_step_loss_matches_jax_and_one_rank(runs):
    got, one = _case(runs, 1)
    assert got["mesh"] == (2, 2)
    np.testing.assert_allclose(got["losses"][0], runs["dpmp"]["loss"], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got["losses"][0], one["losses"][0], rtol=2e-4, atol=1e-5)


def test_sharded_link_prediction_equals_jax_and_replicated(runs):
    got, one = _case(runs, 1)
    for split in ("raw", "filter"):
        np.testing.assert_allclose(got["metrics"][split], runs["dpmp"]["metrics"][split],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["metrics"][split], one["metrics"][split], rtol=1e-6)


@pytest.mark.parametrize("i,name", list(enumerate(TWO_STEP, start=2)))
def test_two_dpmp_steps_and_ranks_equal_one_rank(runs, i, name):
    got, one = _case(runs, i)
    assert got["mesh"] == (2, 2)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=STEP_RTOL, atol=1e-6)
    assert set(got["params"]) == set(one["params"])
    for k, ref in one["params"].items():
        assert got["params"][k].shape == ref.shape, k
        np.testing.assert_allclose(got["params"][k], ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()) + 1e-12, err_msg=k)
    for split in ("raw", "filter"):
        np.testing.assert_allclose(got["metrics"][split], one["metrics"][split], rtol=1e-6)


def test_every_rank_reports_the_same_losses_and_metrics(runs):
    first = runs["sharded"][0]["kge_cases"]
    for res in runs["sharded"][1:]:
        for a, b in zip(res["kge_cases"], first):
            assert a["losses"] == b["losses"]
            assert a.get("metrics") == b.get("metrics")


def test_dryrun_cli_prints_the_seven_equalities():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "mre_tpu_torch.tools.dryrun_multichip", "--world", "4",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for head in ("fusion dp 3-step scan: 4-way final params == 1-device",
                 "mesh checkpoint resume: save/restore + 2 steps bitwise == live continuation",
                 "kge dp×mp step: sharded loss", "fusion TP entity sweep: dp×mp == replicated",
                 "sharded filtered link-prediction == replicated",
                 "zsl 3-step GAN loop under mesh", "rel_shared eval under mesh",
                 "dryrun_multichip ok on 4 ranks (gloo, cpu)"):
        assert head in proc.stdout, proc.stdout
    assert "FAILED" not in proc.stdout
