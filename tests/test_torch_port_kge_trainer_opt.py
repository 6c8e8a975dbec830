"""Port KGETrainer vs the JAX package's: optimizers, margin_flag, learning,
evaluation and the trainer's entry checks.

TransE steps under every optimizer (SGD, Adagrad with lr_decay, Adam,
Adadelta) and RotatE under Adam with weight decay match JAX's parameters
and losses within 1e-5 on JAX's batches; RotatE's margin and rel_range stay
unchanged. margin_flag is held both ways (the loss of one batch equals
sigmoid_loss of margin − distance with the flag, of the raw distance
without, and equals JAX's). TransE learns the clustered KG of
tests/test_kge_trainer.py, and after JAX-trained parameters are carried
across, the port's filtered metrics equal JAX's.
"""

import os

import jax
import numpy as np
import pytest
import torch

from mre_tpu.data.kg import TripleTable as JTripleTable
from mre_tpu.ops import sampling as jsamp
from mre_tpu.train.kge import KGETrainer as JTrainer
from mre_tpu.train.kge import KGETrainerConfig as JConfig
from mre_tpu.train.kge import make_optimizer as jmake_optimizer
from mre_tpu_torch.core import checkpoint as ckpt
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.ops import losses as tlosses
from mre_tpu_torch.ops.sampling import NegativeBatch
from mre_tpu_torch.train.kge import KGETrainer, KGETrainerConfig, make_optimizer


def close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |d| {err:.3g} > {rel} × {scale:.3g}"


def port_batch(jb) -> NegativeBatch:
    return NegativeBatch(*(torch.tensor(np.asarray(x), dtype=torch.bool if x.dtype == bool
                                        else torch.int64) for x in jb))


def clustered(n_groups=6, group=8, seed=0):
    """tests/test_kge_trainer.py::make_structured_kg: entities of a group are
    linked by relation 0."""
    rng = np.random.default_rng(seed)
    triples = []
    for g in range(n_groups):
        ents = np.arange(g * group, (g + 1) * group)
        for h in ents:
            for t in rng.choice(ents, 3, replace=False):
                if h != t:
                    triples.append([h, 0, t])
    return np.unique(np.asarray(triples, np.int32), axis=0), n_groups * group


@pytest.fixture(scope="module")
def kg_data():
    tri, n_ent = clustered()
    return tri, n_ent


def steps_equal(tri, n_ent, cfg_kw, n_steps=3, weight_decay=0.0):
    jtable, table = JTripleTable.build(tri, n_ent, 1), TripleTable.build(tri, n_ent, 1)
    jt = JTrainer(jtable, JConfig(**cfg_kw))
    tt = KGETrainer(table, KGETrainerConfig(**cfg_kw), device="cpu")
    if weight_decay:
        jt.tx = jmake_optimizer(jt.cfg.opt_method, jt.cfg.alpha, weight_decay=weight_decay)
        jt.opt_state = jt.tx.init(jt.params)
        jt._build_step()
        tt.optimizer = make_optimizer(tt.module.parameters(), tt.cfg.opt_method, tt.cfg.alpha,
                                      weight_decay=weight_decay)
    tt.load_params({k: np.asarray(v) for k, v in jt.params.items()})
    params, opt_state = jt.params, jt.opt_state
    for i, k in enumerate(jax.random.split(jax.random.key(3), n_steps)):
        jb = jsamp.sample_training_batch(k, jt.kg, cfg_kw["batch_size"], cfg_kw["neg_ent"],
                                         cfg_kw.get("bern", True))
        params, opt_state, value = jt._step_with_batch(params, opt_state, jb)
        got = tt.step_with_batch(port_batch(jb))
        np.testing.assert_allclose(float(got), float(value), rtol=1e-5, err_msg=f"step {i}")
    for k, v in params.items():
        close(tt.params[k].detach().numpy(), np.asarray(v), what=k)
    return params, tt


@pytest.mark.parametrize("opt", [dict(opt_method="sgd", alpha=0.5),
                                 dict(opt_method="adagrad", alpha=0.1, lr_decay=0.3),
                                 dict(opt_method="adam", alpha=0.01),
                                 dict(opt_method="adadelta", alpha=1.0)],
                         ids=["sgd", "adagrad_lr_decay", "adam", "adadelta"])
def test_transe_optimizers_equal_jax(kg_data, opt):
    steps_equal(*kg_data, dict(model="transe", dim=8, margin=2.0, batch_size=32, neg_ent=3,
                               **opt))


def test_rotate_weight_decay_keeps_buffers_and_equals_jax(kg_data):
    cfg = dict(model="rotate", dim=8, loss="sigmoid", adv_temperature=2.0, batch_size=32,
               neg_ent=3, opt_method="adam", alpha=0.01, bern=False,
               init_kwargs=dict(margin=6.0, epsilon=2.0))
    params, tt = steps_equal(*kg_data, cfg, weight_decay=0.05)
    assert float(tt.params["margin"]) == float(params["margin"]) == 6.0
    assert float(tt.params["rel_range"]) == float(params["rel_range"]) == 1.0
    assert all(p.dim() == 2 for p in tt.module.parameters())       # buffers are not trained


def test_lr_decay_needs_adagrad_and_mesh_is_refused(kg_data):
    tri, n_ent = kg_data
    with pytest.raises(ValueError, match="lr_decay"):
        make_optimizer([torch.zeros(2, requires_grad=True)], "adam", 0.1, lr_decay=0.1)
    # the mesh is ported (tests/test_torch_port_mesh_kge.py); what is not a
    # parallel.mesh.Mesh is refused
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        KGETrainer(TripleTable.build(tri, n_ent, 1), KGETrainerConfig(), mesh=object(),
                   device="cpu")


@pytest.mark.parametrize("margin_flag", [True, False])
def test_margin_flag_both_ways(kg_data, margin_flag):
    """With the flag the distance model trains on margin − distance, without
    it on the raw distance (TransE.py:24-33), as in JAX."""
    tri, n_ent = kg_data
    cfg = dict(model="transe", dim=16, margin=4.0, margin_flag=margin_flag, norm_flag=False,
               loss="sigmoid", adv_temperature=1.0, batch_size=64, neg_ent=4,
               opt_method="adam", alpha=0.01, bern=False)
    jt = JTrainer(JTripleTable.build(tri, n_ent, 1), JConfig(**cfg))
    tt = KGETrainer(TripleTable.build(tri, n_ent, 1), KGETrainerConfig(**cfg), device="cpu")
    tt.load_params({k: np.asarray(v) for k, v in jt.params.items()})
    jb = jsamp.sample_training_batch(jax.random.key(0), jt.kg, 64, 4, False)
    batch = port_batch(jb)
    with torch.no_grad():
        got = float(tt.loss_value(tt.params, batch))
        model = tt.model
        p = model.score(tt.params, batch.h, batch.r, batch.t, norm_flag=False)[:, None]
        n = model.score(tt.params, batch.neg_h, batch.r[:, None].expand_as(batch.neg_h),
                        batch.neg_t, norm_flag=False)
        if margin_flag:
            p, n = 4.0 - p, 4.0 - n
        want = float(tlosses.sigmoid_loss(p, n, adv_temperature=1.0))
    assert abs(got - want) < 1e-5
    np.testing.assert_allclose(got, float(jt._loss_fn(jt.params, jb)), rtol=1e-6)


def test_transe_learns_structure_and_reports_epochs(kg_data, tmp_path):
    tri, n_ent = kg_data
    idx = np.random.default_rng(1).permutation(len(tri))
    train, test = tri[idx[:-20]], tri[idx[-20:]]
    cfg = KGETrainerConfig(model="transe", dim=16, margin=2.0, neg_ent=4, batch_size=64,
                           train_times=60, nbatches=4, opt_method="adam", alpha=0.01,
                           bern=False)
    tt = KGETrainer(TripleTable.build(train, n_ent, 1), cfg, device="cpu")
    first = tt.train_epoch()
    assert first["loss"].dim() == 0 and int(first["overflow_truncated"]) == 0
    tt.cfg.train_times = 59
    last = tt.run(save_steps=59, checkpoint_dir=str(tmp_path))
    assert last < float(first["loss"]), "training loss must decrease"
    saved = ckpt.load_checkpoint(os.path.join(tmp_path, "transe-58.ckpt"),
                                 {k: v.detach() for k, v in tt.params.items()})
    for k, v in tt.params.items():
        np.testing.assert_array_equal(saved[k].numpy(), v.detach().numpy())
    res = tt.link_prediction(test, filter_table=TripleTable.build(tri, n_ent, 1), chunk=8)
    assert res["filter"].hits10 > 0.4, res["filter"]


def test_ranks_equal_jax_after_carrying_trained_params(kg_data):
    """JAX trains; the port ranks with JAX's trained parameters; the raw and
    filtered metrics are JAX's exactly (TransE, the broadcast fallback, and
    TransR, the whole-table projection path)."""
    tri, n_ent = kg_data
    idx = np.random.default_rng(2).permutation(len(tri))
    train, test = tri[idx[:-24]], tri[idx[-24:]]
    for model, kw in (("transe", {}), ("transr", dict(init_kwargs=dict(rand_init=True)))):
        cfg = dict(model=model, dim=12, margin=2.0, neg_ent=4, batch_size=64, train_times=5,
                   nbatches=4, opt_method="adam", alpha=0.01, bern=False, **kw)
        jt = JTrainer(JTripleTable.build(train, n_ent, 1), JConfig(**cfg))
        jt.run()
        jres = jt.link_prediction(test, filter_table=JTripleTable.build(tri, n_ent, 1), chunk=8)
        tt = KGETrainer(TripleTable.build(train, n_ent, 1), KGETrainerConfig(**cfg), device="cpu")
        tt.load_params({k: np.asarray(v) for k, v in jt.params.items()})
        tres = tt.link_prediction(test, filter_table=TripleTable.build(tri, n_ent, 1), chunk=8)
        for k in ("raw", "filter"):
            assert tres[k].as_dict() == jres[k].as_dict(), (model, k)


def test_entry_points_raise_without_a_card(kg_data, tmp_path):
    """A KGE entry point given no device runs on cuda, and raises when there
    is no card (it never drops to the CPU on its own)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from mre_tpu_torch.data.fixtures import write_openke_benchmark
    from mre_tpu_torch.openke import Tester, Trainer, TrainDataLoader, TestDataLoader, TransE

    tri, n_ent = kg_data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KGETrainer(TripleTable.build(tri, n_ent, 1), KGETrainerConfig(model="transe"))
    path = str(tmp_path) + "/"
    write_openke_benchmark(path, n_ent=30, n_rel=3, n_train=100, n_valid=10, n_test=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainDataLoader(in_path=path, nbatches=2, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model=None, data_loader=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tester(model=TransE(30, 3, dim=4), data_loader=TestDataLoader(in_path=path))
