"""Port OpenKE façade and native sampler vs the JAX package's.

The contract of every test in tests/test_openke.py, held on
``mre_tpu_torch.openke``; then the equalities: the port's ``sampler.cpp``
is byte-equal to the JAX package's, its batches are bit-equal to those of
the JAX package's own build of its sampler (JAX's ``native.build`` and
``load``, writing the library to a private path) for one seed at 1 and 2
threads, native and device Tester metrics agree, ``save_parameters`` JSON
and ``write_openke_benchmark`` files are byte-equal to JAX's, and the runner
``python -m mre_tpu_torch.tools.train_kge`` runs to its metrics on the CPU.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from mre_tpu.data import fixtures as jfix
from mre_tpu.openke import data as jdata
from mre_tpu.openke import module as jmodule
from mre_tpu.openke import native as jnative
from mre_tpu_torch import openke as ok
from mre_tpu_torch.data import fixtures as tfix
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.openke import native
from mre_tpu_torch.openke.data import read_benchmark, read_type_constraints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench")) + "/"
    tfix.write_openke_benchmark(path, n_ent=40, n_rel=5, n_train=250, n_valid=25,
                                n_test=25, seed=3)
    return path


@pytest.fixture(scope="module")
def jax_lib_path(tmp_path_factory):
    """The JAX package's sampler, built by its own ``native.build`` into a
    private path (its default path is shared with the JAX tests)."""
    return str(tmp_path_factory.mktemp("jax_native") / "sampler.so")


def test_sampler_source_is_a_copy():
    assert filecmp.cmp(native.SRC, jnative.SRC, shallow=False)


def test_benchmark_files_byte_equal_jax(tmp_path):
    kw = dict(n_ent=120, n_rel=7, n_train=700, n_valid=60, n_test=60, seed=9)
    jsplits = jfix.write_openke_benchmark(str(tmp_path / "j") + "/", **kw)
    tsplits = tfix.write_openke_benchmark(str(tmp_path / "t") + "/", **kw)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 6
    for name in names:
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name, shallow=False), name
    for k in jsplits:
        np.testing.assert_array_equal(tsplits[k], jsplits[k])


@pytest.mark.parametrize("threads", [1, 2])
def test_native_batches_bit_equal_jax(bench_dir, jax_lib_path, monkeypatch, threads):
    monkeypatch.setattr(jnative, "SO", jax_lib_path)
    kw = dict(in_path=bench_dir, nbatches=5, threads=threads, bern_flag=1, filter_flag=1,
              neg_ent=4, neg_rel=1, seed=42)
    jl = jdata.TrainDataLoader(**kw)
    tl = ok.TrainDataLoader(**kw)
    assert jl.lib._name == jax_lib_path and tl.lib._name == native.SO
    assert (tl.get_ent_tot(), tl.get_rel_tot(), tl.get_batch_size()) == \
        (jl.get_ent_tot(), jl.get_rel_tot(), jl.get_batch_size())
    for jb, tb in zip(jl, tl):
        for k in ("batch_h", "batch_t", "batch_r", "batch_y"):
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k], k)


def test_native_sampler_builds_and_filters(bench_dir):
    loader = ok.TrainDataLoader(in_path=bench_dir, nbatches=5, threads=2, bern_flag=1,
                                filter_flag=1, neg_ent=4, seed=42)
    bench = read_benchmark(bench_dir)
    table = TripleTable.build(bench["train"], bench["n_entities"], bench["n_relations"])
    B = loader.batch_size
    for data in loader:
        assert data["batch_h"].shape == (B * 5,)
        assert (data["batch_y"][:B] == 1).all() and (data["batch_y"][B:] == -1).all()
        assert table.contains(data["batch_h"][:B], data["batch_r"][:B], data["batch_t"][:B]).all()
        assert not table.contains(data["batch_h"][B:], data["batch_r"][B:],
                                  data["batch_t"][B:]).any()


def test_torch_backend_same_contract(bench_dir):
    loader = ok.TrainDataLoader(in_path=bench_dir, nbatches=3, neg_ent=2, backend="torch",
                                seed=7, device="cpu")
    data = loader.sample()
    B = loader.batch_size
    assert data["batch_h"].shape == (B * 3,) and data["batch_h"].dtype == np.int64
    assert (data["batch_y"][:B] == 1).all() and (data["batch_y"][B:] == -1).all()
    assert not loader.table.contains(data["batch_h"][B:], data["batch_r"][B:],
                                     data["batch_t"][B:]).any()


def test_openke_pipeline_end_to_end(bench_dir):
    loader = ok.TrainDataLoader(in_path=bench_dir, nbatches=4, threads=2, bern_flag=1,
                                filter_flag=1, neg_ent=4, seed=0)
    model = ok.TransE(loader.get_ent_tot(), loader.get_rel_tot(), dim=16)
    strategy = ok.NegativeSampling(model=model, loss=ok.MarginLoss(margin=3.0),
                                   batch_size=loader.get_batch_size())
    trainer = ok.Trainer(model=strategy, data_loader=loader, train_times=30, alpha=0.05,
                         opt_method="adam", log_every=1000, device="cpu")
    final = trainer.run()
    losses = [e["loss"] for e in trainer.epochs]
    assert np.isfinite(final) and len(losses) == 30 and losses[-1] == final
    assert all(e["steps"] == 4 and 0 < e["sample_s"] + e["step_s"] <= e["seconds"] * 1.01
               for e in trainer.epochs)
    assert losses[-1] < losses[0]

    dev = ok.Tester(model=model, data_loader=ok.TestDataLoader(in_path=bench_dir), device="cpu")
    mrr, mr, h10, h3, h1 = dev.run_link_prediction()
    assert 0 < mrr <= 1 and mr >= 1
    # the native Test.h-style accumulators rank the same: their float32
    # metrics are the device ranker's, rounded to float32
    nat = ok.Tester(model=model, data_loader=ok.TestDataLoader(in_path=bench_dir),
                    use_native_test=True, device="cpu").run_link_prediction()
    np.testing.assert_array_equal(np.float32([mrr, mr, h10, h3, h1]), np.float32(nat))


def test_type_constrained_eval(bench_dir):
    tester = ok.Tester(model=ok.TransE(40, 5, dim=8),
                       data_loader=ok.TestDataLoader(in_path=bench_dir), device="cpu")
    out = tester.run_link_prediction(type_constrain=True)
    assert all(np.isfinite(v) for v in out)
    nat = ok.Tester(model=tester.model, data_loader=ok.TestDataLoader(in_path=bench_dir),
                    use_native_test=True, device="cpu").run_link_prediction(type_constrain=True)
    np.testing.assert_array_equal(np.float32(out), np.float32(nat))


def test_triple_classification(bench_dir):
    tester = ok.Tester(model=ok.TransE(40, 5, dim=8),
                       data_loader=ok.TestDataLoader(in_path=bench_dir), device="cpu")
    acc, thr = tester.run_triple_classification()
    assert 0.0 <= acc <= 1.0 and np.isfinite(thr)


def test_parameter_transfer_transe_to_transr():
    te = ok.TransE(20, 4, dim=8, seed=0)
    tr = ok.TransR(20, 4, dim_e=8, dim_r=8, seed=1)
    tr.set_parameters(te.get_parameters())
    np.testing.assert_array_equal(tr.params["ent"].detach().numpy(),
                                  te.params["ent"].detach().numpy())
    np.testing.assert_array_equal(tr.params["rel"].detach().numpy(),
                                  te.params["rel"].detach().numpy())
    assert "mat" in tr.params


@pytest.mark.parametrize("cls", ["TransE", "RotatE", "DistMult"])
def test_save_parameters_byte_equal_jax_and_roundtrips(tmp_path, cls):
    jm = getattr(jmodule, cls)(30, 4, dim=6, seed=2)
    tm = getattr(ok, cls)(30, 4, dim=6)
    tm.set_parameters(jm.get_parameters())
    jm.save_parameters(str(tmp_path / "j.json"))
    tm.save_parameters(str(tmp_path / "t.json"))
    assert filecmp.cmp(tmp_path / "j.json", tmp_path / "t.json", shallow=False)
    again = getattr(ok, cls)(30, 4, dim=6, seed=5)
    again.load_parameters(str(tmp_path / "t.json"))
    tm.save_checkpoint(str(tmp_path / "t.ckpt"))
    third = getattr(ok, cls)(30, 4, dim=6, seed=6)
    third.load_checkpoint(str(tmp_path / "t.ckpt"))
    for k, v in jm.get_parameters().items():
        np.testing.assert_array_equal(again.get_parameters()[k], v)
        np.testing.assert_array_equal(third.get_parameters()[k], v)
    if cls == "RotatE":
        assert sorted(n for n, _ in tm.named_buffers()) == ["margin", "rel_range"]


def test_strategy_loss_equals_jax(bench_dir):
    """One flat batch through NegativeSampling (margin_flag on, regulariser)
    gives JAX's loss with carried parameters."""
    loader = ok.TrainDataLoader(in_path=bench_dir, nbatches=5, threads=1, neg_ent=3, seed=1)
    data = loader.sample()
    B = loader.get_batch_size()
    jm = jmodule.TransE(40, 5, dim=8, margin=4.0, seed=0)
    tm = ok.TransE(40, 5, dim=8, margin=4.0)
    tm.set_parameters(jm.get_parameters())
    kw = dict(batch_size=B, regul_rate=0.5)
    want = jmodule.NegativeSampling(model=jm, loss=jmodule.SigmoidLoss(1.0), **kw)(data)
    got = ok.NegativeSampling(model=tm, loss=ok.SigmoidLoss(1.0), **kw)(data)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tm.predict(data), np.asarray(jm.predict(data)), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def native_lib(bench_dir):
    lib = native.load()
    lib.setInPath(bench_dir.encode())
    lib.setWorkThreads(2)
    lib.importTrainFiles()
    lib.importTestFiles()
    lib.setSeed(11)
    return lib


def test_native_corrupt_rel_filtered(bench_dir, native_lib):
    bench = read_benchmark(bench_dir)
    train = {tuple(x) for x in bench["train"].tolist()}
    pairs_rels = {}
    for h, r, t in bench["train"].tolist():
        pairs_rels.setdefault((h, t), set()).add(r)
    (h, t), true_rels = max(pairs_rels.items(), key=lambda kv: len(kv[1]))
    r = next(iter(true_rels))
    seen = set()
    for _ in range(300):
        rr = native_lib.corruptRel(h, t, r, False, True)
        assert (h, rr, t) not in train
        seen.add(int(rr))
    assert seen == set(range(bench["n_relations"])) - true_rels
    seen_u = {int(native_lib.corruptRel(h, t, r, False, False)) for _ in range(300)}
    assert r not in seen_u and seen_u <= set(range(bench["n_relations"]))


def test_native_import_prob_weighted_rel(bench_dir, native_lib):
    bench = read_benchmark(bench_dir)
    R = bench["n_relations"]
    with open(os.path.join(bench_dir, "kl_prob.txt"), "w") as f:
        for _ in range(R):
            f.write(" ".join("0.0" if j == 0 else "50.0" for j in range(R - 1)) + "\n")
    native_lib.importProb(1.0)
    assert native_lib.hasProb() == 1
    train = {tuple(x) for x in bench["train"].tolist()}
    h, r, t = bench["train"][0].tolist()
    draws = [int(native_lib.corruptRel(h, t, r, True, True)) for _ in range(200)]
    assert all((h, rr, t) not in train for rr in draws)
    fav = 0 if r != 0 else 1
    if (h, fav, t) not in train:
        assert draws.count(fav) >= 190


def test_native_corrupt_type_tail(bench_dir, native_lib):
    native_lib.importTypeFiles()
    bench = read_benchmark(bench_dir)
    tc = read_type_constraints(bench_dir, bench["n_relations"], bench["n_entities"])
    train = {tuple(x) for x in bench["train"].tolist()}
    h, r, t = bench["train"][1].tolist()
    tail_ok = set(np.nonzero(tc[1][r])[0].tolist())
    for _ in range(100):
        tt = int(native_lib.corruptTypeTail(h, r))
        assert (h, r, tt) not in train
        assert tt in tail_ok or 0 <= tt < bench["n_entities"]


def test_native_val_loss_batch(bench_dir, native_lib):
    bench = read_benchmark(bench_dir)
    n = len(bench["valid"])
    bh, bt, br = (np.zeros(n, np.int64) for _ in range(3))
    by = np.zeros(n, np.float32)
    native_lib.sampling(bh.ctypes.data, bt.ctypes.data, br.ctypes.data, by.ctypes.data,
                        n, 0, 0, 0, True, False, True)
    assert (by == 1).all()
    got = set(zip(bh.tolist(), br.tolist(), bt.tolist()))
    valid = {tuple(x) for x in bench["valid"].tolist()}
    assert got <= valid and len(got) == len(valid)


def test_native_workthreads_resize_after_seed(bench_dir):
    lib = native.load()
    lib.setInPath(bench_dir.encode())
    lib.setWorkThreads(1)
    lib.importTrainFiles()
    lib.setSeed(3)
    lib.setWorkThreads(8)          # more threads than seeded rngs
    n = 64
    bh, bt, br = (np.zeros(n * 3, np.int64) for _ in range(3))
    by = np.zeros(n * 3, np.float32)
    lib.sampling(bh.ctypes.data, bt.ctypes.data, br.ctypes.data, by.ctypes.data,
                 n, 2, 0, 0, True, False, False)
    assert (by[:n] == 1).all() and (by[n:] == -1).all()


def _write_kl(bench_dir, R):
    with open(os.path.join(bench_dir, "kl_prob.txt"), "w") as f:
        for _ in range(R):
            f.write(" ".join("1.0" for _ in range(R - 1)) + "\n")


def test_train_loader_p_flag_imports_prob(bench_dir):
    R = read_benchmark(bench_dir)["n_relations"]
    _write_kl(bench_dir, R)
    loader = ok.TrainDataLoader(in_path=bench_dir, nbatches=4, neg_rel=1, p=True, seed=3)
    assert loader.lib.hasProb() == 1
    assert next(iter(loader))["batch_r"].shape[0] == loader.batch_size * 3
    dev = ok.TrainDataLoader(in_path=bench_dir, nbatches=4, neg_rel=1, p=True,
                             backend="torch", seed=3, device="cpu")
    assert dev._prob is not None and tuple(dev._prob.shape) == (R, R - 1)
    db = next(iter(dev))
    B = dev.batch_size
    assert db["batch_r"].shape[0] == B * 3
    assert not (db["batch_r"][2 * B:] == db["batch_r"][:B]).any()


def test_torch_backend_p_ignores_filter_flag_like_base_cpp(bench_dir):
    bench = read_benchmark(bench_dir)
    _write_kl(bench_dir, bench["n_relations"])
    dev = ok.TrainDataLoader(in_path=bench_dir, nbatches=4, neg_rel=1, p=True, filter_flag=0,
                             backend="torch", seed=5, device="cpu")
    db = next(iter(dev))
    B = dev.batch_size
    neg_r = db["batch_r"][2 * B:]
    assert not (neg_r == db["batch_r"][:B]).any()
    assert (neg_r >= 0).all() and (neg_r < dev.get_rel_tot()).all()
    table = TripleTable.build(bench["train"], bench["n_entities"], bench["n_relations"])
    assert not table.contains(db["batch_h"][2 * B:], neg_r, db["batch_t"][2 * B:]).any()
    plain = ok.TrainDataLoader(in_path=bench_dir, nbatches=4, neg_rel=1, filter_flag=0,
                               backend="torch", seed=5, device="cpu")
    pb = next(iter(plain))
    assert not table.contains(pb["batch_h"][2 * B:], pb["batch_r"][2 * B:],
                              pb["batch_t"][2 * B:]).any()


def test_native_build_is_atomic_and_raises(tmp_path, monkeypatch):
    """A failed g++ build raises and leaves no library behind."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SO", str(tmp_path / "build" / "sampler.so"))
    with pytest.raises(subprocess.CalledProcessError):
        native.build()
    assert os.listdir(tmp_path / "build") == []


def test_runner_cli_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "mre_tpu_torch.tools.train_kge", "--recipe", "transe_FB15K237",
         "--train_times", "2", "--dim", "16", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MRR:" in proc.stdout and "Hits@10:" in proc.stdout
    assert "Epoch 0 | loss:" in proc.stdout


def test_runner_main_returns_losses_and_model(tmp_path):
    from mre_tpu_torch.tools import train_kge

    path = str(tmp_path) + "/"
    tfix.write_openke_benchmark(path, n_ent=50, n_rel=4, n_train=300, n_valid=20, n_test=20)
    out = train_kge.main(["--recipe", "rotate_WN18RR_adv", "--in_path", path,
                          "--train_times", "2", "--dim", "8", "--device", "cpu"])
    assert len(out["metrics"]) == 5 and all(np.isfinite(out["metrics"]))
    assert len(out["trainer"].epochs) == 2
    assert tuple(out["model"].params["ent"].shape) == (50, 16)
