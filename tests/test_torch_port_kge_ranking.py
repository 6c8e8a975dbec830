"""Port link-prediction ranking vs the JAX package's.

On a ``write_openke_benchmark`` fixture, with JAX-initialized parameters
carried into the port, the raw, filtered and type-constrained ranks of
every test triple (head and tail side) EQUAL JAX's, through the broadcast
fallback (TransE) and the matrix-product fast path (DistMult). The ranks
do not change with the entity chunk of the fallback, the compact filter
index equals the dense one, and ``triple_classification_threshold``
equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mre_tpu.data import fixtures as jfix
from mre_tpu.data.kg import DeviceKG as JDeviceKG
from mre_tpu.data.kg import TripleTable as JTripleTable
from mre_tpu.models import kge as jkge
from mre_tpu.ops import ranking as jrank
from mre_tpu_torch import interop
from mre_tpu_torch.data.kg import DeviceKG, TripleTable
from mre_tpu_torch.models import kge as tkge
from mre_tpu_torch.ops import ranking as trank
from mre_tpu_torch.openke.data import read_benchmark, read_type_constraints


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench")) + "/"
    jfix.write_openke_benchmark(path, n_ent=60, n_rel=6, n_train=400, n_valid=40,
                                n_test=48, seed=2)
    b = read_benchmark(path)
    union = np.concatenate([b["train"], b["valid"], b["test"]])
    jtable = JTripleTable.build(union, b["n_entities"], b["n_relations"])
    table = TripleTable.build(union, b["n_entities"], b["n_relations"])
    tc = read_type_constraints(path, b["n_relations"], b["n_entities"])
    return dict(b, path=path, jkg=JDeviceKG.from_table(jtable), table=table,
                kg=DeviceKG.from_table(table), tc=tc)


def carried(name, bench):
    jp = jkge.get(name).init(jax.random.key(1), bench["n_entities"], bench["n_relations"],
                             dim=16)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    return {k: jnp.asarray(v) for k, v in jp.items()}, interop.kge_from_jax(jp)


def jax_ranks(name, jp, bench, tc):
    """JAX's per-triple ranks: its _rank_chunk over the whole test split."""
    model = jkge.get(name)
    tails, heads = jrank.make_predict_all(model, bench["jkg"], ent_chunk=16)
    test = bench["test"]
    h, r, t = (jnp.asarray(test[:, i]) for i in range(3))
    pad = bench["jkg"].max_row_len()
    out = {}
    for side, fn, masks in (("tail", tails, tc[1] if tc else None),
                            ("head", heads, tc[0] if tc else None)):
        tm = jnp.asarray(masks)[r] if masks is not None else None
        res = jrank._rank_chunk(fn, jp, bench["jkg"], h, r, t, side, pad, tm)
        for key, arr in zip(("raw", "filter", "raw_tc", "filter_tc"), res):
            out[f"{side}_{key}"] = np.asarray(arr)
    return out


@pytest.mark.parametrize("name", ["transe", "distmult"])
@pytest.mark.parametrize("with_tc", [False, True])
def test_ranks_equal_jax(bench, name, with_tc):
    jp, tp = carried(name, bench)
    tc = bench["tc"] if with_tc else None
    want = jax_ranks(name, jp, bench, tc)
    tails, heads = trank.make_predict_all(tkge.get(name), bench["kg"])
    got = trank.rank_arrays(tails, heads, tp, bench["kg"], bench["test"], chunk=16,
                            type_constraints=tc)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    # and the metrics JAX's link_prediction reports
    jt, jh = jrank.make_predict_all(jkge.get(name), bench["jkg"])
    jres = jrank.link_prediction(jt, jh, jp, bench["jkg"], bench["test"], chunk=16,
                                 type_constraints=tc)
    tres = trank.link_prediction(tails, heads, tp, bench["kg"], bench["test"], chunk=16,
                                 type_constraints=tc)
    assert sorted(tres) == sorted(jres)
    for k in jres:
        assert tres[k].as_dict() == jres[k].as_dict(), k


@pytest.mark.parametrize("name", ["transe", "rotate", "transh"])
def test_ranks_do_not_change_with_ent_chunk(bench, name):
    _, tp = carried(name, bench)
    model = tkge.get(name)
    ranks = []
    for ent_chunk in (None, 7, 16, 1000):
        tails, heads = trank.make_predict_all(model, bench["kg"], ent_chunk=ent_chunk)
        ranks.append(trank.rank_arrays(tails, heads, tp, bench["kg"], bench["test"], chunk=10))
    for other in ranks[1:]:
        for k in ranks[0]:
            np.testing.assert_array_equal(other[k], ranks[0][k], k)


def test_memory_budget_sets_ent_chunk(bench, monkeypatch):
    """The fallback's chunk comes from ENT_CHUNK_BYTES: one [B, chunk, width]
    float32 intermediate at most."""
    _, tp = carried("rotate", bench)
    seen = []
    model = tkge.get("rotate")
    spy = dict(predict=lambda p, h, r, t: seen.append(t.shape[-1]) or model.predict(p, h, r, t))
    import dataclasses
    spied = dataclasses.replace(model, **spy)
    monkeypatch.setattr(trank, "ENT_CHUNK_BYTES", 4 * 8 * 32 * 5)   # 5 entities per chunk
    tails, _ = trank.make_predict_all(spied, bench["kg"])
    h = torch.zeros(8, dtype=torch.int64)
    out = tails(tp, h, h)
    assert out.shape == (8, bench["n_entities"])
    assert max(seen) == 5 and sum(seen) == bench["n_entities"]


def test_filter_mask_equals_jax_and_compact(bench):
    test = bench["test"]
    pad = bench["kg"].max_row_len()
    ckg = DeviceKG.from_table(bench["table"], compact=True)
    for side, anchor in (("tail", 0), ("head", 2)):
        want = np.asarray(jrank._filter_mask(bench["jkg"], jnp.asarray(test[:, anchor]),
                                             jnp.asarray(test[:, 1]), side,
                                             bench["n_entities"], pad))
        for kg in (bench["kg"], ckg):
            got = trank._filter_mask(kg, torch.from_numpy(test[:, anchor].astype(np.int64)),
                                     torch.from_numpy(test[:, 1].astype(np.int64)), side,
                                     bench["n_entities"], pad)
            np.testing.assert_array_equal(got.numpy(), want)


def test_link_prediction_rejects_empty(bench):
    tails, heads = trank.make_predict_all(tkge.get("transe"), bench["kg"])
    with pytest.raises(ValueError):
        trank.link_prediction(tails, heads, {}, bench["kg"], np.zeros((0, 3)))


def test_triple_classification_threshold_equals_jax():
    rng = np.random.default_rng(0)
    pos = rng.normal(0.0, 1.0, 200).astype(np.float32)
    neg = rng.normal(1.5, 1.0, 300).astype(np.float32)
    neg[:20] = pos[:20]                     # ties across the classes
    assert trank.triple_classification_threshold(pos, neg) == \
        jrank.triple_classification_threshold(pos, neg)
    thr, acc = trank.triple_classification_threshold(np.asarray([0.1, 0.2, 0.3]),
                                                     np.asarray([0.5, 0.6, 0.7]))
    assert acc == 1.0 and 0.3 <= thr < 0.5
