"""The learnability slice of the port on the CPU: its dataset writer, the
ExpModel triple batch and the learnability driver.

* ``write_learnable_zsl_dataset`` writes the JAX package's files byte for
  byte (the pickled images too: the port's PNG encoder writes PIL's bytes),
  at the experiment's arguments and at a small set;
* ``MultimodalStore.triple_batch`` equals JAX's on tests/test_aux.py's
  fixture: evaluation batches exactly, training batches too (both stores
  draw their crops and flips from a generator seeded alike), and a
  text-only store gives no image;
* ``python -m mre_tpu_torch.tools.zsl_learnability --device cpu`` at one
  epoch, two pretraining steps and two GAN epochs writes a certification
  JSON with the keys of the JAX experiment's (experiments/results/
  bf16_cert.json); without ``--device`` and without a card it raises.
"""

import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mre_tpu.data import fixtures as jfix
from mre_tpu.data.loaders import load_zsl_dataset
from mre_tpu.data.multimodal import MultimodalPipelineConfig as JPipe
from mre_tpu.data.multimodal import MultimodalStore as JStore
from mre_tpu_torch.data import fixtures as tfix
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore

REPO = Path(__file__).resolve().parent.parent
EXPERIMENT = dict(n_types=6, ents_per_type=20, n_rel=14, n_unseen=3, triples_per_rel=40,
                  n_candidates=30, seed=0)
SMALL = dict(n_types=3, ents_per_type=5, n_rel=5, n_unseen=1, triples_per_rel=6,
             image_ratio=0.5, n_candidates=8, image_size=8, seed=3)


@pytest.mark.parametrize("kw", [EXPERIMENT, SMALL], ids=["experiment", "small"])
def test_learnable_dataset_files_are_byte_equal(tmp_path, kw):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jmeta = jfix.write_learnable_zsl_dataset(str(jdir), **kw)
    tmeta = tfix.write_learnable_zsl_dataset(str(tdir), **kw)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and "MultiModalInfo_zsl.pkl" in names
    for name in names:
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
    assert tmeta["pairs"] == jmeta["pairs"]
    np.testing.assert_array_equal(tmeta["ent_type"], jmeta["ent_type"])
    for k in ("e2id", "r2id", "train_tasks", "test_tasks"):
        assert tmeta[k] == jmeta[k], k


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """tests/test_aux.py::test_triple_batch's fixture on both sides."""
    path = str(tmp_path_factory.mktemp("zs"))
    jfix.write_zsl_dataset(path, n_ent=20, n_rel=4, n_unseen=1, triples_per_rel=8,
                           image_size=8, seed=2)
    data = load_zsl_dataset(path)
    pipe = dict(image_size=16, vocab_size=64, tokenizer_max_length=6,
                unpaired_tokenizer_max_length=8)

    def pair(**extra):
        return (JStore(data["mm_info"], data["rel_des"], JPipe(**pipe, **extra)),
                MultimodalStore(data["mm_info"], data["rel_des"],
                                MultimodalPipelineConfig(**pipe, **extra)))

    return data, pair


@pytest.mark.parametrize("train", [False, True])
def test_triple_batch_equals_jax(stores, train):
    data, pair = stores
    js, ts = pair()
    h, r, t = data["triples"]
    for sl in (slice(0, 5), slice(3, 17)):
        a = js.triple_batch(h[sl], r[sl], t[sl], train=train)
        b = ts.triple_batch(h[sl], r[sl], t[sl], train=train)
        assert set(b) == set(a)
        for k in a:
            assert b[k].shape == a[k].shape and b[k].dtype == a[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    n = sl.stop - sl.start
    assert b["image_head"].shape == (n, 16, 16, 3)
    assert b["text_tail"].shape == (n, 6)
    assert b["rel_des"].shape == (n, 8)


def test_triple_batch_text_only_has_no_image(stores):
    data, pair = stores
    js, ts = pair(text_only=True)
    h, r, t = data["triples"]
    a, b = js.triple_batch(h[:5], r[:5], t[:5]), ts.triple_batch(h[:5], r[:5], t[:5])
    assert set(b) == set(a) and not any(k.startswith("image") for k in b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    return env


def test_tool_runs_on_the_cpu_and_writes_the_certification(tmp_path):
    cert = tmp_path / "cert.json"
    proc = subprocess.run(
        [sys.executable, "-m", "mre_tpu_torch.tools.zsl_learnability", "--epochs", "1",
         "--pretrain_steps", "2", "--train_times", "2", "--device", "cpu",
         "--out", str(tmp_path / "data"), "--cert_out", str(cert)],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "fusion epoch 0" in proc.stdout and "lift over random Hits@10" in proc.stdout
    got = json.loads(cert.read_text())
    ref = json.loads((REPO / "experiments/results/bf16_cert.json").read_text())
    assert _keys(got) == _keys(ref)
    assert got["n_queries"] == ref["n_queries"] == 59
    assert got["trained"] == {"epochs": 1, "train_times": 2, "pretrain_steps": 2}
    for key, path in got["paths"].items():
        assert path["n"] == 59 and 0.0 < path["mrr"] <= 1.0, key
        assert all(np.isfinite(v) for v in path.values()), key
    assert (tmp_path / "data" / "test_candidates.json").exists()


def test_tool_raises_without_a_card_unless_told():
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "mre_tpu_torch.tools.zsl_learnability"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "dataset at" not in proc.stdout
