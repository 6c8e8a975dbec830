"""The port's entry point (``mre_tpu_torch.cli``) and its checkpoints vs the
JAX package's, on the CPU.

Fixture as tests/test_cli.py (30 entities, the tiny preset, emb 12), run
from a temporary working directory with relative paths, as a user runs the
CLI. The JAX ``main`` runs for real but with its compute stubbed out (the
epoch returns the step's ``info`` keys as 0.0, found by ``jax.eval_shape``;
the embeddings are zeros; no GAN, no ranking), so it writes its real file
set, sidecars and JSONL records in seconds; the JAX computations the port
is held to (embeddings, the distill trainer, the ranking) run unstubbed.

Tolerances: the port's and JAX's embeddings through a carried checkpoint,
and the distill parameters after 20 adam steps from JAX's init, within
1e-5 (float32 summation order); ranks and sidecars equal; checkpoint round
trips bitwise.
"""

import json
import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from mre_tpu.cli import args as jargs
from mre_tpu.cli import main as jmain
from mre_tpu.core import checkpoint as jckpt
from mre_tpu.data.fixtures import write_zsl_dataset
from mre_tpu.models.distill import make_distill_trainer as j_make_distill
from mre_tpu.train.fusion import FusionTrainer as JFusion
from mre_tpu.zsl.module import ZSLModule as JZSL
from mre_tpu_torch.cli import main as tmain
from mre_tpu_torch.cli.args import read_options
from mre_tpu_torch.core import checkpoint as ckpt
from mre_tpu_torch.interop import load_flax, module_to_flax
from mre_tpu_torch.train.fusion import INFO_KEYS
from mre_tpu_torch.zsl.module import ZSLModule

DS = "tiny-zs"
TINY = ["--dataset", DS, "--data_root", "data",
        "--model_type", "tiny", "--emb_dim", "12", "--noise_dim", "4",
        "--patch_size", "8", "--image_size", "16",
        "--image_mask_ratio", "0.5", "--text_mask_ratio", "0.5",
        "--batch_size", "4", "--sample_size", "2", "--vocab_size", "100",
        "--test_sample", "4", "--max_neighbor", "8",
        "--pretrain_times", "3", "--pretrain_batch_size", "4",
        "--pretrain_few", "2", "--pretrain_subepoch", "2",
        "--train_times", "2", "--D_batch_size", "8", "--G_batch_size", "8",
        "--loss_every", "1000", "--output_dir", "runs"]
TRAIN = ["--epochs", "2", "--save_epochs", "2"]
CPU = ["--device", "cpu"]
DISTILL_STEPS = 20
TOL = dict(rtol=1e-5, atol=1e-5)
CKPT_FILES = ["epoch2_mre_tpu_small.ckpt", "mre_tpu_small.ckpt"]
EMBED_FILES = ["Discriminator", "Extractor", "Generator"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _chdir:
    def __init__(self, path):
        self.path, self.old = str(path), None

    def __enter__(self):
        self.old = os.getcwd()
        os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.old)


def _dataset(root):
    write_zsl_dataset(str(root / "data" / DS), n_ent=30, n_rel=6, n_unseen=2,
                      triples_per_rel=12, image_size=8, n_candidates=22, seed=3)


def _records(run_dir):
    (name,) = os.listdir(run_dir / "runs")
    assert name.startswith("metrics_") and name.endswith(".jsonl")
    with open(run_dir / "runs" / name) as f:
        return [json.loads(line) for line in f]


def _captured(module, name, store, keep=lambda out: out):
    """Wrap ``module.name`` so that ``keep`` of each call's result is
    appended to ``store`` as the call returns."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        store.append(keep(out))
        return out

    return wrapped


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The CLI's tiny steps are many small ops: beside the other test
    workers, a thread per core each oversubscribes the CPU several times."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLI's train mode with its compute stubbed: its file set and
    records, and its fusion trainer and ZSL module."""
    root = tmp_path_factory.mktemp("jax_cli")
    _dataset(root)
    built, info_keys = [], []

    def epoch(self, prefetch=2):
        if not info_keys:          # the step's info dict, traced once
            batch = self.prepare_device_batch(next(iter(self.sampler)))
            info_keys.extend(jax.eval_shape(self._step_fn, self.params, self.spectral,
                                            self.opt_state, self._rng, batch)[-1])
        return {k: 0.0 for k in info_keys}

    with _chdir(root), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmain, "build_pipeline", _captured(jmain, "build_pipeline", built))
        mp.setattr(JFusion, "train_epoch", epoch)
        mp.setattr(JFusion, "generate_ent_embeddings",
                   lambda self: np.zeros((self.table.n_entities, self.cfg.emb_dim), np.float32))
        mp.setattr(JFusion, "generate_rel_embeddings",
                   lambda self: np.zeros((self.table.n_relations, self.cfg.emb_dim), np.float32))
        mp.setattr(JZSL, "train_gan", lambda self, fusion: None)
        mp.setattr(JZSL, "evaluate", lambda self, fusion, **kw: {})
        jmain.main(jargs.read_options(TINY + TRAIN))
    _, _, _, jf, jz = built[0]
    return dict(root=root, jf=jf, jz=jz)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port CLI's train mode, for real, on the CPU."""
    root = tmp_path_factory.mktemp("port_cli")
    _dataset(root)
    with _chdir(root):
        tmain.main(read_options(TINY + TRAIN + CPU))
    return root


@pytest.fixture(scope="module")
def carried(jax_run, tmp_path_factory):
    """The JAX run's final checkpoint, read by flax and rewritten by the
    port's ``save_checkpoint``, then the port CLI's evaluate mode from it."""
    root = tmp_path_factory.mktemp("carried")
    _dataset(root)
    jf = jax_run["jf"]
    params = jckpt.load_checkpoint(
        str(jax_run["root"] / "saved_models" / DS / "mre_tpu_small.ckpt"), jf.params)
    ckpt.save_checkpoint(str(root / "saved_models" / DS / "carried.ckpt"), _np(params))
    build, built = tmain.build_pipeline, []

    def build_with_jax_spectral(args):
        # the checkpoint holds parameters only; the spectral-norm vectors
        # are each trainer's own random init, so the port trainer takes the
        # JAX trainer's, as the port takes every other JAX draw in tests
        out = build(args)
        fusion = out[3]
        load_flax(fusion.model, fusion.params_tree(), _np(jf.spectral))
        built.append(fusion)
        return out

    with _chdir(root), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmain, "build_pipeline", build_with_jax_spectral)
        result = tmain.evaluate_entry(read_options(
            TINY + CPU + ["--evaluate", "--pretrained_model_name", "carried"]))
    with open(root / "runs" / "temp_ent_embs.pkl", "rb") as f:
        ent = pickle.load(f)
    with open(root / "runs" / "temp_rel_embs.pkl", "rb") as f:
        rel = pickle.load(f)
    jf.params = params
    return dict(root=root, result=result, ent=ent, rel=rel, tf=built[0],
                j_ent=np.asarray(jf.generate_ent_embeddings()),
                j_rel=np.asarray(jf.generate_rel_embeddings()))


# -- flags ---------------------------------------------------------------------


def test_read_options_defaults_equal_jax():
    j, t = vars(jargs.read_options([])), vars(read_options([]))
    assert t.pop("device") == "cuda"
    assert t == j


def test_unported_options_are_refused(tmp_path, monkeypatch):
    """Both options once refused now build a pipeline: ``--compute_dtype
    bfloat16`` reaches the M3AE transformers (parameters float32), and
    ``--pretrained_m3ae`` loads a pickled flax ``TrainState`` over the M3AE
    tree; a compute dtype outside float32 / bfloat16 is refused."""
    _dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    fusion = tmain.build_pipeline(read_options(TINY + CPU + ["--compute_dtype", "bfloat16"]))[3]
    m3ae = fusion.model.M3AEmodel
    assert m3ae.encoder.Block_0.Attention_0.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in fusion.model.parameters())

    params = module_to_flax(m3ae)[0]
    params["cls_token"] = params["cls_token"] + 1.0
    state = train_state.TrainState.create(apply_fn=None, params={"params": params},
                                          tx=optax.adam(1e-3)).replace(tx=None)
    with open("cc12m.pkl", "wb") as f:
        pickle.dump({"state": state, "variant": {}}, f)
    fusion = tmain.build_pipeline(read_options(TINY + CPU + ["--pretrained_m3ae", "cc12m.pkl"]))[3]
    np.testing.assert_array_equal(fusion.model.M3AEmodel.cls_token.detach().numpy(),
                                  params["cls_token"])
    with pytest.raises(ValueError, match="compute_dtype"):
        tmain.build_pipeline(read_options(TINY + CPU + ["--compute_dtype", "float16"]))


def test_cli_needs_a_card_unless_told(tmp_path, monkeypatch):
    """Without --device the CLI runs on cuda: with no card it raises."""
    _dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.build_pipeline(read_options(TINY))


# -- checkpoints ---------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"b": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                  "bias": rng.normal(size=(4,)).astype(np.float32)},
            "a": {"c": {"scale": rng.normal(size=(5,)).astype(np.float32)}},
            "tok": rng.normal(size=(1, 1, 4)).astype(np.float32)}


def test_checkpoint_round_trip_is_bitwise_with_jax_sidecar(tmp_path):
    tree = _tree(0)
    ckpt.save_checkpoint(str(tmp_path / "port" / "t.ckpt"), tree)
    jckpt.save_checkpoint(str(tmp_path / "jax" / "t.ckpt"), tree)
    back = ckpt.load_checkpoint(str(tmp_path / "port" / "t.ckpt"), _tree(1))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(back_flat) == {p for p, _ in flat}
    for path, leaf in flat:
        assert back_flat[path].dtype == torch.float32
        np.testing.assert_array_equal(back_flat[path].numpy(), leaf)
    with open(tmp_path / "port" / "t.ckpt.meta.json") as a, \
            open(tmp_path / "jax" / "t.ckpt.meta.json") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("damage", ["missing", "extra", "shape"])
def test_checkpoint_load_is_strict(tmp_path, damage):
    tree = _tree(0)
    target = _tree(1)
    if damage == "missing":
        del tree["b"]["bias"]
    elif damage == "extra":
        tree["b"]["other"] = np.zeros(2, np.float32)
    else:
        tree["tok"] = np.zeros((1, 2, 4), np.float32)
    ckpt.save_checkpoint(str(tmp_path / "t.ckpt"), tree)
    with pytest.raises(ValueError, match="checkpoint"):
        ckpt.load_checkpoint(str(tmp_path / "t.ckpt"), target)


@pytest.mark.parametrize("names", [
    ["epoch2_m.ckpt", "epoch10_m.ckpt", "epoch9_m.ckpt"],
    ["epoch2_v12.ckpt", "epoch3_v1.ckpt", "epoch3_v1.ckpt.meta.json"],
    ["epoch_m.ckpt", "other5.ckpt"],
    []])
def test_latest_checkpoint_picks_what_jax_picks(tmp_path, names):
    for n in names:
        (tmp_path / n).write_bytes(b"")
    assert ckpt.latest_checkpoint(str(tmp_path), "epoch") == \
        jckpt.latest_checkpoint(str(tmp_path), "epoch")
    assert ckpt.latest_checkpoint(str(tmp_path / "absent"), "epoch") is None


# -- train mode ----------------------------------------------------------------


def _file_set(root):
    out = set()
    for base in (root / "saved_models", root / "data" / DS / "Embed_used"):
        for dirpath, _, files in os.walk(base):
            out |= {os.path.relpath(os.path.join(dirpath, f), root) for f in files}
    return out


def test_train_mode_writes_the_jax_file_set(jax_run, port_run):
    files = _file_set(port_run)
    assert files == _file_set(jax_run["root"])
    assert {os.path.basename(f) for f in files} >= set(CKPT_FILES + EMBED_FILES)


@pytest.mark.parametrize("name", [f"saved_models/{DS}/{f}" for f in CKPT_FILES]
                         + [f"data/{DS}/Embed_used/{f}" for f in EMBED_FILES])
def test_sidecars_equal_jax(jax_run, port_run, name):
    with open(port_run / f"{name}.meta.json") as a, \
            open(jax_run["root"] / f"{name}.meta.json") as b:
        assert a.read() == b.read()


def test_train_mode_metric_names_equal_jax(jax_run, port_run, carried, predictors):
    port, ref = _records(port_run), _records(jax_run["root"])
    epochs = [r for r in port if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [1.0, 2.0]
    ref_epochs = [r for r in ref if "epoch" in r]
    assert [set(r) for r in epochs] == [set(r) for r in ref_epochs]
    assert set(epochs[0]) == {"time", "step", "epoch", *INFO_KEYS}
    (zsl,) = [r for r in port if "zsl_mrr" in r]
    j_res = predictors["j_result"]
    assert set(zsl) == {"time"} | {f"zsl_{k}" for k, v in j_res.items()
                                   if isinstance(v, (int, float))}
    assert all(np.isfinite(r["loss"]) for r in epochs) and np.isfinite(zsl["zsl_mrr"])


def test_resume_reloads_bitwise(port_run):
    """``--resume``: the trainer's parameters right after ``build_pipeline``
    are the latest epoch checkpoint's, bit for bit; then one epoch runs."""
    built = []
    with _chdir(port_run), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmain, "build_pipeline", _captured(
            tmain, "build_pipeline", built, keep=lambda out: out[3].params_tree()))
        tmain.main(read_options(TINY + CPU + ["--resume", "--epochs", "1",
                                              "--start_epoch", "2", "--save_epochs", "2"]))
        saved = torch.load(f"saved_models/{DS}/epoch2_mre_tpu_small.ckpt", weights_only=True)
    (loaded,) = built
    flat = dict(jax.tree_util.tree_leaves_with_path(loaded))
    saved_flat = dict(jax.tree_util.tree_leaves_with_path(saved))
    assert set(flat) == set(saved_flat)
    for path, leaf in saved_flat.items():
        np.testing.assert_array_equal(flat[path], leaf.numpy())


def test_zsl_load_restores_what_train_mode_saved(port_run):
    """``ZSLModule.load``: a fresh module and trainer take the Extractor,
    the Discriminator (with its spectral vectors) and the Generator that
    train mode's ZSL round saved under Embed_used, bit for bit."""
    with _chdir(port_run):
        args = read_options(TINY + CPU)
        _, _, _, fusion, zsl = tmain.build_pipeline(args)
        zsl.load(args.save_path, fusion)
        saved = {name: torch.load(f"{args.save_path}/{name}", weights_only=True)
                 for name in EMBED_FILES}
    d_params, d_spectral = module_to_flax(zsl.discriminator)
    for name, tree in (("Extractor", module_to_flax(zsl.extractor)[0]),
                       ("Discriminator", {"params": d_params, "spectral": d_spectral}),
                       ("Generator", fusion.params_tree())):
        flat = dict(jax.tree_util.tree_leaves_with_path(tree))
        ref = dict(jax.tree_util.tree_leaves_with_path(saved[name]))
        assert set(flat) == set(ref), name
        for path, leaf in ref.items():
            np.testing.assert_array_equal(flat[path], leaf.numpy(), err_msg=name)


# -- evaluate mode from a JAX checkpoint ----------------------------------------


def test_carried_checkpoint_embeddings_match_jax(carried):
    assert carried["ent"].shape == carried["j_ent"].shape
    np.testing.assert_allclose(carried["ent"], carried["j_ent"], **TOL)
    np.testing.assert_allclose(carried["rel"], carried["j_rel"], **TOL)
    assert carried["result"]["n"] > 0 and 0.0 <= carried["result"]["mrr"] <= 1.0


@pytest.fixture(scope="module")
def predictors(jax_run, carried):
    """The distill predictor on both sides (the port's from JAX's init),
    and the rel_shared evaluation through it."""
    jf, jz, tf = jax_run["jf"], jax_run["jz"], carried["tf"]
    teacher = carried["j_rel"]
    _, init, _, _, _ = j_make_distill(emb_dim=jf.cfg.emb_dim,
                                      transformer_emb_dim=tf.model.M3AEmodel.cfg.emb_dim)
    j_pred, j_params = jf.train_distill(teacher, steps=DISTILL_STEPS)
    t_pred, t_model = tf.train_distill(teacher, steps=DISTILL_STEPS, init_params=_np(init))

    data_path = os.path.join(carried["root"], "data", DS)
    tz = ZSLModule(data_path, jz.r2id, jz.e2id, tmain.zsl_config(read_options(TINY + CPU)),
                   device="cpu")
    load_flax(tz.extractor, _np(jz.ex_params))
    jz.update_embed(carried["j_ent"], carried["j_rel"])
    tz.update_embed(carried["j_ent"], carried["j_rel"])
    with _chdir(jax_run["root"]):          # the JAX module's data path is relative
        j_result = jz.evaluate(jf, verbose=False, query_chunk=8, predict_unseen=j_pred,
                               eval_path="rel_shared", return_ranks=True)
    t_result = tz.evaluate(tf, verbose=False, query_chunk=8, predict_unseen=t_pred,
                           eval_path="rel_shared", return_ranks=True)
    return dict(j_pred=j_pred, t_pred=t_pred, j_params=j_params, t_model=t_model,
                j_result=j_result, t_result=t_result)


def test_train_distill_matches_jax(predictors, carried, jax_run):
    t_params = module_to_flax(predictors["t_model"])[0]
    j_params = _np(predictors["j_params"])
    flat_j = dict(jax.tree_util.tree_leaves_with_path(j_params))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(t_params))
    assert set(flat_t) == set(flat_j)
    for path, ref in flat_j.items():
        np.testing.assert_allclose(flat_t[path], ref, **TOL, err_msg=jax.tree_util.keystr(path))
    ids = np.arange(jax_run["jf"].table.n_relations)
    np.testing.assert_allclose(predictors["t_pred"](ids).numpy(),
                               np.asarray(predictors["j_pred"](ids)), **TOL)
    unseen = carried["tf"].generate_rel_embeddings_unseen(predictors["t_pred"])
    assert unseen.shape == (len(ids), jax_run["jf"].cfg.emb_dim)


def test_predict_unseen_ranks_equal_jax(predictors):
    a, b = predictors["j_result"], predictors["t_result"]
    assert b["n"] == a["n"] > 0
    np.testing.assert_array_equal(b["ranks"], a["ranks"])
    for m in ("hits10", "hits5", "hits1", "mrr"):
        assert b[m] == a[m], m
