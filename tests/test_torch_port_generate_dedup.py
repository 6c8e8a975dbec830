"""``FusionTrainer.generate`` encodes each distinct relation id once.

The frozen description pass gives every row of one relation the same
vector, so ``generate`` sends each distinct id through it once and
expands the result to the rows; the generator head still runs on every
row. These tests hold it against the same call with the de-duplication
bypassed (every row through the text pass, as ``UnifiedModel.generate``
takes them), on the CPU at a tiny size:

* a GAN-shaped batch (two relations of k rows each and a padded tail), an
  evaluation-shaped one (``np.full(test_sample, r)``) and distinct ids
  give, row for row, the full pass's vectors within ‖Δ‖ ≤ 1e-6 × ‖full‖
  over the rows (float32: a smaller batch may take another GEMM blocking,
  and the head's layer norm over 12 features doubles a relative error;
  on 8 CPU threads ‖Δ‖ / ‖full‖ reads 8.4e-7 in the GAN case, on one 0);
* ``M3AE.forward_representation`` sees only the distinct rows, and the
  counters ``zsl.generate.rows`` / ``zsl.generate.encoded`` read the rows
  asked for and the rows encoded;
* a D step and a G step with explicit draws give the full pass's losses
  (rtol 1e-4, atol 1e-6) and first gradients (atol 1e-4 × the leaf's max
  |g|), the port's tolerances against JAX in
  ``tests/test_torch_port_zsl_train.py``.

The card case repeats the first comparison at M3AE-small's widths
(384 × 12, 321 description tokens, 2 × 256 rows and a tail) on the
attention kernel; it imports no JAX and runs there with

    python -m pytest --noconftest tests/test_torch_port_generate_dedup.py -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mre_tpu_torch.core import profiling
from mre_tpu_torch.data.fixtures import write_zsl_dataset
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.loaders import load_zsl_dataset
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer
from mre_tpu_torch.zsl.module import ZSLConfig, ZSLModule

PIPE = dict(image_size=16, vocab_size=100, tokenizer_max_length=6,
            unpaired_tokenizer_max_length=10)
MODEL = dict(model_type="tiny", emb_dim=12, noise_dim=4, patch_size=8)
ZSL = dict(emb_dim=12, noise_dim=4, test_sample=5, max_neighbor=10, G_batch_size=8,
           gan_batch_rela=2)
REL = 1e-6                      # row vectors: ‖Δ‖ over ‖full pass‖
INFO = dict(rtol=1e-4, atol=1e-6)
GRAD = 1e-4                     # first gradients: atol over the leaf's max |g|


def _ids(case: str, n_rel: int, k: int = 8, tail: int = 3, test_sample: int = 5) -> np.ndarray:
    if case == "gan":           # rel_ids += [r] * k per relation, the tail repeats the last row
        return np.array([1] * k + [4] * k + [4] * tail)
    if case == "evaluate":
        return np.full(test_sample, 2)
    return np.random.default_rng(0).permutation(n_rel)


CASES = ("gan", "evaluate", "distinct")


def _dataset(path: str, pipe: dict):
    write_zsl_dataset(path, n_ent=30, n_rel=6, n_unseen=2, triples_per_rel=12,
                      image_size=8, n_candidates=22, seed=3)
    data = load_zsl_dataset(path, mode="train")
    table = TripleTable.build(np.asarray(data["triples"]).T, len(data["e2id"]),
                              len(data["r2id"]))
    store = MultimodalStore(data["mm_info"], data["rel_des"], MultimodalPipelineConfig(**pipe))
    return data, table, store


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dedup"))
    data, table, store = _dataset(path, PIPE)
    return path, data, table, store


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _full_pass(trainer):
    """``trainer.generate`` with the de-duplication bypassed: every row
    through the text pass."""
    def generate(rel_ids, noise, update_sn=False):
        ids = np.asarray(rel_ids)
        return trainer.model.generate(trainer._put(trainer.store.rel_ids[ids]),
                                      trainer._put(trainer.store.rel_mask[ids]),
                                      noise.to(trainer.device), update_sn=update_sn)
    return generate


def _noise(n: int, dim: int, device="cpu") -> torch.Tensor:
    return torch.randn(n, dim, generator=torch.Generator().manual_seed(n)).to(device)


def _gap(got: torch.Tensor, full: torch.Tensor) -> float:
    """‖got − full‖ / ‖full‖ over all rows, in float64."""
    assert got.shape == full.shape
    got, full = got.detach().double().cpu(), full.detach().double().cpu()
    return float((got - full).norm() / full.norm())


@pytest.mark.parametrize("case", CASES)
def test_generate_matches_the_full_pass(tiny, case):
    _, _, table, store = tiny
    trainer = FusionTrainer(table, store, FusionConfig(**MODEL), device="cpu")
    ids = _ids(case, table.n_relations)
    noise = _noise(len(ids), MODEL["noise_dim"])
    with torch.no_grad():
        got = trainer.generate(ids, noise)
        full = _full_pass(trainer)(ids, noise)
    assert _gap(got, full) <= REL


@pytest.mark.parametrize("case", CASES)
def test_text_pass_sees_only_the_distinct_rows(tiny, case, monkeypatch):
    _, _, table, store = tiny
    trainer = FusionTrainer(table, store, FusionConfig(**MODEL), device="cpu")
    m3ae = trainer.model.M3AEmodel
    inner, batches = m3ae.forward_representation, []

    def recording(image, text, *a, **k):
        batches.append(text.shape[0])
        return inner(image, text, *a, **k)

    monkeypatch.setattr(m3ae, "forward_representation", recording)
    ids = _ids(case, table.n_relations)
    profiling.enable()
    with torch.no_grad():
        trainer.generate(ids, _noise(len(ids), MODEL["noise_dim"]))
    profiling.disable()
    distinct = len(np.unique(ids))
    assert batches == [distinct]
    assert distinct == {"gan": 2, "evaluate": 1, "distinct": len(ids)}[case]
    counts = profiling.snapshot()["counts"]
    assert counts["zsl.generate.rows"] == len(ids)
    assert counts["zsl.generate.encoded"] == distinct


def _record_masks(zsl, log: list):
    """Each dropout-mask object ``zsl`` makes appends its drawn masks to a
    new list in ``log``."""
    make = zsl._dropout

    def dropout(draws, rows=None):
        masks = make(draws, rows)
        got: list = []
        log.append(got)
        cut = masks._cut

        def keep(mask):
            got.append(mask.clone())
            return cut(mask)

        masks._cut = keep
        return masks

    zsl._dropout = dropout


def _first_grads(opt, module) -> dict:
    """Each leaf's gradient of the optimiser's one step so far, from
    Adam's first moment (the G step clears ``.grad``)."""
    beta1 = opt.param_groups[0]["betas"][0]
    return {n: opt.state[p]["exp_avg"] / (1 - beta1)
            for n, p in module.named_parameters() if p in opt.state}


@pytest.fixture(scope="module")
def gan_steps(tiny):
    """A D step then a G step on three fresh pairs with the same weights,
    batches and noise: one draws and records the dropout masks, then the
    de-duplicating path and the full pass each take them."""
    path, data, table, store = tiny
    base = FusionTrainer(table, store, FusionConfig(**MODEL), device="cpu").model.state_dict()
    rng = np.random.default_rng(5)
    n_ent, n_rel = len(data["e2id"]), len(data["r2id"])
    ent = rng.normal(size=(n_ent, 12)).astype(np.float32)
    rel = rng.normal(size=(n_rel, 12)).astype(np.float32)
    out, batches, draws, d0 = {}, None, None, None
    for run in ("record", "dedup", "full"):
        trainer = FusionTrainer(table, store, FusionConfig(**MODEL), device="cpu")
        trainer.model.load_state_dict(base)
        zsl = ZSLModule(path, data["r2id"], data["e2id"], ZSLConfig(**ZSL), device="cpu")
        if d0 is None:
            d0 = {k: v.clone() for k, v in zsl.discriminator.state_dict().items()}
        zsl.discriminator.load_state_dict(d0)
        zsl.update_embed(ent, rel)
        zsl.compute_centroids()
        if batches is None:
            batches = (zsl._padded_gan_batch(), zsl._padded_gan_batch())
            Q = len(batches[0][0])
            draws = (dict(noise=rng.normal(size=(Q, 4)).astype(np.float32),
                          alpha=rng.uniform(size=(Q, 1)).astype(np.float32)),
                     dict(noise=rng.normal(size=(Q, 4)).astype(np.float32)))
        if run == "record":
            log: list = []
            _record_masks(zsl, log)
        else:
            draws[0]["dropout"], draws[1]["dropout"] = masks
        if run == "full":
            trainer.generate = _full_pass(trainer)
        d_info = zsl.d_step(trainer, batches[0], draws=draws[0])
        d_grads = _first_grads(zsl.opt_D, zsl.discriminator)
        zsl.reset_g_optimizer(trainer)
        g_info = zsl.g_step(trainer, batches[1], draws=draws[1])
        g_grads = _first_grads(zsl.opt_G, trainer.model)
        if run == "record":
            masks = log
        out[run] = dict(D=({k: float(v) for k, v in d_info.items()}, d_grads),
                        G=({k: float(v) for k, v in g_info.items()}, g_grads))
    return out, [b[0] for b in batches]


@pytest.mark.parametrize("kind", ["D", "G"])
def test_gan_steps_match_the_full_pass(gan_steps, kind):
    out, rel_ids = gan_steps
    for ids in rel_ids:         # the batches repeat their relations
        assert len(np.unique(ids)) < len(ids)
    (info, grads), (info_f, grads_f) = out["dedup"][kind], out["full"][kind]
    assert set(info) == set(info_f) and info
    for k in info_f:
        assert np.isfinite(info[k]), k
        np.testing.assert_allclose(info[k], info_f[k], **INFO, err_msg=k)
    assert set(grads) == set(grads_f) and grads
    for n, g in grads_f.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), rtol=0,
                                   atol=GRAD * float(g.abs().max()), err_msg=n)


@pytest.mark.cuda
def test_generate_matches_the_full_pass_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: M3AE-small's widths on the attention kernel")
    _, table, store = _dataset(str(tmp_path), dict(PIPE, unpaired_tokenizer_max_length=320))
    cfg = FusionConfig(model_type="small", emb_dim=200, noise_dim=15, patch_size=16)
    trainer = FusionTrainer(table, store, cfg, device="cuda")
    for case, ids in (("gan", _ids("gan", 0, k=256, tail=7)),
                      ("evaluate", _ids("evaluate", 0, test_sample=20)),
                      ("distinct", _ids("distinct", table.n_relations))):
        noise = _noise(len(ids), cfg.noise_dim, "cuda")
        with torch.no_grad():
            got = trainer.generate(ids, noise)
            full = _full_pass(trainer)(ids, noise)
        gap = _gap(got, full)
        print(f"{case}: rows {len(ids)}, ‖Δ‖/‖full‖ {gap:.3e}, max |Δ| / max |full| "
              f"{float((got - full).abs().max() / full.abs().max()):.3e}")
        assert gap <= REL
