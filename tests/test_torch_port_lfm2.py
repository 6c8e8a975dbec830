"""The LFM2 encoder (``models/lfm2.py``) against the benchmark's plain
reference (``portbench/reference/lfm2.py``) on the CPU, at a small size
(the ``lfm2-tiny`` preset: width 128, 4 query heads over 2 KV heads of 32,
8 experts of 64 with top-4, layers [conv, conv, attention, conv, conv,
conv] with 2 dense), on seeded random weights drawn by the benchmark's
``weights.py``: each part, the whole encoder's pooled vectors, and one
serving round of the ``lfm2-serve`` cell through ``FusionTrainer`` and
``ZSLModule``.

Tolerances: the parts and the pooled vectors agree to 2e-5 of their scale
(float32, another summation order: the program groups the experts' rows
and sums four slots where the reference sums every expert, masked); the
serving round is held to the cell's own limits.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from mre_tpu_torch.core.config import Config
from mre_tpu_torch.models import lfm2
from mre_tpu_torch.models.m3ae import M3AE, m3ae_config
from portbench import weights
from portbench.reference import lfm2 as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "portbench", "tests", "tiny-lfm2.json")
TOL = 2e-5


def _cfg() -> dict:
    with open(TINY) as f:
        return json.load(f)


def _prog_cfg() -> Config:
    return m3ae_config("lfm2-tiny")


def _drawn(module, seed=0, prefix=""):
    """Draws for ``module``'s state, loaded into it, as the reference's dict
    under ``prefix``."""
    p = weights.for_module(module, torch.Generator().manual_seed(seed), "cpu")
    return {prefix + k: v for k, v in p.items()}


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _x(b=3, n=21, d=128, seed=1):
    return torch.randn(b, n, d, generator=torch.Generator().manual_seed(seed))


def test_preset_matches_the_published_config():
    """The registered lfm2-8b-a1b preset holds the published widths and
    layer pattern, which the cell's configuration file copies."""
    with open(os.path.join(ROOT, "portbench", "configs", "lfm2-8b-a1b.json")) as f:
        pub = json.load(f)
    c = m3ae_config("lfm2-8b-a1b")
    assert list(c.layer_types) == pub["published"]["layer_types"]
    assert list(c.layer_types[:10]) == pub["layer_types"]
    assert (c.emb_dim, c.num_heads, c.num_kv_heads, c.intermediate_size,
            c.moe_intermediate_size, c.num_experts, c.num_experts_per_tok, c.num_dense_layers,
            c.conv_L_cache, c.rope_theta, c.norm_eps) == (
        pub["hidden_size"], pub["num_attention_heads"], pub["num_key_value_heads"],
        pub["intermediate_size"], pub["moe_intermediate_size"], pub["num_experts"],
        pub["num_experts_per_tok"], pub["num_dense_layers"], pub["conv_L_cache"],
        pub["rope_theta"], pub["norm_eps"])


def test_short_conv_matches_reference():
    c = _prog_cfg()
    m = lfm2.ShortConv(c.emb_dim, c.conv_L_cache, torch.float32)
    p = _drawn(m, prefix="conv.")
    x = _x()
    with torch.no_grad():
        assert _gap(m(x), ref.short_conv(p, "conv", x)) < TOL
        # causal: the last position moves nothing before it
        y = x.clone()
        y[:, -1] += 1.0
        torch.testing.assert_close(m(y)[:, :-1], m(x)[:, :-1], rtol=0, atol=0)


def test_attention_matches_reference():
    """QK-norm, RoPE, causal and grouped KV heads on the plain path."""
    c, cfg = _prog_cfg(), _cfg()
    m = lfm2.GroupedAttention(c.emb_dim, c.num_heads, c.num_kv_heads, c.norm_eps, "auto",
                              torch.float32)
    p = _drawn(m, prefix="att.")
    x = _x()
    n = x.shape[1]
    with torch.no_grad():
        cos, sin = lfm2.rope_tables(n, m.head_dim, c.rope_theta, "cpu")
        out = m(x, cos, sin)
        assert _gap(out, ref.attention(p, "att", x, cfg)) < TOL
        # grouped: the kernel's layout of the heads, against KV repeated per group
        assert m.k_proj.weight.shape[0] == c.num_kv_heads * m.head_dim < m.q_proj.weight.shape[0]
        y = x.clone()
        y[:, 7:] = torch.randn(y[:, 7:].shape, generator=torch.Generator().manual_seed(5))
        torch.testing.assert_close(m(y, cos, sin)[:, :7], out[:, :7], rtol=0, atol=1e-6)


def _moe():
    c = _prog_cfg()
    m = lfm2.SparseMoE(c.emb_dim, c.moe_intermediate_size, c.num_experts, c.num_experts_per_tok,
                       c.norm_topk_prob, c.routed_scaling_factor, c.use_expert_bias,
                       torch.float32)
    return m, _drawn(m, prefix="ff.")


def test_router_selects_by_biased_and_weighs_by_unbiased_scores():
    m, p = _moe()
    x = _x().reshape(-1, 128)
    with torch.no_grad():
        m.expert_bias.zero_()
        m.expert_bias[0] = 10.0          # expert 0 chosen for every token, whatever its score
        chosen, w = m.route(x)
        scores = torch.sigmoid(x @ m.gate.weight.T)
        assert bool((chosen == 0).any(-1).all())
        own = torch.topk(scores + m.expert_bias, 4).indices
        assert torch.equal(torch.sort(chosen, -1).values, torch.sort(own, -1).values)
        want = scores.gather(1, chosen)
        torch.testing.assert_close(w, want / want.sum(-1, keepdim=True), rtol=1e-6, atol=0)
        assert not bool(torch.equal(torch.sort(chosen, -1).values,
                                    torch.sort(torch.topk(scores, 4).indices, -1).values))


def test_moe_matches_dense_masked_reference():
    m, p = _moe()
    cfg = _cfg()
    x = _x().reshape(-1, 128)
    with torch.no_grad():
        out = m(x)
        want, biased, used, followed = ref.moe(p, "ff", x, cfg)
        assert _gap(out, want) < TOL
        chosen, _ = m.route(x)
        assert float(ref.margins(biased, chosen, used).abs().max()) == 0.0
        assert not bool(followed.any())


def _encoder(seed=0):
    c = _prog_cfg()
    m = M3AE(1024, 8, 8 * 8 * 3, c)
    p = _drawn(m, seed, prefix="M3AEmodel.")
    return m, p


def _inputs(b=5, seed=2):
    g = torch.Generator().manual_seed(seed)
    image = torch.randn(b, 16, 192, generator=g)
    text = torch.randint(0, 1024, (b, 8), generator=g)
    pad = torch.zeros(b, 8)
    for i in range(b):
        pad[i, 8 - i:] = 1.0              # row i: its last i tokens PAD
    return image, text, pad


def test_pooled_vectors_match_reference():
    """The whole encoder through M3AE's representation pass: each row's
    final-normed state at its last non-PAD position."""
    m, p = _encoder()
    image, text, pad = _inputs()
    enc = ref.LFM2(_cfg())
    with torch.no_grad():
        pooled, states = m.forward_representation(image, text, pad)
        want, _ = enc.pooled(p, image, text, pad)
        assert pooled.shape == (5, 1, 128)
        assert _gap(pooled[:, 0], want) < TOL
        # the description pass: no image
        pooled, _ = m.forward_representation(None, text, pad)
        want, _ = enc.pooled(p, None, text, pad)
        assert _gap(pooled[:, 0], want) < TOL


def test_right_padding_leaves_valid_rows_unchanged():
    """More PAD on the right, whatever its ids, never moves a row's vector."""
    m, _ = _encoder()
    image, text, pad = _inputs()
    g = torch.Generator().manual_seed(9)
    wide_text = torch.cat([text, torch.randint(0, 1024, (5, 6), generator=g)], 1)
    wide_pad = torch.cat([pad, torch.ones(5, 6)], 1)
    with torch.no_grad():
        a, _ = m.forward_representation(image, text, pad)
        b, _ = m.forward_representation(image, wide_text, wide_pad)
    torch.testing.assert_close(b, a, rtol=0, atol=2e-6)


def _cell(seed: int) -> dict:
    """One run of the cell on the CPU at the tiny size, as ``portbench.run``
    makes it (whose own check that no JAX is loaded cannot hold in this
    suite, where conftest.py loads it): its checks and notes."""
    import shutil

    from portbench import harness, run
    from portbench.jobs import serve_lfm2

    _, _, _, traffic, limits = run.cell_files("lfm2-serve", ROOT)
    traffic = dict(copy.deepcopy(traffic), entity_batch=16, relation_batch=4, query_chunk=8,
                   profile_after=1, reference_block=16)
    ctx = harness.Context(cell="lfm2-serve", config=_cfg(), traffic=traffic, limits=limits,
                          seed=seed, seconds=0.5, trace=False, device="cpu",
                          work_dir=harness.work_dir())
    try:
        window, rec = serve_lfm2.run(ctx)
        numbers, notes = serve_lfm2.numbers(ctx, rec)
    finally:
        shutil.rmtree(ctx.work_dir, ignore_errors=True)
    checks = harness.checks_from(numbers, limits)
    return dict(correct=harness.correct(checks), attempted=window.units, notes=notes,
                setup_s=window.setup_s,
                checks={k: {"value": v, "limit": lim} for k, v, lim in checks})


def test_serving_round_matches_reference():
    """One round of the cell at the tiny size: the entity sweep, relation
    sweep, generated vectors and ranks through FusionTrainer and ZSLModule
    against the reference, each far inside the cell's limits, every token
    routed as the reference routes it."""
    out = _cell(2 ** 31 + 23)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] < c["limit"] / 10, (name, c)
    assert out["checks"]["route_margin"]["value"] == 0.0
    assert out["attempted"] >= 1 and out["setup_s"] > 0
    assert out["notes"]["tokens_differing_from_round_1"] == 0


@pytest.mark.parametrize("fault", ["softmax_routing", "unbiased_selection", "biased_weights",
                                   "noncausal_conv"])
def test_planted_fault_fails_route_margin(fault):
    """A program that routes by softmax, selects without the expert bias,
    weighs by the biased scores or lets the convolution see ahead is
    refused, by route_margin orders of magnitude over its limit."""
    from portbench import lfm2_faults

    with lfm2_faults.FAULTS[fault]():
        out = _cell(7)
    assert not out["correct"]
    c = out["checks"]["route_margin"]
    assert c["value"] > 100 * c["limit"], c


def test_training_and_mesh_refuse_the_lfm2_encoder(tmp_path):
    from mre_tpu_torch.data.fixtures import write_zsl_dataset
    from mre_tpu_torch.data.kg import TripleTable
    from mre_tpu_torch.data.loaders import load_zsl_dataset
    from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
    from mre_tpu_torch.parallel import mesh as pmesh
    from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer

    path = str(tmp_path / "d")
    write_zsl_dataset(path, n_ent=30, n_rel=6, n_unseen=2, triples_per_rel=12, image_size=8,
                      n_candidates=22, seed=3)
    data = load_zsl_dataset(path, mode="train")
    store = MultimodalStore(data["mm_info"], data["rel_des"], MultimodalPipelineConfig(
        image_size=32, vocab_size=1024, tokenizer_max_length=8,
        unpaired_tokenizer_max_length=16, seed=3))
    table = TripleTable.build(np.asarray(data["triples"]).T, len(data["e2id"]),
                              len(data["r2id"]))
    trainer = FusionTrainer(table, store, FusionConfig(
        model_type="lfm2-tiny", patch_size=8, batch_size=4, sample_size=2,
        encoder=dict(layer_types=("conv", "full_attention", "conv"), num_dense_layers=1)),
        device="cpu")
    enc = trainer.model.M3AEmodel.encoder
    assert isinstance(enc, lfm2.LFM2) and enc.depth == 3
    assert [type(getattr(enc, f"Layer_{i}").feed_forward).__name__ for i in range(3)] == \
        ["SwiGLU", "SparseMoE", "SparseMoE"]
    assert trainer.generate_ent_embeddings(batch_size=16).shape == (30, 200)
    with pytest.raises(NotImplementedError, match="LFM2"):
        trainer.train_epoch()
    with pytest.raises(NotImplementedError, match="LFM2"):
        trainer.train_step(next(iter(trainer.sampler)))
    fake = type("M", (), {"n_model": 2})()
    with pytest.raises(NotImplementedError, match="LFM2"):
        with pmesh.shard_transformer_ffn(trainer.model.M3AEmodel, fake):
            pass


def test_moe_roofline_counts_expert_flops_from_shapes():
    """``moe_roofline.lfm2`` takes the round's expert FLOPs from the
    configuration's shapes: every token of the 512 entities × 321, the 16
    relations' and the 2 generator passes' descriptions × 321, four experts
    each in the 8 MoE layers; whatever the program's counter says."""
    import importlib.util
    import types

    from portbench import flops, flops_lfm2

    with open(os.path.join(ROOT, "portbench", "configs", "lfm2-8b-a1b.json")) as f:
        cfg = json.load(f)
    assert flops_lfm2.round_assignments(cfg) == (512 + 16 + 2) * 321 * 4 * 8
    spec = importlib.util.spec_from_file_location(
        "moe_roofline", os.path.join(ROOT, "portbench", "metrics", "moe_roofline.lfm2.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    want = 100.0 * 5_444_160 * 3 * 2 * 2048 * 1792 / flops.PEAK_FLOPS["float32"] / 2.0
    for counted in (None, {"moe.routed": 1}, {"moe.routed": 10 ** 9}):
        run = types.SimpleNamespace(summary=types.SimpleNamespace(inside_s={"moe.experts": 2.0}),
                                    ctx=types.SimpleNamespace(config=cfg, program_counts=counted))
        assert reader.read(run) == pytest.approx(want, rel=1e-12)
    run.summary.inside_s = {}
    assert reader.read(run) is None


def test_moe_spans_and_counters():
    """With tracing on, an MoE layer counts its token-expert assignments
    and its largest expert's rows, and times its routing and its experts
    inside its own span."""
    from mre_tpu_torch.core import profiling

    c = _prog_cfg()
    layer = lfm2.Layer(c, "conv", False, "auto", torch.float32)
    weights.for_module(layer, torch.Generator().manual_seed(3), "cpu")
    x = _x()
    profiling.reset()
    profiling.enable()
    try:
        with torch.no_grad():
            layer(x, None, None)
    finally:
        profiling.disable()
    snap = profiling.snapshot()
    profiling.reset()
    with torch.no_grad():
        chosen, _ = layer.feed_forward.route(layer.LayerNorm_1(
            x + layer.conv(layer.LayerNorm_0(x))).reshape(-1, 128))
    rows = torch.bincount(chosen.reshape(-1), minlength=8)
    assert snap["counts"] == {"moe.routed": chosen.numel(), "moe.max_expert_rows": int(rows.max())}
    parents = {name: parent for name, parent, _ in snap["spans"]}
    assert parents == {"lfm2.conv": None, "lfm2.moe": None, "moe.route": "lfm2.moe",
                       "moe.experts": "lfm2.moe"}


def test_cli_evaluate_serves_the_lfm2_encoder(tmp_path, monkeypatch):
    """``python -m mre_tpu_torch.cli.main --evaluate --model_type lfm2-tiny``:
    the entry point builds the LFM2 encoder through ``unified_config`` and
    serves a round with it (entity and relation sweeps, the GAN's generator
    passes, the evaluation)."""
    from mre_tpu_torch.cli import main as cli
    from mre_tpu_torch.cli.args import read_options
    from mre_tpu_torch.data.fixtures import write_zsl_dataset

    write_zsl_dataset(str(tmp_path / "data" / "tiny-zs"), n_ent=30, n_rel=6, n_unseen=2,
                      triples_per_rel=12, image_size=8, n_candidates=22, seed=3)
    monkeypatch.chdir(tmp_path)
    args = read_options([
        "--evaluate", "--dataset", "tiny-zs", "--data_root", "data", "--model_type", "lfm2-tiny",
        "--emb_dim", "12", "--noise_dim", "4", "--patch_size", "8", "--image_size", "16",
        "--vocab_size", "100", "--test_sample", "4", "--max_neighbor", "8",
        "--pretrain_times", "2", "--pretrain_batch_size", "4", "--pretrain_few", "2",
        "--pretrain_subepoch", "2", "--train_times", "2", "--G_batch_size", "8",
        "--output_dir", "runs", "--device", "cpu"])
    built = []
    real = cli.FusionTrainer

    def trainer(*a, **k):
        built.append(real(*a, **k))
        return built[-1]

    monkeypatch.setattr(cli, "FusionTrainer", trainer)
    result = cli.evaluate_entry(args)
    assert isinstance(built[0].model.M3AEmodel.encoder, lfm2.LFM2)
    assert 0.0 <= result["mrr"] <= 1.0
