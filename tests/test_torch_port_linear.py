"""The float32 linear product of ``ops/linear.py``: its TF32 split, its
three passes, how ``linear`` routes, and, on the card only, the Hopper
kernel ``gemm_f32x3`` against ``F.linear``.

This module imports no JAX (the card's machine has none), so its card
tests run there without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_port_linear.py -m cuda

Card tolerance: max |kernel − F.linear| ≤ 1e-5 of max |F.linear| (cuBLAS
SGEMM with TF32 off; both lie within ~5e-6 of float64 at the widest K,
7168, and the kernel nearer).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mre_tpu_torch.models import initializers, lfm2
from mre_tpu_torch.ops import attention
from mre_tpu_torch.ops import linear as lin
from mre_tpu_torch.utils import build
from portbench import trace

# the K of every float32 Dense the benchmark's cells run: the Extractor 200;
# M3AE-small 384 and 1536; its decoder 512 and 2048; M3AE-huge 1280 and
# 5120; LFM2-8B-A1B 2048, its experts 1792, its dense SwiGLU 7168
CELL_K = (200, 384, 512, 1280, 1536, 1792, 2048, 5120, 7168)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32)


@pytest.mark.parametrize("kind", ["normal", "ties", "tiny", "wide"])
def test_split_matches_numpy_bits(kind):
    """hi is x rounded to the nearest TF32, ties away from zero, bit for
    bit as an unsigned add of 0x1000 and a mask; hi + lo gives x back
    exactly, and lo is at most half of hi's last place."""
    rng = np.random.default_rng(7)
    if kind == "normal":
        x = rng.standard_normal(4096).astype(np.float32)
    elif kind == "ties":                  # the 13 dropped bits at 0x1000 (a tie), or beside it
        base = _bits(rng.standard_normal(1024).astype(np.float32)) & np.uint32(0xffffe000)
        x = np.concatenate([base | np.uint32(0x1000), base | np.uint32(0x0fff),
                            base | np.uint32(0x1001)]).view(np.float32)
    elif kind == "tiny":                  # subnormals and the smallest normals
        x = (rng.standard_normal(1024) * 1e-38).astype(np.float32)
    else:
        x = (rng.standard_normal(1024) * 10.0 ** rng.integers(-20, 20, 1024)).astype(np.float32)
    want = (_bits(x).astype(np.uint64) + 0x1000) & 0xffffe000
    hi, lo = lin.split_tf32(torch.from_numpy(x))
    assert np.array_equal(_bits(hi.numpy()), want.astype(np.uint32))
    assert torch.equal(hi + lo, torch.from_numpy(x))
    # |lo| ≤ half a TF32 place of hi (2^-11 of |hi|) among the normals
    normal = hi.abs() >= torch.finfo(torch.float32).tiny
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11)[normal].all())
    assert np.array_equal(_bits(lin.tf32(lo).numpy()) & np.uint32(0x1fff),
                          np.zeros(x.size, np.uint32))


@pytest.mark.parametrize("K", CELL_K)
def test_three_passes_hold_float32(K, record_property):
    """The kernel's three passes (hi·hi + hi·lo + lo·hi, lo read as TF32),
    emulated in plain PyTorch, lie within twice float32 SGEMM's own error
    of a float64 product; one TF32 pass does not."""
    g = torch.Generator().manual_seed(K)
    x = torch.randn(256, K, generator=g)
    w = torch.randn(128, K, generator=g) / K ** 0.5
    b = torch.randn(128, generator=g)
    ref = F.linear(x.double(), w.double(), b.double())
    scale = float(ref.abs().max())
    err_sgemm = float((F.linear(x, w, b).double() - ref).abs().max()) / scale
    err3 = float((lin.linear_reference(x, w, b).double() - ref).abs().max()) / scale
    one = F.linear(lin.split_tf32(x)[0], lin.split_tf32(w)[0], b)
    err1 = float((one.double() - ref).abs().max()) / scale
    record_property("sgemm", err_sgemm)
    record_property("three_pass", err3)
    record_property("one_pass", err1)
    assert err3 <= 2 * err_sgemm
    assert err1 > 2 * err_sgemm


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_tensor_takes_f_linear(grad):
    """A CPU product is ``F.linear``'s exactly, with or without autograd,
    and launches nothing."""
    lin.reset_launches()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 8, generator=g)
    w = torch.randn(6, 8, generator=g, requires_grad=grad)
    b = torch.randn(6, generator=g)
    y = lin.linear(x, w, b)
    assert torch.equal(y, F.linear(x, w, b))
    assert y.requires_grad == grad
    assert lin.LAUNCHES == {"gemm_f32x3": 0}


def _operands(rows=8, K=8, N=6, dtype=torch.float32):
    g = torch.Generator().manual_seed(2)
    return (torch.randn(rows, K, generator=g).to(dtype), torch.randn(N, K, generator=g).to(dtype),
            torch.randn(N, generator=g).to(dtype))


@pytest.mark.parametrize("case, takes", [
    ("no_grad", True),
    ("grad_on_no_operand_requires_it", True),
    ("weight_requires_grad", False),
    ("input_requires_grad", False),
    ("bias_requires_grad", False),
    ("bfloat16", False),
    ("k_not_multiple_of_4", False),
    ("transposed_weight", False),
    ("empty", False),
])
def test_kernel_takes(case, takes, monkeypatch):
    """The routing decision, asked on every device: the kernel takes a
    float32 product that autograd needs nothing from, with K % 4 == 0 and
    a contiguous weight; everything else goes to ``F.linear``."""
    x, w, b = _operands(K=6 if case == "k_not_multiple_of_4" else 8,
                        rows=0 if case == "empty" else 8,
                        dtype=torch.bfloat16 if case == "bfloat16" else torch.float32)
    if case == "transposed_weight":
        w = torch.randn(8, 8).T
    if case == "weight_requires_grad":
        w.requires_grad_()
    elif case == "input_requires_grad":
        x.requires_grad_()
    elif case == "bias_requires_grad":
        b.requires_grad_()
    with torch.set_grad_enabled(case != "no_grad"):
        assert lin._kernel_takes(x, w, b) is takes
    if case in ("weight_requires_grad", "input_requires_grad", "bias_requires_grad"):
        with torch.no_grad():
            assert lin._kernel_takes(x, w, b) is True


def test_kernel_takes_any_row_count():
    """The rows (counted over every leading dimension) do not route: one
    row and a strided 3-D input take the kernel as a large product does, so
    a row's result never depends on the batch it sits in."""
    w, b = _operands()[1:]
    with torch.no_grad():
        assert lin._kernel_takes(torch.zeros(1, 8), w, b) is True
        assert lin._kernel_takes(torch.zeros(2, 11, 16)[..., ::2], w, b) is True
        assert lin._kernel_takes(torch.zeros(4096, 8), w, b) is True


def _spy(monkeypatch) -> list:
    """Record every routing decision of ``linear``."""
    got: list = []
    inner = lin._kernel_takes

    def spy(x, weight, bias):
        got.append(inner(x, weight, bias))
        return got[-1]

    monkeypatch.setattr(lin, "_kernel_takes", spy)
    return got


def test_dense_and_experts_route_through_linear(monkeypatch):
    """``initializers.dense`` in float32 and the LFM2 experts ask ``linear``;
    ``dense`` below float32 does not."""
    got = _spy(monkeypatch)
    layer = initializers.Dense(8, 6)
    initializers.init_weights(layer, 0)
    x = torch.randn(4, 8)
    with torch.no_grad():
        assert torch.equal(initializers.dense(layer, x), F.linear(x, layer.weight, layer.bias))
        assert got == [True]
        initializers.dense(layer, x, torch.bfloat16)
        assert got == [True]
        moe = lfm2.SparseMoE(8, 12, experts=4, top_k=2, norm_topk_prob=True, scaling=1.0,
                             expert_bias=False, dtype=torch.float32)
        for p in moe.parameters():
            p.normal_(0.0, 0.2)
        moe(torch.randn(5, 8))
    # three products per expert that received rows
    assert len(got) > 1 and (len(got) - 1) % 3 == 0 and all(got)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    from mre_tpu_torch.data.fixtures import write_zsl_dataset
    from mre_tpu_torch.data.kg import TripleTable
    from mre_tpu_torch.data.loaders import load_zsl_dataset
    from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
    from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer
    from mre_tpu_torch.zsl.module import ZSLConfig, ZSLModule

    path = str(tmp_path_factory.mktemp("linear"))
    write_zsl_dataset(path, n_ent=30, n_rel=6, n_unseen=2, triples_per_rel=12,
                      image_size=8, n_candidates=22, seed=3)
    data = load_zsl_dataset(path, mode="train")
    table = TripleTable.build(np.asarray(data["triples"]).T, len(data["e2id"]),
                              len(data["r2id"]))
    store = MultimodalStore(data["mm_info"], data["rel_des"], MultimodalPipelineConfig(
        image_size=16, vocab_size=100, tokenizer_max_length=6,
        unpaired_tokenizer_max_length=10))
    trainer = FusionTrainer(table, store, FusionConfig(
        model_type="tiny", emb_dim=12, noise_dim=4, patch_size=8, batch_size=4, sample_size=2,
        neg_ent=2, image_mask_ratio=0.5, text_mask_ratio=0.5), device="cpu")
    zsl = ZSLModule(path, data["r2id"], data["e2id"], ZSLConfig(
        emb_dim=12, noise_dim=4, test_sample=5, max_neighbor=10, G_batch_size=8,
        gan_batch_rela=2), device="cpu")
    return trainer, zsl


def test_training_takes_the_kernel_only_in_the_frozen_description_pass(pipeline, monkeypatch):
    """In a fusion training step every product is under autograd but the
    relation descriptions' encoder pass, which runs under ``no_grad`` (the
    JAX package's stop_gradient, ``models/unified.py::_text_cls``): its 4
    Dense products per encoder block would take the kernel, no other. A
    serving round's sweeps and evaluation would take it throughout."""
    trainer, zsl = pipeline
    got = _spy(monkeypatch)
    frozen = []
    inner = trainer.model._text_cls

    def text_cls(*a, **k):
        frozen.append(len(got))
        out = inner(*a, **k)
        frozen[-1] = (frozen[-1], len(got))
        return out

    monkeypatch.setattr(trainer.model, "_text_cls", text_cls)
    steps = trainer.steps
    trainer.train_epoch()
    steps = trainer.steps - steps
    depth = trainer.model.M3AEmodel.cfg.depth
    assert steps > 0 and len(frozen) == steps
    inside = [i for lo, hi in frozen for i in range(lo, hi)]
    assert [got[i] for i in inside] == [True] * 4 * depth * steps
    assert not any(t for i, t in enumerate(got) if i not in set(inside))
    got.clear()
    ent = trainer.generate_ent_embeddings(batch_size=16)
    rel = trainer.generate_rel_embeddings(batch_size=4)
    zsl.update_embed(ent, rel)
    zsl.evaluate(trainer, verbose=False, eval_path="rel_shared", query_chunk=8)
    assert got and all(got)


def test_kernel_symbols_match_the_benchmarks_gemm_pattern():
    """``gemm_share.*`` counts device time by kernel name
    (``portbench.trace.GEMM``): both kernels of the library keep counting
    there, and the source defines them under these names."""
    source = (Path(lin.__file__).parent.parent / "csrc" / "gemm_f32x3.cu").read_text()
    for name in lin.KERNELS:
        assert trace.GEMM.search(name)
        assert re.search(r"__global__ void\b[^;{]*?\b" + name + r"\(", source)


def test_build_report_names_the_gemm_kernels():
    """chip_smoke.py's build report for the GEMM library: its two kernels
    by name from the mangled ptxas and SASS symbols, none of the attention
    library's."""
    anon = "_ZN46_GLOBAL__N__72a89065_13_gemm_f32x3_cu_1127e74d"
    gemm = anon + "17gemm_f32x3_kernelE14CUtensorMap_stS0_PKfPfiii"
    split = anon + "22gemm_tf32_split_kernelEPK6float4PS0_m"
    ptxas = (f"ptxas info    : Compiling entry function '{gemm}' for 'sm_90a'\n"
             "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
             "ptxas info    : Used 168 registers, used 1 barriers\n"
             f"ptxas info    : Compiling entry function '{split}' for 'sm_90a'\n"
             "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
             "ptxas info    : Used 24 registers, used 0 barriers\n")
    assert build.ptxas_report(ptxas, lin._kernel_name) == {
        "gemm_f32x3_kernel": dict(registers=168, spill_stores=0, spill_loads=0),
        "gemm_tf32_split_kernel": dict(registers=24, spill_stores=0, spill_loads=0)}
    assert attention.ptxas_report(ptxas) == {}
    sass = (f"\t\tFunction : {gemm}\n"
            "        /*0200*/     UTMALDG.2D [UR8], [UR4] ;\n"
            "        /*0300*/     HGMMA.64x128x8.F32.TF32 R24, R152, gdesc[UR4], RZ, !UPT ;\n"
            f"\t\tFunction : {split}\n"
            "        /*0100*/     LDG.E.128 R4, desc[UR4][R2.64] ;\n")
    assert build.sass_counts(sass, lin._kernel_name) == {
        "gemm_f32x3_kernel": dict(HMMA=0, HGMMA=1, UTMALDG=1),
        "gemm_tf32_split_kernel": dict(HMMA=0, HGMMA=0, UTMALDG=0)}


@pytest.mark.parametrize("encoder", ["m3ae", "lfm2"])
def test_smoke_expects_the_products_its_serving_round_routes(encoder, tmp_path, monkeypatch):
    """chip_smoke.py holds each serving round's ``gemm_f32x3`` launches on
    the card to ``gemm_round_launches``, worked out from the round's shapes
    (and, for LFM2, from the experts that took rows). On the CPU, at a tiny
    width with phase 3b's and 3c's batches and counts, that count is the
    number of products ``_kernel_takes`` accepts in the round, which is
    every product ``linear`` is asked for."""
    import chip_smoke as cs

    takes, marks, expert_rows = [], [], []
    inner, reset, select = lin._kernel_takes, cs.reset_launches, lfm2.SparseMoE.select

    def spy(x, weight, bias):
        takes.append(inner(x, weight, bias))
        return takes[-1]

    def mark():                           # the round starts after the launch counters' reset
        marks.append(len(takes))
        reset()

    def recorded(self, biased):
        chosen = select(self, biased)
        expert_rows.extend(torch.bincount(chosen.reshape(-1),
                                          minlength=biased.shape[1]).tolist())
        return chosen

    monkeypatch.setattr(lin, "_kernel_takes", spy)
    monkeypatch.setattr(cs, "reset_launches", mark)
    monkeypatch.setattr(lfm2.SparseMoE, "select", recorded)
    small = dict(image_size=32, patch_size=16, n_candidates=50, triples_per_rel=40)
    if encoder == "m3ae":
        cfg = dict(cs.HUGE, model_type="tiny", depth=2, **small)
        cs.phase_slice(str(tmp_path), cfg, device="cpu")
        round_ = takes[marks[0]:marks[1]]               # the kernel-path round
        want = cs.gemm_round_launches(cfg, str(tmp_path), 4 * cfg["depth"])
    else:
        cfg = dict(cs.LFM2, model_type="lfm2-tiny", depth=6, **small)
        cs.phase_lfm2(str(tmp_path), cfg, device="cpu")
        kinds = cs.transformer_preset("lfm2-tiny").layer_types[:6]
        round_ = takes[marks[0]:]
        want = cs.gemm_round_launches(cfg, str(tmp_path), 2 * kinds.count("conv")
                                      + 4 * kinds.count("full_attention")
                                      + 3 * cfg["num_dense_layers"], expert_rows)
    assert sum(round_) == len(round_) == want


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False


def _card_operands(M, K, N, bias, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=g, device="cuda")
    w = torch.randn(N, K, generator=g, device="cuda") / K ** 0.5
    b = torch.randn(N, generator=g, device="cuda") if bias else None
    return x, w, b


def _rel(y, ref) -> float:
    return float((y - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 63, 321, 642, 164352])
@pytest.mark.parametrize("K, N, bias", [
    (1280, 3840, True),                   # M3AE-huge's qkv
    (5120, 1280, True),                   # its fc2
    (2048, 1792, False),                  # an LFM2 expert's w1
    (200, 100, True),                     # the Extractor: N off the tile, a K tail
    (36, 257, False),                     # a K tail in the first slice, no bias
])
def test_kernel_matches_f_linear(M, K, N, bias):
    _card()
    x, w, b = _card_operands(M, K, N, bias, seed=M + K + N)
    before = dict(lin.LAUNCHES)
    y = lin.gemm_f32x3(x, w, b)
    torch.cuda.synchronize()
    assert lin.LAUNCHES == {"gemm_f32x3": before["gemm_f32x3"] + 1}
    assert y.shape == (M, N) and bool(torch.isfinite(y).all())
    assert _rel(y, F.linear(x, w, b)) <= 1e-5


@pytest.mark.cuda
def test_a_rows_result_does_not_depend_on_m():
    """No split of K that depends on M: a row's output is bit-equal
    whatever rows sit beside it."""
    _card()
    x, w, b = _card_operands(164352, 1280, 1280, True, seed=5)
    full = lin.gemm_f32x3(x, w, b)
    for lo, hi in ((0, 1), (0, 321), (1000, 1642), (164351, 164352)):
        assert torch.equal(lin.gemm_f32x3(x[lo:hi].contiguous(), w, b), full[lo:hi])


@pytest.mark.cuda
def test_refused_k_raises_and_linear_routes_it():
    """K % 4 != 0 (TMA's 16-byte strides) raises from the kernel's wrapper;
    ``linear`` routes such a product to ``F.linear`` by its own check."""
    _card()
    x, w, b = _card_operands(64, 6, 10, True, seed=6)
    with pytest.raises(ValueError, match="K % 4"):
        lin.gemm_f32x3(x, w, b)
    before = dict(lin.LAUNCHES)
    with torch.no_grad():
        assert torch.equal(lin.linear(x, w, b), F.linear(x, w, b))
    assert lin.LAUNCHES == before


@pytest.mark.cuda
def test_linear_launches_only_without_autograd():
    """On the card ``linear`` launches the kernel under ``no_grad`` (a 3-D
    input, its rows flattened) at any row count, the rows of a slice equal
    to the whole's, and not for a product autograd needs."""
    _card()
    x, w, b = _card_operands(4 * 321, 384, 1152, True, seed=7)
    x = x.view(4, 321, 384)
    before = lin.LAUNCHES["gemm_f32x3"]
    with torch.no_grad():
        y = lin.linear(x, w, b)
        assert torch.equal(lin.linear(x[1:2], w, b), y[1:2])
    assert y.shape == (4, 321, 1152)
    assert lin.LAUNCHES["gemm_f32x3"] == before + 2
    assert _rel(y, F.linear(x, w, b)) <= 1e-5
    w.requires_grad_()
    y = lin.linear(x, w, b)
    assert y.requires_grad and lin.LAUNCHES["gemm_f32x3"] == before + 2
