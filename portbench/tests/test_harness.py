"""The harness's arithmetic and contract on the CPU: the union of device
intervals, the FLOP counter, the attention bound and its
call count, the comparison numbers, the import rule, the entry point
without a card, and the manifest's files."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import flops, harness, run, trace
from portbench.reference import compare
from portbench.tests import helpers

PKG = os.path.join(helpers.ROOT, "portbench")


def test_union_counts_overlap_once():
    total, merged = trace.union_length([(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)])
    assert total == 12 + 10 + 1
    assert merged == [[0, 12], [20, 30], [40, 41]]
    assert trace.union_length([])[0] == 0


def test_encoder_flops_by_hand():
    # one block over [2, 3, 4]: dense 2·6·4·4·12 = 2304, attention 4·2·9·4 = 288
    assert flops.encoder(2, 3, 4, depth=1) == 2304 + 288
    assert flops.encoder(2, 3, 4, depth=5) == 5 * (2304 + 288)


def test_gan_epoch_is_two_description_passes():
    cfg = helpers.load(os.path.join(PKG, "configs", "m3ae-small.json"))
    zc = helpers.load(os.path.join(PKG, "traffic", "gan-epochs.json"))["zsl"]
    # two B2·N321 passes of the depth-12, 384-wide encoder (62.1 GFLOP), three
    # Extractor passes over 512 pairs of 50 neighbours (14.0), the head on 512
    # rows four times over and the critic: ~78.1 GFLOP
    assert flops.encoder(2, 321, 384, 12) == pytest.approx(3.11e10, rel=0.01)
    assert flops.gan_epoch(cfg, zc) == pytest.approx(7.81e10, rel=0.01)


SMALL = dict(emb_dim=8, depth=1, description_tokens=3, gcn_dim=4, noise_dim=2, max_neighbor=5,
             n_rel=5, n_unseen=2, test_sample=7)


def test_gan_epoch_flops_by_formula():
    d, g, h, k, labels, rela, rows = 8, 4, 2, 5, 3, 2, 6
    text = 2 * rela * 4 * d * d * 12 + 4 * rela * 4 * 4 * d          # one block over N 1 + 3
    head = 2 * rows * (d + 2) * d + 2 * rows * d * g + 2 * rows * g * g
    ext = (4 * 2 * rows * k * g * h + 4 * 2 * rows * g * h + 2 * 2 * rows * 4 * h * g
           + 2 * (2 * rows * g * 2 * g + 2 * rows * 2 * g * g) + 2 * rows * g)
    crit = 2 * rows * g * g + 2 * labels * g * g + 2 * rows * g + 2 * rows * g * labels
    d_step = text + head + 2 * ext + 3 * 3 * crit + 2 * 3 * crit
    g_step = text + 3 * head + ext + crit + 2 * crit
    assert flops.gan_epoch(SMALL, dict(G_batch_size=3, gan_batch_rela=rela)) == d_step + g_step


def test_serving_encodes_one_description_per_unseen_relation():
    cfg = dict(SMALL, image_size=8, patch_size=4, text_tokens=2, num_bases=2, n_ent=9)
    more = dict(cfg, test_sample=cfg["test_sample"] + 10)
    # the text pass does not grow with the generated rows; the head does
    head_rows = 2 * 10 * ((8 + 2) * 8 + 8 * 4 + 4 * 4)
    assert (flops.serve_round(more, 3, 4) - flops.serve_round(cfg, 3, 4)
            == cfg["n_unseen"] * head_rows)
    one = flops.encoder(1, 1 + 3, 8, 1) + flops.generator_head(cfg, 7)
    no_unseen = flops.serve_round(dict(cfg, n_unseen=0), 3, 4)
    assert flops.serve_round(cfg, 3, 4) - no_unseen == 2 * one


def test_attention_bound_picks_the_larger_term():
    # huge entity shape B512 H16 N321 hd80 in float32: bytes bound ~1.0 ms
    b = flops.attention_bound_s(512, 16, 321, 80, "float32", True)
    assert b == pytest.approx(4 * 512 * 16 * 321 * 80 * 4 / 3.35e12 + 4 * 512 * 321 / 3.35e12)
    assert 0.9e-3 < b < 1.1e-3
    # a long sequence is bound by its operations
    ops = 4.0 * 1 * 1 * 8192 ** 2 * 128
    assert flops.attention_bound_s(1, 1, 8192, 128, "bfloat16", False) == ops / 989e12


def test_attention_calls_match_the_kernel_launch_count():
    """A traced serving round's entry calls: one per encoder block per
    batch (entities, relations, each unseen relation's generation), the
    count the card's ``LAUNCHES`` gives for the round."""
    from portbench import attention

    manifest, entry, cfg, traffic, limits = helpers.files("huge-serve")
    ctx = harness.Context(cell="t", config=cfg, traffic=traffic, limits=limits, seed=1,
                          seconds=0.1, trace=True, device="cpu", work_dir=harness.work_dir())
    calls = attention.install(ctx)
    try:
        from portbench.jobs import serve

        window, _ = serve.run(ctx)
    finally:
        from mre_tpu_torch.models import transformer
        from mre_tpu_torch.ops import attention as program_attention

        transformer.fused_attention = program_attention.fused_attention
    per_round = cfg["depth"] * (-(-cfg["n_ent"] // traffic["entity_batch"])
                                + -(-cfg["n_rel"] // traffic["relation_batch"]) + cfg["n_unseen"])
    assert len(calls) == per_round
    assert all(c[4] == "float32" for c in calls)


def test_norm_gap_and_moved_elements():
    ref = {"a": torch.ones(4), "b": torch.full((4,), 2.0), "c": torch.zeros(4)}
    prog = {"a": torch.ones(4), "b": torch.full((4,), 2.2)}
    gap, leaf = compare.norm_gap(prog, ref)
    assert leaf == "b" and gap == pytest.approx(0.1)
    gap, leaf = compare.norm_gap({}, {"a": torch.ones(4)})
    assert gap == pytest.approx(1.0)
    m = compare.moved({"a": torch.tensor([1.0, 1e-9]), "b": torch.ones(2), "c": torch.zeros(2)})
    assert set(m) == {"a", "b"} and m["a"].tolist() == [True, False]


def test_rank_slack():
    scores = [(0.5, np.array([0.9, 0.1, 0.5 + 1e-7]))]
    ids = [0]
    cands = [np.array([1, 2, 3])]
    # reference rank with ties counted: 1 + 2 = 3; 2 is within 1e-7
    assert compare.rank_slack([3], scores, ids, cands) == 0.0
    assert compare.rank_slack([2], scores, ids, cands) == pytest.approx(1e-7)
    assert compare.rank_slack([4], scores, ids, cands) == pytest.approx(0.4)
    # a candidate of the true tail's id always counts
    assert compare.rank_slack([1], [(0.5, np.array([0.1]))], [7], [np.array([7])]) == np.inf


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["mre_tpu_torch", "mre_tpu_torch.ops", "numpy"]) == []
    assert harness.forbidden_modules(["mre_tpu.data", "jaxlib.xla", "flax"]) == [
        "flax", "jaxlib", "mre_tpu"]
    assert harness.forbidden_modules(["jax_like", "flaxen"]) == []


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_and_the_reference_no_program():
    for base, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                found = _imports(os.path.join(base, n)) & set(harness.FORBIDDEN)
                assert not found, (n, found)
    for n in os.listdir(os.path.join(PKG, "reference")):
        if n.endswith(".py"):
            assert "mre_tpu_torch" not in _imports(os.path.join(PKG, "reference", n)), n


def test_a_run_loads_no_jax():
    """Every module a run imports, the program's included, leaves no
    forbidden top-level name in ``sys.modules``."""
    code = ("import sys; import portbench.run, portbench.jobs.train, portbench.jobs.serve, "
            "portbench.jobs.gan, portbench.attention; "
            "import mre_tpu_torch.train.fusion, mre_tpu_torch.zsl.module, "
            "mre_tpu_torch.data.loaders, mre_tpu_torch.data.kg, mre_tpu_torch.data.multimodal; "
            "from portbench.harness import forbidden_modules; print(forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=helpers.ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=helpers.ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "small-train-cached",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=helpers.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_finds_a_file_for_everything():
    m = helpers.load(os.path.join(helpers.ROOT, "BENCHMARK.json"))
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    for c in m["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(os.path.join(helpers.ROOT, c["file"]))
        cfg = helpers.load(os.path.join(helpers.ROOT, c["file"]))
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in m["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        run.cell_files(w["name"], helpers.ROOT)
        assert os.path.exists(os.path.join(PKG, "jobs", helpers.load(os.path.join(
            PKG, "traffic", f"{w['traffic']}.json"))["job"] + ".py"))
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"])
        assert os.path.exists(os.path.join(PKG, "metrics", f"{x['name']}.py")), x["name"]
    assert all(x["source"] in ("host_clock", "device_trace") for x in m["end_to_end"])
    e2e = {x["name"] for x in m["end_to_end"]}
    assert all(x["moves"] in e2e for x in m["per_layer"])
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(m)) < 64 * 1024
