"""``tools/span_profile.py``: one profiler session over a unit of work,
reduced by the program's spans. On the CPU at a tiny size each job runs
and reads its host numbers; the reduction's device side (idle gaps by
the innermost span, idle and synchronisations inside spans, the clock
check by both attributions) is checked on a synthetic event list."""

from __future__ import annotations

import json

import pytest

from mre_tpu_torch.core import profiling
from mre_tpu_torch.tools import span_profile as sp

TINY = {"model_type": "tiny", "image_size": 16, "patch_size": 8, "text_tokens": 6,
        "description_tokens": 10, "vocab_size": 100, "gcn_dim": 12, "noise_dim": 4,
        "dtype": "float32", "attention_impl": "auto", "n_ent": 30, "n_rel": 6, "n_unseen": 2,
        "triples_per_rel": 12, "n_candidates": 22, "image_ratio": 0.7, "image_px": 8,
        "test_sample": 4, "max_neighbor": 10, "pretrain_times": 0}
TRAFFIC = {
    "train": {"job": "train", "fusion": {"batch_size": 4, "sample_size": 2, "neg_ent": 2,
                                          "image_mask_ratio": 0.5, "text_mask_ratio": 0.5},
              "profile_after": 2, "profiled_steps": 3},
    "serve": {"job": "serve", "entity_batch": 16, "relation_batch": 4, "query_chunk": 8,
              "profile_after": 2},
    "gan": {"job": "gan", "zsl": {"G_batch_size": 8, "gan_batch_rela": 2},
            "profile_after": 1, "profiled_epochs": 2},
}


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.mark.parametrize("job", sorted(TRAFFIC))
def test_each_job_reads_its_spans_on_the_cpu(job, tmp_path):
    traffic = TRAFFIC[job]
    out = sp.main(["--config", _write(tmp_path, "c.json", TINY),
                   "--traffic", _write(tmp_path, "t.json", traffic),
                   "--seed", "2418000001", "--device", "cpu",
                   "--out", str(tmp_path / "out" / "spans.json")])
    assert out["threads"] == "all"
    with open(tmp_path / "out" / "spans.json") as f:
        assert json.load(f)["readings"] == out["readings"]
    assert not profiling._on
    units = {"train": 3, "serve": 1, "gan": 2}[job]
    assert out["units"] == units and out["window_s"] > 0
    host, dev, got = out["host"], out["device"], out["readings"]
    assert host["h2d_mb"] > 0 and got["put_ms"] > 0
    assert "error" not in dev and dev["busy_s"] == 0.0          # no device on the CPU
    assert sum(dev["idle_gaps_s"].values()) == pytest.approx(dev["window_s"])
    if job == "train":
        assert set(got) == {"put_ms", "wait_batch_ms", "h2d_mb", "draw_ms", "step_idle_ms",
                            "host_syncs"}
        assert host["main"]["fusion.step<None"]["count"] == 1.0
        assert host["other"]["fusion.prepare_batch<None"]["count"] > 0   # the producer
        assert dev["spans"]["fusion.draw"] == 1.0
        assert dev["other_threads_host_ms"]["fusion.prepare_batch"] > 0  # all threads traced
        assert got["step_idle_ms"] == pytest.approx(dev["host_ms"]["fusion.step"])
    elif job == "serve":
        assert host["main"]["zsl.evaluate<None"]["count"] == 1.0
        assert got["encoded_share"] == host["encoded_share"] == 1 / TINY["test_sample"]
        assert {"fusion.ent_sweep", "zsl.pair_tables", "rgcn.sweep"} <= set(dev["spans"])
    else:
        assert host["main"]["zsl.d_step<None"]["count"] == 1.0
        assert host["main"]["zsl.gan_batch<None"]["count"] == 2.0
        assert dev["spans"]["zsl.generate"] == 2.0
        zc = traffic["zsl"]     # at most one encoded row per relation of a step
        assert 0 < got["encoded_share"] <= zc["gan_batch_rela"] / (zc["gan_batch_rela"]
                                                                   * zc["G_batch_size"])


def _write(tmp_path, name, obj) -> str:
    path = tmp_path / name
    path.write_text(json.dumps(obj))
    return str(path)


def _cpu(name, start, end, thread=1, corr=0, linked=0):
    return sp.Ev(name, start, end, thread, corr, linked, False)


def _kernel(name, start, end, corr, linked):
    return sp.Ev(name, start, end, None, corr, linked, True)


def test_reduction_names_gaps_and_counts_idle_and_syncs():
    ev = [_cpu(sp.WINDOW, 0, 1000),
          _cpu("fusion.step", 100, 900), _cpu("fusion.draw", 100, 300),
          _cpu("fusion.loss", 300, 600), _cpu("attention.fwd", 400, 500),
          _cpu("fusion.put", 150, 250, thread=2),                       # the producer
          _cpu("aten::copy_", 110, 290, corr=7), _cpu("cudaStreamSynchronize", 200, 290),
          _cpu("cudaMemcpyAsync", 120, 130, corr=101, linked=7),
          _cpu("aten::mm", 410, 420, corr=8), _cpu("cudaLaunchKernel", 412, 418, corr=102,
                                                     linked=8),
          _kernel("Memcpy HtoD", 140, 200, corr=101, linked=7),
          _kernel("gemm", 420, 700, corr=102, linked=8)]
    d = sp.reduce(ev, units=2)
    assert d["window_s"] == 1e-6 and d["busy_s"] == pytest.approx(340e-9)
    # each gap takes the innermost span holding its middle
    assert d["idle_gaps_s"] == {"outside_spans": pytest.approx(140e-9),  # 0-140
                                "fusion.loss": pytest.approx(220e-9),    # 200-420
                                "fusion.step": pytest.approx(300e-9)}    # 700-1000
    assert d["idle_ms"]["fusion.step"] == pytest.approx((800 - 340) / 1e6 / 2)
    assert d["host_ms"]["fusion.draw"] == pytest.approx(200 / 1e6 / 2)
    assert d["spans"] == {"fusion.step": 0.5, "fusion.draw": 0.5, "fusion.loss": 0.5,
                          "attention.fwd": 0.5}
    assert d["other_threads_host_ms"] == {"fusion.put": pytest.approx(100 / 1e6 / 2)}
    assert d["syncs"] == {"fusion.step": {"cudaStreamSynchronize": 0.5},
                          "fusion.draw": {"cudaStreamSynchronize": 0.5}}
    assert d["sync_callers"] == {"fusion.draw <- aten::copy_": 0.5}
    c = d["clock"]
    for how in ("launch", "linked_op"):
        assert c[how]["kernels_before_span"] == 0, how
        assert c[how]["kernels_checked"] == 5, how      # copy: step, draw; gemm: step, loss, attn
    # the draw ends in its synchronisation, and its copy ended before it
    assert c["launch"]["spans_ending_in_sync"] == 1
    assert c["launch"]["kernels_after_sync_end"] == 0
    assert c["launch"]["device_early_ns"] == c["launch"]["device_late_ns"] == 0
    assert d["other_threads_syncs"] == {}
    late = sp.reduce(ev[:-2] + [_kernel("Memcpy HtoD", 140, 310, corr=101, linked=7),
                                _cpu("cudaStreamSynchronize", 600, 610, thread=2)], units=1)
    assert late["clock"]["launch"]["kernels_after_sync_end"] == 1    # past the draw's end
    assert late["clock"]["launch"]["device_late_ns"] == 10
    assert late["other_threads_syncs"] == {"cudaStreamSynchronize": 1.0}


def test_clock_check_tells_skew_from_a_wrong_link():
    ev = [_cpu(sp.WINDOW, 0, 1000), _cpu("zsl.d_step", 100, 500),
          _cpu("aten::mm", 50, 60, corr=3), _cpu("aten::add", 200, 210, corr=4),
          _cpu("cudaLaunchKernel", 52, 58, corr=11, linked=3),
          _cpu("cudaLaunchKernel", 202, 208, corr=12, linked=4),
          _kernel("gemm", 60, 90, corr=11, linked=4),       # linked to the wrong op
          _kernel("add", 190, 220, corr=12, linked=4)]      # starts before its own launch
    c = sp.reduce(ev, units=1)["clock"]
    assert c["launch"]["kernels_before_span"] == 0           # gemm launched before the span
    assert c["linked_op"]["kernels_before_span"] == 1
    (ex,) = c["linked_op"]["examples"]
    assert ex["kernel"] == "gemm" and ex["launch_after_span_start_ns"] == -48
    assert ex["kernel_before_span_ns"] == 40 and ex["op_after_span_start_ns"] == 100
    skew = [_cpu(sp.WINDOW, 0, 1000), _cpu("zsl.d_step", 100, 500),
            _cpu("aten::add", 200, 210, corr=4),
            _cpu("cudaLaunchKernel", 202, 208, corr=12, linked=4),
            _kernel("add", 90, 95, corr=12, linked=4)]
    d = sp.reduce(skew, units=1)
    c = d["clock"]
    assert c["launch"]["kernels_before_span"] == c["linked_op"]["kernels_before_span"] == 1
    assert c["launch"]["examples"][0]["launch_after_span_start_ns"] == 102
    # the kernel ran 112 ns before its launch: the device clock reads early
    assert c["launch"]["kernels_before_their_launch"] == 1
    assert c["launch"]["device_early_ns"] == 112 and c["launch"]["device_late_ns"] == 0
    # shifted by 112 ns the first gap's middle falls inside the span: its
    # 202 ns change names
    assert d["idle_gaps_s"] == {"outside_spans": pytest.approx(995e-9)}
    assert c["launch"]["relabel_ms_device_early"] == pytest.approx(202e-6)
    assert c["launch"]["relabel_ms_device_late"] == 0


def test_reduction_without_a_window_or_snapshot_says_so():
    assert sp.reduce([_cpu("fusion.step", 0, 10)], units=1) == {
        "error": "no profiled part in the trace"}
    assert sp.host_readings(None, 1, 1) == {}
    assert sp.readings("train", {"host": {}, "device": {}}) == {}


def test_driver_thread_session_drops_the_producers_spans(tmp_path):
    out = sp.main(["--config", _write(tmp_path, "c.json", TINY),
                   "--traffic", _write(tmp_path, "t.json", TRAFFIC["train"]),
                   "--device", "cpu", "--threads", "driver"])
    assert out["threads"] == "driver"
    assert out["device"]["other_threads_host_ms"] == {}               # not in the trace
    assert out["host"]["other"]["fusion.prepare_batch<None"]["count"] > 0   # but timed
    assert out["device"]["spans"]["fusion.step"] == 1.0
