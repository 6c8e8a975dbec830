"""Where a unit of work spends its time, by the program's own spans: one
``torch.profiler`` session over a training epoch, a serving round or a
GAN call, with the program's tracing (``core/profiling.py``) on over the
profiled part, reduced by span.

    python3 -m mre_tpu_torch.tools.span_profile \\
        --config portbench/configs/m3ae-small.json \\
        --traffic portbench/traffic/fusion-epoch-cached.json \\
        [--seed N] [--device cuda] [--out FILE]

``--config`` and ``--traffic`` are the benchmark's files of a cell, so a
reading here is one of that cell's work: the dataset is written from the
seed by ``data/fixtures.py`` at the configuration's sizes, the model keeps
the program's own initialisation, and the traffic's ``job`` (``train``,
``serve`` or ``gan``) picks the driver. The profiled part starts after
``profile_after`` units (steps, rounds or epochs) and holds
``profiled_steps`` / one round / ``profiled_epochs``; the session profiles
all threads (``--threads driver``: the driving thread only), so the
producer thread's spans sit on the device clock too.

The JSON it writes (and prints) holds, per unit of the profiled part:

* ``readings``: the named numbers a later change starts from —
  ``wait_batch_ms``, ``put_ms``, ``h2d_mb``, ``draw_ms``,
  ``step_idle_ms`` and ``host_syncs`` for training; ``put_ms`` and
  ``encoded_share`` for the serving round and the GAN epoch;
* ``host``: ``snapshot()`` of the profiled part per (span, enclosing span,
  window thread or not): ms and count per unit, ``h2d.bytes`` as MB per
  unit, and ``encoded_share``, the rows ``FusionTrainer.generate``'s text
  pass encoded over the rows asked of it (``zsl.generate.encoded`` /
  ``zsl.generate.rows``; absent where nothing called it);
* ``device``: from the trace, on the window thread — each idle gap named
  by the innermost span there, device idle and host time inside each
  span, the CUDA runtime synchronisations starting inside each span and
  the innermost op that called each (and those of other threads);
* ``device.clock``: whether the trace's host and device clocks agree —
  kernels launched inside a span that start before it (each listed with
  its span, thread and offsets, once by the runtime call that launched it
  and once by the CPU op the trace links it to); spans that end in a
  synchronisation but whose kernels end after them; how far the device
  clock reads early (a kernel before its own launch) or late (a kernel
  after the synchronisation that waited for it), and how much idle per
  unit a shift by that much would move to another span's name.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from mre_tpu_torch.core import profiling

WINDOW = "span_profile.window"
PREFIXES = ("fusion.", "zsl.", "data.", "m3ae.", "rgcn.", "attention.")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
N_EXAMPLES = 40

Ev = collections.namedtuple("Ev", "name start end thread corr linked device")


# -- the profiled part --------------------------------------------------------

class Window:
    """The profiled part: ``open()`` and ``close(units)`` are called from
    the driver's hooks, on the thread that drives the program; each waits
    for the device first."""

    def __init__(self, device: str):
        self.device = device
        self.rf = None
        self.units = 0
        self.snap = None
        self.thread = None
        self.seconds = 0.0

    def _sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def open(self):
        self._sync()
        profiling.reset()
        profiling.enable()
        self.thread = threading.get_ident()
        self.rf = torch.profiler.record_function(WINDOW)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def close(self, units: int):
        self._sync()
        self.seconds = time.perf_counter() - self.t0
        self.rf.__exit__(None, None, None)
        profiling.disable()
        self.snap = profiling.snapshot()
        self.units = units
        self.rf = None


class _Done(Exception):
    pass


def _build(config: dict, traffic: dict, seed: int, device: str, path: str):
    from mre_tpu_torch.data.fixtures import write_zsl_dataset
    from mre_tpu_torch.data.kg import TripleTable
    from mre_tpu_torch.data.loaders import load_zsl_dataset
    from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
    from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer

    c = config
    write_zsl_dataset(path, n_ent=c["n_ent"], n_rel=c["n_rel"], n_unseen=c["n_unseen"],
                      triples_per_rel=c["triples_per_rel"], image_ratio=c["image_ratio"],
                      n_candidates=c["n_candidates"], image_size=c["image_px"], seed=seed)
    data = load_zsl_dataset(path, mode="train")
    store = MultimodalStore(data["mm_info"], data["rel_des"], MultimodalPipelineConfig(
        image_size=c["image_size"], vocab_size=c["vocab_size"],
        tokenizer_max_length=c["text_tokens"],
        unpaired_tokenizer_max_length=c["description_tokens"], seed=seed))
    table = TripleTable.build(np.asarray(data["triples"]).T, len(data["e2id"]), len(data["r2id"]))
    trainer = FusionTrainer(table, store, FusionConfig(
        model_type=c["model_type"], emb_dim=c["gcn_dim"], noise_dim=c["noise_dim"],
        patch_size=c["patch_size"], seed=seed, compute_dtype=c["dtype"],
        attention_impl=c["attention_impl"], **traffic.get("fusion", {})), device=device)
    return data, trainer


def _zsl(config: dict, traffic: dict, seed: int, device: str, path: str, data: dict):
    from mre_tpu_torch.zsl.module import ZSLConfig, ZSLModule

    c = config
    return ZSLModule(path, data["r2id"], data["e2id"], ZSLConfig(
        emb_dim=c["gcn_dim"], noise_dim=c["noise_dim"], test_sample=c["test_sample"],
        max_neighbor=c["max_neighbor"], pretrain_times=c["pretrain_times"],
        seed=seed % (2 ** 31), **traffic.get("zsl", {})), device=device)


def drive_train(trainer, win: Window, first: int, k: int):
    """``train_epoch`` with the window over steps ``first + 1 .. first + k``."""
    steps = 0

    def on_step(info):
        nonlocal steps
        steps += 1
        if steps == first:
            win.open()
        elif steps == first + k:
            win.close(k)
            raise _Done

    while True:
        try:
            trainer.train_epoch(on_step=on_step)
        except _Done:
            return


def serve_round(trainer, zsl, traffic: dict):
    ent = trainer.generate_ent_embeddings(batch_size=traffic.get("entity_batch", 512))
    rel = trainer.generate_rel_embeddings(batch_size=traffic.get("relation_batch", 64))
    zsl.update_embed(ent, rel)
    zsl.evaluate(trainer, verbose=False, eval_path=traffic.get("eval_path", "rel_shared"),
                 query_chunk=traffic.get("query_chunk", 64))


def drive_gan(trainer, zsl, win: Window, first: int, k: int):
    """One ``train_gan`` call with the window over epochs ``first + 1 ..
    first + k`` (from the D batch of the first to the end of the last G
    step)."""
    batches, g_steps = 0, 0
    per_epoch = zsl.cfg.D_epoch + zsl.cfg.G_epoch
    batch, g_step = zsl._padded_gan_batch, zsl.g_step

    def hooked_batch():
        nonlocal batches
        if batches == first * per_epoch:
            win.open()
        batches += 1
        return batch()

    def hooked_g_step(*a, **kw):
        nonlocal g_steps
        info = g_step(*a, **kw)
        g_steps += 1
        if g_steps == (first + k) * zsl.cfg.G_epoch:
            win.close(k)
        return info

    zsl._padded_gan_batch, zsl.g_step = hooked_batch, hooked_g_step
    try:
        zsl.train_gan(trainer, train_times=first + k, skip_pretrain=True, skip_centroids=True)
    finally:
        del zsl._padded_gan_batch, zsl.g_step


def profile_cell(config: dict, traffic: dict, seed: int, device: str,
                 all_threads: bool = True) -> dict:
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    job = traffic["job"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    win = Window(device)
    with tempfile.TemporaryDirectory() as path:
        data, trainer = _build(config, traffic, seed, device, path)
        zsl = None if job == "train" else _zsl(config, traffic, seed, device, path, data)
        if job == "gan":
            gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
            zsl.update_embed(
                0.5 * torch.randn(config["n_ent"], config["gcn_dim"], generator=gen, device=device),
                0.5 * torch.randn(config["n_rel"], config["gcn_dim"], generator=gen, device=device))
            zsl.compute_centroids()
            zsl.train_gan(trainer, train_times=2, skip_pretrain=True, skip_centroids=True)
        elif job == "serve":
            for _ in range(max(traffic.get("profile_after", 2) - 1, 1)):
                serve_round(trainer, zsl, traffic)
        session = profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=all_threads))
        with session:
            if job == "train":
                drive_train(trainer, win, traffic.get("profile_after", 10),
                            traffic.get("profiled_steps", 8))
            elif job == "serve":
                win.open()
                serve_round(trainer, zsl, traffic)
                win.close(1)
            elif job == "gan":
                drive_gan(trainer, zsl, win, traffic.get("profile_after", 10),
                          traffic.get("profiled_epochs", 3))
            else:
                raise ValueError(f"unknown job {job!r}")
        events = events_of(session.profiler.kineto_results.events())
    out = {"job": job, "units": win.units, "window_s": win.seconds,
           "host": host_readings(win.snap, win.units, win.thread),
           "device": reduce(events, win.units)}
    out["readings"] = readings(job, out)
    return out


# -- the reduction ----------------------------------------------------------------

def events_of(kineto_events) -> list:
    """The profiler's events as ``Ev`` tuples (device events without the
    profiler's annotations and buffers)."""
    from torch.autograd import DeviceType

    out = []
    for e in kineto_events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() <= 0 or e.is_user_annotation() or name.startswith("Activity Buffer"):
                continue
            out.append(Ev(name, e.start_ns(), e.start_ns() + e.duration_ns(), None,
                          e.correlation_id(), e.linked_correlation_id(), True))
        else:
            out.append(Ev(name, e.start_ns(), e.end_ns(), e.start_thread_id(),
                          e.correlation_id(), e.linked_correlation_id(), False))
    return out


def _is_sync(name: str) -> bool:
    return name in SYNCS or name.endswith("Synchronize")


def _busy(merged, starts, a, b) -> int:
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    t = 0
    while i < len(merged) and merged[i][0] < b:
        t += max(0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return t


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _holding(t, among) -> list:
    return [e for e in among if e.start <= t <= e.end]


def _gaps(merged, w0, w1, main) -> collections.Counter:
    """Idle seconds of the window, each gap named by the innermost span on
    the window thread at its middle."""
    gaps = collections.Counter()
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, w0), min(b, w1)
        if b > a:
            held = _holding((a + b) / 2, main)
            name = min(held, key=lambda e: e.end - e.start).name if held else "outside_spans"
            gaps[name] += (b - a) / 1e9
    return gaps


def reduce(events: list, units: int) -> dict:
    """The trace of the profiled part by the program's spans (see the
    module's doc); ``units`` divides every per-unit number."""
    win = [e for e in events if not e.device and e.name == WINDOW]
    if not win or units <= 0:
        return {"error": "no profiled part in the trace"}
    w0, w1, thread = win[0].start, win[0].end, win[0].thread
    dev = sorted(e for e in events if e.device)
    cpu = [e for e in events if not e.device and e.name != WINDOW]
    spans = sorted((e for e in cpu if e.name.startswith(PREFIXES) and w0 <= e.start <= w1),
                   key=lambda e: e.start)
    main = [e for e in spans if e.thread == thread]
    runtime = sorted((e for e in cpu if e.name.startswith("cuda") and w0 <= e.start <= w1),
                     key=lambda e: e.start)
    ops = sorted((e for e in cpu if e.thread == thread and not e.name.startswith("cuda")
                  and not e.name.startswith(PREFIXES)), key=lambda e: e.start)
    op_starts = [e.start for e in ops]
    merged = _union([(e.start, e.end) for e in dev])
    starts = [m[0] for m in merged]
    busy = sum(min(e, w1) - max(s, w0) for s, e in merged if e > w0 and s < w1)

    def innermost_op(t):
        i = bisect.bisect_right(op_starts, t)
        best = None
        for o in ops[max(0, i - 400):i]:
            if o.end >= t and (best is None or o.end - o.start < best.end - best.start):
                best = o
        return best.name if best else "none"

    gaps = _gaps(merged, w0, w1, main)
    # per span on the window thread: host time, device idle inside, count
    host_ms, idle_ms, n = collections.Counter(), collections.Counter(), collections.Counter()
    for e in main:
        host_ms[e.name] += (e.end - e.start) / 1e6 / units
        idle_ms[e.name] += ((e.end - e.start) - _busy(merged, starts, e.start, e.end)) / 1e6 / units
        n[e.name] += 1 / units
    other = collections.Counter()
    for e in spans:
        if e.thread != thread:
            other[e.name] += (e.end - e.start) / 1e6 / units
    # runtime synchronisations on the window thread, by every span holding them
    syncs, sync_ops = collections.defaultdict(collections.Counter), collections.Counter()
    other_syncs = collections.Counter()
    for r in runtime:
        if not _is_sync(r.name):
            continue
        if r.thread != thread:
            other_syncs[r.name] += 1 / units
            continue
        held = _holding(r.start, main)
        for e in held:
            syncs[e.name][r.name] += 1 / units
        if held:
            inner = min(held, key=lambda e: e.end - e.start).name
            sync_ops[f"{inner} <- {innermost_op(r.start)}"] += 1 / units
    # the idle that a shift of the device clock by the skew seen would relabel
    clk = clock(dev, cpu, main, runtime, thread)
    skew = clk["launch"]
    for key, shift in (("device_early", skew["device_early_ns"]),
                       ("device_late", -skew["device_late_ns"])):
        moved = _gaps(_union([(e.start + shift, e.end + shift) for e in dev]), w0, w1, main)
        skew[f"relabel_ms_{key}"] = sum(abs(moved[k] - gaps[k]) for k in set(moved) | set(gaps)
                                        ) / 2 * 1e3 / units
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "idle_share": 100.0 * (1 - busy / (w1 - w0)) if w1 > w0 else None,
            "idle_gaps_s": dict(gaps.most_common()),
            "idle_ms": dict(idle_ms.most_common()), "host_ms": dict(host_ms.most_common()),
            "spans": dict(n.most_common()), "other_threads_host_ms": dict(other.most_common()),
            "syncs": {k: dict(v) for k, v in sorted(syncs.items())},
            "sync_callers": dict(sync_ops.most_common()),
            "other_threads_syncs": dict(other_syncs),
            "clock": clk}


def clock(dev: list, cpu: list, main: list, runtime: list, thread) -> dict:
    """Kernels launched inside a span on the window thread that start
    before it, by two attributions: the runtime call of the kernel's own
    correlation id, and the CPU op the trace links it to (as the
    benchmark's reduction does). And spans whose last runtime call is a
    synchronisation that a kernel launched inside them outlives."""
    launch = {r.corr: r for r in runtime}
    op = {e.corr: e for e in cpu if e.linked == 0}
    rt_starts = [r.start for r in runtime]
    out = {}
    for how, find in (("launch", lambda k: launch.get(k.corr)),
                      ("linked_op", lambda k: op.get(k.linked))):
        launched = sorted(((f.start, k) for k in dev
                           if (f := find(k)) is not None and f.thread == thread),
                          key=lambda x: x[0])
        at = [t for t, _ in launched]
        checked, early, examples = 0, 0, []
        ending, late, late_ns, late_examples = 0, 0, 0, []
        for s in main:
            mine = launched[bisect.bisect_left(at, s.start):bisect.bisect_right(at, s.end)]
            checked += len(mine)
            for t, k in mine:
                if k.start >= s.start:
                    continue
                early += 1
                if len(examples) < N_EXAMPLES:
                    r, o = launch.get(k.corr), op.get(k.linked)
                    examples.append({
                        "span": s.name, "kernel": k.name[:80], "thread": thread,
                        "kernel_before_span_ns": s.start - k.start,
                        "by_after_span_start_ns": t - s.start,
                        "launch": r.name if r else None,
                        "launch_after_span_start_ns": r.start - s.start if r else None,
                        "launch_thread": r.thread if r else None,
                        "op": o.name if o else None,
                        "op_after_span_start_ns": o.start - s.start if o else None})
            if how != "launch" or not mine:
                continue
            # the span's last runtime call on the window thread
            j = bisect.bisect_right(rt_starts, s.end) - 1
            while j >= 0 and rt_starts[j] >= s.start and (
                    runtime[j].thread != thread or runtime[j].end > s.end):
                j -= 1
            if j >= 0 and rt_starts[j] >= s.start and _is_sync(runtime[j].name):
                ending += 1
                last = max(k.end for _, k in mine)
                if last > s.end:
                    late += 1
                    late_ns = max(late_ns, last - s.end)
                    if len(late_examples) < N_EXAMPLES:
                        late_examples.append({"span": s.name, "sync": runtime[j].name,
                                              "kernel_after_span_ns": last - s.end})
        out[how] = {"kernels_checked": checked, "kernels_before_span": early,
                    "examples": examples}
        if how == "launch":
            # a kernel cannot start before the call that launched it, nor end
            # after the synchronisation that waited for it: either, read off the
            # trace, bounds how far the device clock stands from the host's
            lead = [launch[k.corr].start - k.start for k in dev if k.corr in launch]
            out[how].update(spans_ending_in_sync=ending, kernels_after_sync_end=late,
                            late_examples=late_examples,
                            kernels_before_their_launch=sum(x > 0 for x in lead),
                            device_early_ns=max([0] + lead),
                            device_late_ns=late_ns)
    return out


def host_readings(snap: dict | None, units: int, thread) -> dict:
    """``snapshot()`` per unit: ms and count per "name<parent" on the
    window thread (``main``) and on every other thread (``other``)."""
    if not snap or units <= 0:
        return {}
    out = {"main": {}, "other": {}}
    for (name, parent, t), (n, ns) in snap["spans"].items():
        side = out["main" if t == thread else "other"]
        row = side.setdefault(f"{name}<{parent}", {"ms": 0.0, "count": 0.0})
        row["ms"] += ns / 1e6 / units
        row["count"] += n / units
    out["h2d_mb"] = snap["counts"].get("h2d.bytes", 0) / 1e6 / units
    rows = snap["counts"].get("zsl.generate.rows", 0)
    if rows:                    # the description pass's engagement
        out["encoded_share"] = snap["counts"].get("zsl.generate.encoded", 0) / rows
    out["threads"] = len({t for (_, _, t) in snap["spans"]})
    return out


def readings(job: str, out: dict) -> dict:
    host, device = out["host"], out["device"]
    if not host:
        return {}

    def ms(name, side=None):
        sides = [side] if side else ["main", "other"]
        return sum(r["ms"] for s in sides for k, r in host[s].items()
                   if k.split("<")[0] == name)

    got = {"put_ms": ms("fusion.put") + ms("zsl.put")}
    if "encoded_share" in host:
        got["encoded_share"] = host["encoded_share"]
    if job == "train":
        got.update(wait_batch_ms=ms("fusion.wait_batch", "main"),
                   put_ms=ms("fusion.put", "other"), h2d_mb=host["h2d_mb"],
                   draw_ms=ms("fusion.draw", "main"),
                   step_idle_ms=device.get("idle_ms", {}).get("fusion.step"),
                   host_syncs=sum(device.get("syncs", {}).get("fusion.step", {}).values()))
    return got


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--traffic", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="")
    parser.add_argument("--threads", choices=("all", "driver"), default="all",
                        help="profile every thread, or the driving thread only (as a "
                             "session started mid-epoch sees the trainer)")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    with open(args.traffic) as f:
        traffic = json.load(f)
    t = time.perf_counter()
    out = profile_cell(config, traffic, args.seed, args.device, args.threads == "all")
    out.update(config=os.path.basename(args.config), traffic=os.path.basename(args.traffic),
               seed=args.seed, threads=args.threads, wall_s=time.perf_counter() - t)
    if args.device != "cpu":
        out["card"] = torch.cuda.get_device_name()
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(json.dumps({k: out[k] for k in ("job", "units", "window_s", "readings")}))
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
