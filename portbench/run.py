"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell names
a configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``job`` names the module
``portbench/jobs/<job>.py``); its limits are ``portbench/limits/<cell>.json``
and each metric is read by ``portbench/metrics/<metric>.py``. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, from a device trace of a steady part
of the window. Without enough cards it prints no result and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(cell: str, root: str = ROOT) -> tuple[dict, dict, dict, dict, dict]:
    """(manifest, cell entry, configuration, traffic, limits) of a cell."""
    manifest = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in manifest["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return (manifest, entry, _json(os.path.join(root, conf["file"])),
            _json(os.path.join(PKG, "traffic", f"{entry['traffic']}.json")),
            _json(os.path.join(PKG, "limits", f"{cell}.json")))


def reader(name: str):
    path = os.path.join(PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(manifest: dict, cell: str, trace: bool) -> list:
    """The cell's (name, unit) metrics of the run's kind."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [(m["name"], m["unit"]) for m in group if cell in m.get("workloads", [cell])]


class Run:
    """What the readers read: the window, the spans, the trace summary and
    the attention entry's calls inside the traced part."""

    def __init__(self, ctx, window, attention_calls):
        self.ctx, self.window = ctx, window
        self.spans = ctx.spans
        self.summary = ctx.profile.summary if ctx.profile is not None else None
        self.attention_calls = attention_calls


def measure(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            root: str = ROOT, files=None) -> dict:
    """One run of ``cell``: the result line as a dict, its checks last."""
    from portbench import attention, harness

    manifest, entry, config, traffic, limits = files or cell_files(cell, root)
    ctx = harness.Context(cell=cell, config=config, traffic=traffic, limits=limits, seed=seed,
                          seconds=seconds, trace=trace, device=device, t_start=T_START,
                          work_dir=harness.work_dir())
    calls = attention.install(ctx) if trace else []
    try:
        job = importlib.import_module(f"portbench.jobs.{traffic['job']}")
        window, rec = job.run(ctx)
        found = harness.forbidden_modules()
        if found:
            raise ForbiddenImport(found)
        with harness.with_tf32(False):
            numbers, notes = job.numbers(ctx, rec)
    finally:
        shutil.rmtree(ctx.work_dir, ignore_errors=True)
    checks = harness.checks_from(numbers, limits)
    run = Run(ctx, window, calls)
    metrics = {}
    for name, unit in metrics_of(manifest, cell, trace):
        value = reader(name)(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}
    out = {"correct": harness.correct(checks), "attempted": window.units, "failed": 0,
           "metrics": metrics, "device": _device(ctx, window, entry["chips"])}
    if trace and run.summary is not None:
        out["device"].update(busy_s=run.summary.busy_s, window_s=run.summary.window_s)
        out["breakdown"] = ctx.profile.breakdown()
    u = sorted(window.unit_s)
    out["notes"] = dict(notes, **window.notes, unit_s=window.unit_s if len(u) <= 24 else
                        [u[0], u[len(u) // 2], u[-1]])
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return out


class ForbiddenImport(RuntimeError):
    pass


def _device(ctx, window, chips: int) -> dict:
    if ctx.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": window.peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    files = cell_files(args.workload)
    import torch

    chips = files[1]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        out = measure(args.workload, args.seed, args.seconds, bool(args.trace), files=files)
    except ForbiddenImport as e:
        print(f"portbench: the run loaded {e.args[0]}, which the benchmark may not load",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
