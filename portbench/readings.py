"""The readings that the limits of ``correct`` are set from, at a cell's
own size on the card: for each seed, the program's numbers (a short window
and the check, as a run makes them) and the control's, the reference put
in the program's place and run in TF32, the precision below the
configuration's float32, held against the float32 reference.

    python3 -m portbench.readings --workload <cell> --seconds <s> --seeds <n> [<n> ...]

prints one JSON line per seed (lines the program prints come between).
The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import shutil
import sys

from portbench import faults, harness, run


def readings(cell: str, seed: int, seconds: float, device: str = "cuda", files=None,
             overrides: dict | None = None, fault: str | None = None) -> dict:
    """One seed's readings; with ``fault`` (a name in ``faults.FAULTS``)
    the program runs with that fault planted and no control is run."""
    manifest, entry, config, traffic, limits = files or run.cell_files(cell)
    config = dict(config, **(overrides or {}))
    ctx = harness.Context(cell=cell, config=config, traffic=traffic, limits=limits, seed=seed,
                          seconds=seconds, trace=False, device=device,
                          work_dir=harness.work_dir())
    job = importlib.import_module(f"portbench.jobs.{traffic['job']}")
    try:
        with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
            _, rec = job.run(ctx)
        with harness.with_tf32(False):
            program, notes = job.numbers(ctx, rec)
        if fault:
            return dict(cell=cell, seed=seed, fault=fault, program=program, notes=notes)
        with harness.with_tf32(True):
            ctl = job.control(ctx, rec)
        with harness.with_tf32(False):
            control, control_notes = job.numbers(ctx, ctl)
    finally:
        shutil.rmtree(ctx.work_dir, ignore_errors=True)
    return dict(cell=cell, seed=seed, program=program, control=control, limits=limits,
                notes=notes, control_notes=control_notes, overrides=overrides or {})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=JSON",
                    help="configuration values to override, e.g. attention_impl='\"torch\"'")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    overrides = {k: json.loads(v) for k, v in (a.split("=", 1) for a in args.set)}
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, overrides=overrides,
                                  fault=args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
