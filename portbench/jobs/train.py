"""The fusion training step, as a researcher runs it for 200 epochs:
``FusionTrainer.train_epoch`` with its producer thread decoding and
cropping images beside the device step.

Set-up builds one trainer, loads the benchmark's weights, and drives it
through its first ``checked_steps`` steps by ``train_epoch`` itself,
recording what the check needs (each step's subgraph and draws, its loss,
Adam's first moments after step 1, the parameters after the last). The
same trainer then trains in the window, epoch after epoch, until
``--seconds`` have passed. After the window the reference follows the
checked steps.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import flops
from portbench.harness import Window, capture, host_load, host_mark
from portbench.jobs import common
from portbench.reference import compare
from portbench.reference import data as rdata
from portbench.reference import train as rtrain


class _Stop(Exception):
    pass


def run(ctx):
    tr = ctx.traffic
    fus = tr["fusion"]
    path = common.dataset(ctx)
    data, store, trainer, p0 = common.fusion(ctx, path, fus)
    n_check = tr["checked_steps"]

    # -- set-up: the first steps, recorded for the check -----------------------
    graphs, draws, losses, state = [], [], [], {}
    undo = [capture(trainer, "prepare_device_batch", graphs,
                    lambda a, k, out: {key: np.array(v) for key, v in a[0].items()}),
            capture(trainer, "draw", draws,
                    lambda a, k, out: {key: v.detach().clone() for key, v in out.items()})]
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]

    def first_steps(info):
        losses.append(info["loss"].detach().clone())
        if len(losses) == 1:
            state["grads"] = {names[id(p)]: st["exp_avg"].detach() / (1 - beta1)
                              for p, st in trainer.optimizer.state.items()}
        if len(losses) == n_check:
            state["params"] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
            raise _Stop

    try:
        trainer.train_epoch(on_step=first_steps)
    except _Stop:
        pass
    for u in undo:
        u()
    ctx.sync()

    # -- the window -------------------------------------------------------------
    if ctx.trace:
        ctx.spans.wrap(trainer, "prepare_device_batch", "host_batch")
        ctx.spans.wrap(trainer, "step", "step")
    prof = ctx.profile
    first, k_prof = tr["profile_after"], tr["profiled_steps"]
    setup_s = time.perf_counter() - ctx.t_start
    mark = host_mark()
    t0 = time.perf_counter()
    steps = 0

    def window_step(info):
        nonlocal steps
        steps += 1
        if prof is not None and steps == first:
            prof.start()
        elif prof is not None and prof.active and steps == first + k_prof:
            prof.stop(k_prof)
        if time.perf_counter() - t0 >= ctx.seconds and (prof is None or prof.done):
            raise _Stop

    while True:
        try:
            trainer.train_epoch(on_step=window_step)
        except _Stop:
            break
    ctx.sync()
    seconds = time.perf_counter() - t0
    host = host_load(mark, host_mark())
    peak = common.peak_bytes(ctx)
    spe = trainer.steps_per_epoch
    del trainer, store
    common.free(ctx)

    rec = dict(path=path, p0=p0, graphs=graphs[:n_check], draws=draws[:n_check],
               losses=[float(x) for x in losses], state=state, steps_per_epoch=spe)
    return Window(units=steps, seconds=seconds, unit_s=[], setup_s=setup_s,
                  flops_per_unit=flops.train_step(ctx.config, fus), peak=peak, notes=host), rec


def numbers(ctx, rec: dict) -> tuple[dict, dict]:
    """(compared numbers, notes) of the checked steps against the
    reference, which runs in the precision the caller has set."""
    d = rdata.load(rec["path"])
    ref = ctx.reference or rtrain.run(ctx.config, ctx.traffic["fusion"], rec["p0"], d,
                                      rec["graphs"], rec["draws"], ctx.seed,
                                      rec["steps_per_epoch"], ctx.device)
    ctx.reference = ref
    state = rec["state"]
    # compared: the first step's loss, the worst leaf's first gradient and the
    # median leaf's change (PERF.md: the LeakyReLU's and the L1 distance's
    # kinks make the later steps and the worst leaf's change swing with
    # float32 rounding, and move the median leaf's gradient as far as the
    # control does; those numbers are noted beside)
    nums, notes = compare.split(
        compare.training(rec["losses"], state["grads"], state["params"], ref, rec["p0"]),
        ("loss1_gap", "grad_gap", "change_median"))
    return nums, dict(notes, kinks=ref["kinks"])


def control(ctx, rec: dict) -> dict:
    """``rec`` with the program's readings replaced by the reference's, run
    in the precision the caller has set (the control of the check)."""
    r = rtrain.run(ctx.config, ctx.traffic["fusion"], rec["p0"], rdata.load(rec["path"]),
                   rec["graphs"], rec["draws"], ctx.seed, rec["steps_per_epoch"], ctx.device)
    return dict(rec, losses=r["losses"], state=dict(grads=r["grads"], params=r["params"]))
