"""The ZSL adversarial loop, as a ZSL round runs it for 1,000 epochs: one
``ZSLModule.train_gan`` call of critic and generator steps, the relation
descriptions re-encoded by the frozen M3AE text pass inside
``zsl.generate`` at every step.

Set-up builds the trainer (the generator head and the text encoder) and
the ZSL module with the benchmark's weights, refreshes the symbol table
from seeded entity and relation embeddings, computes the centroids and
runs a first ``train_gan`` call of ``checked_epochs`` epochs, recording
what the check needs (each step's batch, noise, α and dropout masks, its
loss, the first D and G moments, the D and G leaves after the call). The
window is one ``train_gan`` call timed in whole log windows: blocks of
``loss_every`` epochs, each ended by the loop's one sync (the log's
``.item()``). The host clock is read at each block's end, where the next
batch is drawn, and the window ends at the first block's end past
``--seconds``; the call's epoch count, four times what ``--seconds`` holds
at the median checked epoch's time, is not reached. The harness adds no
sync inside the window.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from portbench import flops, weights
from portbench.harness import Window, capture, host_load, host_mark
from portbench.jobs import common
from portbench.reference import compare
from portbench.reference import data as rdata
from portbench.reference import gan as rgan


def _record_masks(zsl, log: list):
    """Each dropout-mask object the module makes hands its masks (True
    keeps) to a new list in ``log`` as they are drawn."""
    make = zsl._dropout

    def dropout(draws, rows=None):
        masks = make(draws, rows)
        got: list = []
        log.append(got)
        cut = masks._cut

        def keep(mask):
            got.append(mask.detach().clone())
            return cut(mask)

        masks._cut = keep
        return masks

    zsl._dropout = dropout
    return lambda: zsl.__dict__.pop("_dropout", None)


def run(ctx):
    tr = ctx.traffic
    zc = tr["zsl"]
    c = ctx.config
    path = common.dataset(ctx)
    data, store, trainer, p0 = common.fusion(ctx, path)
    zsl, q0, c0, _ = common.zsl_module(ctx, path, data, zc)
    gen = weights.generator(ctx.seed, ctx.device, 2)
    ent = 0.5 * torch.randn(c["n_ent"], c["gcn_dim"], generator=gen, device=ctx.device)
    rel = 0.5 * torch.randn(c["n_rel"], c["gcn_dim"], generator=gen, device=ctx.device)
    zsl.update_embed(ent, rel)
    zsl.compute_centroids()

    # -- set-up: the checked epochs ---------------------------------------------
    batches, draws, masks, kinds, state, ends = [], [], [], [], {}, []
    undo = [capture(zsl, "_padded_gan_batch", batches, lambda a, k, out: out),
            capture(zsl, "_draw", draws,
                    lambda a, k, out: (a[1] if len(a) > 1 else k["key"], out.detach().clone())),
            _record_masks(zsl, masks)]
    d_names = {id(p): f"D.{n}" for n, p in zsl.discriminator.named_parameters()}
    g_names = {id(p): f"G.{n}" for n, p in trainer.model.named_parameters()}

    def after(kind, opt, names):
        step = getattr(zsl, f"{kind.lower()}_step")

        def hooked(*a, **k):
            info = step(*a, **k)
            kinds.append((kind, info[f"loss_{kind}"].detach().clone()))
            if sum(1 for x, _ in kinds if x == kind) == 1:
                beta1 = getattr(zsl, opt).param_groups[0]["betas"][0]
                state.setdefault("grads", {}).update(
                    {names[id(p)]: s["exp_avg"].detach() / (1 - beta1)
                     for p, s in getattr(zsl, opt).state.items()})
            if kind == "G":
                ctx.sync()
                ends.append(time.perf_counter())
            return info

        zsl.__dict__[f"{kind.lower()}_step"] = hooked
        return lambda: zsl.__dict__.pop(f"{kind.lower()}_step", None)

    undo += [after("D", "opt_D", d_names), after("G", "opt_G", g_names)]
    n_check = tr["checked_epochs"]
    ends.append(time.perf_counter())
    zsl.train_gan(trainer, train_times=n_check, skip_pretrain=True, skip_centroids=True)
    state["params"] = {d_names[id(p)]: p.detach().clone() for p in zsl.discriminator.parameters()}
    state["params"].update({g_names[id(p)]: p.detach().clone() for p in zsl.g_params})
    for u in undo:
        u()
    block = zsl.cfg.loss_every
    epoch_s = statistics.median(b - a for a, b in zip(ends, ends[1:]))

    # -- the window -----------------------------------------------------------------
    prof = ctx.profile
    if ctx.trace:
        ctx.spans.wrap(zsl, "_padded_gan_batch", "gan_batch")
        first, k_prof = tr["profile_after"], tr["profiled_epochs"]
        count = {"D": 0, "G": 0}
        for kind in ("D", "G"):
            ctx.spans.wrap(zsl, f"{kind.lower()}_step", f"{kind.lower()}_step")
            inner = getattr(zsl, f"{kind.lower()}_step")

            def counted(*a, _kind=kind, _inner=inner, **k):
                count[_kind] += 1
                if _kind == "D" and count["D"] == first + 1:
                    prof.start()
                out = _inner(*a, **k)
                if _kind == "G" and prof.active and count["G"] == first + k_prof:
                    prof.stop(k_prof)
                return out

            zsl.__dict__[f"{kind.lower()}_step"] = counted
    # an epoch count the window does not reach: it ends at a block's end
    cap = block * math.ceil(4 * ctx.seconds / epoch_s / block)
    stamps: list = []
    stamp_blocks(zsl, block, stamps, lambda now: now - stamps[0][0] >= ctx.seconds
                 and (prof is None or prof.done))
    setup_s = time.perf_counter() - ctx.t_start
    mark = host_mark()
    stamps.append((time.perf_counter(), time.process_time()))
    try:
        zsl.train_gan(trainer, train_times=cap, skip_pretrain=True, skip_centroids=True)
        ctx.sync()
        stamps.append((time.perf_counter(), time.process_time()))
    except _Stop:
        pass
    host = host_load(mark, host_mark())
    epochs, seconds = block * (len(stamps) - 1), stamps[-1][0] - stamps[0][0]
    laps = list(zip(stamps, stamps[1:]))
    block_s = [(b[0] - a[0]) / block for a, b in laps]
    host.update(checked_epoch_ms=epoch_s * 1e3, epoch_ms_window=seconds / epochs * 1e3,
                epoch_ms_block_median=statistics.median(block_s) * 1e3,
                block_cpu_over_wall=[(b[1] - a[1]) / (b[0] - a[0]) for a, b in laps])
    peak = common.peak_bytes(ctx)
    del trainer, zsl, store
    common.free(ctx)

    steps, di = [], iter(draws)
    for (kind, _), batch, mk in zip(kinds, batches, masks):
        noise = next(di)[1]
        alpha = next(di)[1] if kind == "D" else None
        steps.append(dict(kind=kind, batch=batch, noise=noise, alpha=alpha, masks=mk))
    rec = dict(path=path, p0=p0, q0=q0, c0=c0, ent=ent.cpu().numpy(), rel=rel.cpu().numpy(),
               steps=steps, losses=[float(x) for _, x in kinds], state=state)
    return Window(units=epochs, seconds=seconds, unit_s=block_s, setup_s=setup_s,
                  flops_per_unit=flops.gan_epoch(c, zc), peak=peak, notes=host), rec


class _Stop(Exception):
    pass


def stamp_blocks(zsl, block: int, stamps: list, stop=lambda now: False):
    """Append the host clock and the process's CPU time to ``stamps`` when
    ``train_gan`` draws the first batch after each block of ``block``
    epochs, just after the loop's log sync, and end the call there once
    ``stop(clock)`` holds."""
    draw = zsl._padded_gan_batch
    per_block = block * (zsl.cfg.D_epoch + zsl.cfg.G_epoch)
    calls = 0

    def stamped(*a, **k):
        nonlocal calls
        if calls and calls % per_block == 0:
            stamps.append((time.perf_counter(), time.process_time()))
            if stop(stamps[-1][0]):
                raise _Stop
        calls += 1
        return draw(*a, **k)

    zsl._padded_gan_batch = stamped


def numbers(ctx, rec: dict) -> tuple[dict, dict]:
    """(compared numbers, notes) of the checked epochs' D and G steps
    against the reference, which runs in the precision the caller has set."""
    d = rdata.load(rec["path"])
    ref = ctx.reference or rgan.run(ctx.config, ctx.traffic["zsl"], rec["p0"], rec["q0"],
                                    rec["c0"], d, rec["ent"], rec["rel"], rec["steps"],
                                    ctx.device)
    ctx.reference = ref
    state = rec["state"]
    p0 = {f"D.{k}": v for k, v in rec["c0"].items()}
    p0.update({f"G.{k}": v for k, v in rec["p0"].items()})
    # compared: the first step's loss, the first gradient at the worst leaf
    # and the median leaf's change (PERF.md: the hinge and LeakyReLU kinks
    # make the later steps' losses and the worst leaf's change swing with
    # float32 rounding; those numbers are noted beside)
    return compare.split(compare.training(rec["losses"], state["grads"], state["params"], ref, p0),
                         ("loss1_gap", "grad_gap", "change_median"))


def control(ctx, rec: dict) -> dict:
    """``rec`` with the program's readings replaced by the reference's, run
    in the precision the caller has set (the control of the check)."""
    r = rgan.run(ctx.config, ctx.traffic["zsl"], rec["p0"], rec["q0"], rec["c0"],
                 rdata.load(rec["path"]), rec["ent"], rec["rel"], rec["steps"], ctx.device)
    return dict(rec, losses=r["losses"], state=dict(grads=r["grads"], params=r["params"]))
