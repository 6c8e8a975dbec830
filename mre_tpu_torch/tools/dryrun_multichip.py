"""Multi-rank dry run of the port's parallel layer (the counterpart of
``__graft_entry__.dryrun_multichip`` / ``_dryrun_impl``).

    python -m mre_tpu_torch.tools.dryrun_multichip --world 4 \\
        [--device cpu|cuda] [--backend gloo|nccl]

Spawns a 1-rank world and then ``--world`` ranks (``torch.multiprocessing``,
spawn), runs the same checks in both on the tiny fixture of ``_tiny_setup``
(the ZSL checks of the larger world start from the 1-rank world's module
state, as ``_dryrun_impl``'s two runs share ``host_state``) and prints one
line per equality of ``_dryrun_impl``, in its wording:

1. three data-parallel fusion steps (``n_data = world``): final parameters
   within 5e-4·scale + 1e-5 of the 1-rank run, step-0 loss rtol 2e-4;
2. the train state saved under the mesh (rank 0 writes), restored on every
   rank, two more steps: bitwise equal to the live continuation;
3. a KGE step (TransE) on the ``world/2 × 2`` mesh with the entity table's
   rows over ``model``: loss rtol 2e-4 of the 1-rank step;
4. the entity sweep with the FFNs tensor parallel over ``model`` and the
   batches over ``data``: rtol 2e-4, atol 2e-5 of the replicated sweep;
5. filtered link prediction on the row-split table: metrics equal (rtol
   1e-6) to the 1-rank run's;
6. three D/G iterations with the GAN batch over ``data``: losses rtol 2e-4;
7. ``rel_shared`` evaluation with the chunks over ``data``: ranks identical.

A failed rank, a process group that cannot form, or a failed equality
exits non-zero. The ranks run on the cards (``cuda:rank % cards``; several
ranks may share one under ``--backend gloo``: NCCL refuses two ranks on one
card) unless ``--device cpu`` is given; with no card and no ``--device
cpu`` the run raises before it spawns, here and in ``spawn``,
``run_worlds`` and ``dryrun``.

``spawn(task, world, ...)`` and ``run_checks`` are the building blocks:
``chip_smoke.py`` drives them at full width and the tests feed them the
JAX package's weights and draws.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp_mp

from mre_tpu_torch.core import checkpoint as ckpt
from mre_tpu_torch.core.device import resolve_device
from mre_tpu_torch.data.fixtures import write_zsl_dataset
from mre_tpu_torch.data.kg import TripleTable
from mre_tpu_torch.data.loaders import load_zsl_dataset
from mre_tpu_torch.data.multimodal import MultimodalPipelineConfig, MultimodalStore
from mre_tpu_torch.interop import load_flax, module_to_flax
from mre_tpu_torch.ops import attention, ranking
from mre_tpu_torch.parallel import mesh as pmesh
from mre_tpu_torch.train.fusion import FusionConfig, FusionTrainer
from mre_tpu_torch.train.kge import KGETrainer, KGETrainerConfig
from mre_tpu_torch.zsl.module import ZSLConfig, ZSLModule

# __graft_entry__._tiny_setup's fixture, store and trainer
TINY = dict(
    data=dict(n_ent=24, n_rel=5, n_unseen=1, triples_per_rel=10, image_size=8, seed=0,
              n_candidates=22),
    pipe=dict(image_size=32, vocab_size=128, tokenizer_max_length=8,
              unpaired_tokenizer_max_length=16),
    fusion=dict(model_type="tiny", emb_dim=16, noise_dim=4, patch_size=8,
                image_mask_ratio=0.5, text_mask_ratio=0.5, batch_size=4, sample_size=2,
                neg_ent=2, epochs=1),
)
N_STEPS, K_RESUME = 3, 2
PARAM_REL, PARAM_ABS = 5e-4, 1e-5         # × the largest parameter magnitude
LOSS_RTOL = 2e-4
TP_RTOL, TP_ATOL = 2e-4, 2e-5
METRIC_RTOL = 1e-6
# adam's first moment after the first step, per leaf: the gradients differ
# by summation order only (tests/test_torch_port_train_step.py's bound)
MOMENT_REL = 1e-4


def dryrun_config(world: int) -> dict:
    """The checks of ``_dryrun_impl`` for a ``world``-rank run (its 1-rank
    reference takes the same config): sizes that follow the world size are
    fixed here, so both runs see the same shapes."""
    half = max(world // 2, 1)
    return dict(
        setup=TINY, fusion=dict(steps=N_STEPS, resume=K_RESUME),
        tp=dict(batch_size=8, n_model=2 if world >= 2 else 1),
        zsl=dict(cfg=dict(emb_dim=16, noise_dim=4, test_sample=4, max_neighbor=8,
                          pretrain_times=2, pretrain_batch_size=4, pretrain_few=2,
                          pretrain_subepoch=2, train_times=1, D_batch_size=2 * world,
                          G_batch_size=2 * world, seed=0),
                 iters=3, query_chunk=4),
        kge=dict(n_ent=32, n_rel=4, n_train=200, seed=0, n_test=24, test_seed=1, chunk=8,
                 n_model=2 if world >= 2 else 1,
                 cfg=dict(model="transe", dim=16, batch_size=16 * half, neg_ent=2,
                          train_times=1, nbatches=1)),
    )


# -- spawning ---------------------------------------------------------------

def spawn(task, world: int, *args, device: str | None = None, backend: str | None = None,
          threads: int = 1) -> list:
    """Run ``task(device, work_dir, *args)`` on ``world`` spawned ranks of
    one process group (``work_dir`` is shared by the ranks) and return each
    rank's result, in rank order. ``device`` None is the cards: without one
    this raises before it spawns (``core/device.py``); the CPU only when
    asked for. A rank that raises makes this raise (the other ranks are
    stopped)."""
    resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        tmp_mp.start_processes(_rank_main, args=(world, tmp, device, backend, threads,
                                                 task, args),
                               nprocs=world, join=True, start_method="spawn")
        out = []
        for rank in range(world):
            # written by this program's own ranks just above
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(rank, world, tmp, device, backend, threads, task, args):
    torch.set_num_threads(threads)
    dev = pmesh.init_distributed(backend, os.path.join(tmp, "store"), rank, world, device)
    try:
        result = task(dev, tmp, *args)
        pmesh.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(x) -> np.ndarray:
    """A host copy (never a view of a CPU tensor that training updates in
    place)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


# -- the fixture --------------------------------------------------------------

def build_fusion(work_dir: str, setup: dict, device, mesh=None, name: str = "data"):
    """(trainer, dataset dict, data path): the fixture at ``setup["path"]``
    or written once by rank 0 under ``work_dir/name`` from
    ``setup["data"]``, the store, the table and a seeded trainer (or one
    with the flax trees ``setup["init"]``)."""
    path = setup.get("path") or os.path.join(work_dir, name)
    if "path" not in setup and (not dist.is_initialized() or dist.get_rank() == 0):
        write_zsl_dataset(path, **setup["data"])
    pmesh.barrier()
    data = load_zsl_dataset(path, mode="train")
    store = MultimodalStore(data["mm_info"], data["rel_des"],
                            MultimodalPipelineConfig(**setup["pipe"]))
    table = TripleTable.build(np.asarray(data["triples"]).T, len(data["e2id"]),
                              len(data["r2id"]))
    trainer = FusionTrainer(table, store, FusionConfig(**setup["fusion"]), device=device,
                            mesh=mesh)
    if setup.get("init") is not None:
        load_flax(trainer.model, *setup["init"])
    return trainer, data, path


def _launches() -> dict:
    return dict(attention.LAUNCHES)


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in attention.LAUNCHES.items()}


# -- the checks on one rank ------------------------------------------------------

def run_checks(device, work_dir: str, cfg: dict) -> dict:
    """Every check of ``cfg`` on this rank (sections ``tp``, ``zsl``,
    ``fusion``, ``kge`` and a list ``kge_cases``; each optional). The meshes follow the world size:
    ``world × 1`` for data parallel, ``world/n_model × n_model`` for the
    model axis; a 1-rank world runs the same code on 1 × 1 meshes."""
    world = dist.get_world_size()
    mesh = pmesh.make_mesh(n_data=world, device=device)
    out = {"rank": dist.get_rank(), "world": world, "backend": dist.get_backend(),
           "device": str(device), "section_s": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        _sync(device)
        out["section_s"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    trainer = None
    if "tp" in cfg or "zsl" in cfg:
        trainer, data, path = build_fusion(work_dir, cfg["setup"], device, mesh)
        pristine = trainer.train_state() if "fusion" in cfg else None
        lap("setup")
        if "tp" in cfg:
            out["tp"] = _check_tp(trainer, cfg["tp"], device)
            lap("tp")
        if "zsl" in cfg:
            out["zsl"] = _check_zsl(trainer, data, path, cfg["zsl"], mesh, device)
            if pristine is not None:
                trainer.load_train_state(pristine)
            lap("zsl")
    if "fusion" in cfg:
        spec = cfg["fusion"]
        if trainer is None or "setup" in spec:     # a fixture of its own
            trainer = build_fusion(work_dir, spec.get("setup", cfg.get("setup")), device, mesh,
                                   name="fusion_data")[0]
        out["fusion"] = _check_fusion(trainer, spec, mesh, work_dir, device)
        lap("fusion")
    if "kge" in cfg:
        out["kge"] = _check_kge(cfg["kge"], device)
        lap("kge")
    if "kge_cases" in cfg:
        out["kge_cases"] = [_check_kge(spec, device) for spec in cfg["kge_cases"]]
        lap("kge_cases")
    return out


def _model_mesh(n_model: int, device) -> pmesh.Mesh:
    """The ``world/n_model × n_model`` mesh (1 × 1 in a 1-rank world, the
    reference run of the same config)."""
    world = dist.get_world_size()
    n_model = n_model if world % n_model == 0 else 1
    return pmesh.make_mesh(n_data=world // n_model, n_model=n_model, device=device)


def _check_tp(trainer, spec, device) -> dict:
    mesh2 = _model_mesh(spec["n_model"], device)
    # each group's first collective (NCCL builds its communicator there)
    # stays out of the timed sweep
    for group in (mesh2.data_group, mesh2.model_group):
        pmesh.all_reduce_sum(torch.zeros(1, device=device), group)
    before = _launches()
    _sync(device)
    t0 = time.perf_counter()
    emb = trainer.generate_ent_embeddings(spec["batch_size"], mesh=mesh2)
    _sync(device)
    return dict(emb=_host(emb), ms=1e3 * (time.perf_counter() - t0), launches=_delta(before),
                mesh=(mesh2.n_data, mesh2.n_model))


def _check_zsl(trainer, data, path, spec, mesh, device) -> dict:
    """``rel_shared`` ranks under the data axis, then ``iters`` D/G
    iterations on one GAN batch with its rows over ``data``. ``spec``
    may carry the module's state (``state``: Extractor and Discriminator
    flax trees, symbol table, centroids, test noises), the GAN ``batch`` and
    each step's ``draws`` in place of the seeded ones."""
    state = spec.get("state")
    zsl = ZSLModule(path, data["r2id"], data["e2id"], ZSLConfig(**spec["cfg"]), device=device,
                    test_noises=None if state is None else state["test_noises"])
    if state is None:
        # every world starts from the same state, as _dryrun_impl's host_state:
        # a replicated sweep (a data-parallel one takes other batch shapes,
        # whose float32 roundings would reorder near-tied ranks)
        sweep, trainer.mesh = spec.get("sweep_batch", 8), None
        try:
            zsl.update_embed(trainer.generate_ent_embeddings(sweep),
                             trainer.generate_rel_embeddings(sweep))
        finally:
            trainer.mesh = mesh
        zsl.compute_centroids()
    else:
        load_flax(zsl.extractor, state["ex"])
        load_flax(zsl.discriminator, *state["d"])
        zsl.symbol_table = torch.as_tensor(state["symbols"], device=device)
        zsl.centroid_matrix = torch.as_tensor(state["centroid"], device=device)
    # the state the checks start from, for another world to start from it too
    # (a world's sweep may differ from another's in the last bits)
    start = dict(ex=module_to_flax(zsl.extractor)[0], d=module_to_flax(zsl.discriminator),
                 symbols=_host(zsl.symbol_table), centroid=_host(zsl.centroid_matrix),
                 test_noises=_host(zsl.test_noises))
    before = _launches()
    res = zsl.evaluate(trainer, mode="test", verbose=False, query_chunk=spec["query_chunk"],
                       eval_path="rel_shared", mesh=mesh, return_ranks=True)
    out = dict(ranks=res["ranks"], n=res["n"], hits10=res["hits10"], mrr=res["mrr"],
               eval_launches=_delta(before), state=start)
    batch = spec.get("batch") or zsl._padded_gan_batch()
    zsl.reset_g_optimizer(trainer)
    draws = spec.get("draws") or [None, None] * spec["iters"]
    d, g = [], []
    before = _launches()
    _sync(device)
    t0 = time.perf_counter()
    for i in range(spec["iters"]):
        d.append(zsl.d_step(trainer, batch, draws[2 * i], mesh))
        g.append(zsl.g_step(trainer, batch, draws[2 * i + 1], mesh))
    _sync(device)
    out.update(gan_ms=1e3 * (time.perf_counter() - t0) / spec["iters"],
               gan_launches=_delta(before), rows=len(batch[1]),
               d=[{k: float(v) for k, v in x.items()} for x in d],
               g=[{k: float(v) for k, v in x.items()} for x in g])
    return out


def _model_arrays(trainer) -> dict:
    return {k: _host(v) for k, v in trainer.model.state_dict().items()}


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def _check_fusion(trainer, spec, mesh, work_dir, device) -> dict:
    """``steps`` dp steps on one batch from identical state, then the mesh
    checkpoint round trip and ``resume`` more steps, live and restored."""
    graph_batch = spec.get("graph_batch")
    if graph_batch is None:
        graph_batch = trainer.sampler.sample_batch(np.arange(trainer.cfg.batch_size))
    batch = trainer.prepare_device_batch(graph_batch)
    draws = list(spec.get("draws") or [])
    infos, launches, step_ms = [], [], []
    moment = None
    for i in range(spec["steps"]):
        before = _launches()
        _sync(device)
        t0 = time.perf_counter()
        info = trainer.step(batch, draws[i] if i < len(draws) else None)
        _sync(device)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        infos.append({k: float(v) for k, v in info.items()})
        launches.append(_delta(before))
        if moment is None:
            # adam's first moment after one step is 0.1 × the summed
            # gradient: adam's steps hardly move when every gradient is
            # scaled alike, this does
            moment = {k: _host(trainer.optimizer.state[p]["exp_avg"])
                      for k, p in trainer.model.named_parameters()
                      if p in trainer.optimizer.state}
    params = {k: _host(v) for k, v in trainer.model.named_parameters()}
    # the gradient all-reduce timed apart; a 1 × 1 mesh's step has none,
    # so a 1-rank world times it over its own one-rank group (NCCL on a card)
    group = mesh.data_group if mesh.data_group is not None else dist.group.WORLD
    reduce_ms = []
    n_grad = sum(p.grad.numel() for p in trainer.model.parameters() if p.grad is not None)
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        pmesh.allreduce_grads(trainer.model.parameters(), group)
        _sync(device)
        reduce_ms.append(1e3 * (time.perf_counter() - t0))
    out = dict(infos=infos, params=params, moment=moment, digest=_digest(params),
               launches=launches, step_ms=step_ms,
               allreduce_ms=reduce_ms, grad_floats=n_grad,
               n_nodes=int(batch["node_mask"].shape[0]), n_edges=int(batch["edge_mask"].shape[0]))
    k = spec.get("resume", 0)
    if k:
        path = os.path.join(work_dir, "mesh_resume.ckpt")
        t0 = time.perf_counter()
        ckpt.save_checkpoint(path, trainer.train_state(), mesh=mesh)
        save_s = time.perf_counter() - t0
        for _ in range(k):
            trainer.step(batch)
        live = _model_arrays(trainer)
        trainer.load_train_state(ckpt.load_checkpoint(path, trainer.train_state()))
        for _ in range(k):
            trainer.step(batch)
        resumed = _model_arrays(trainer)
        diff = [name for name in live if not np.array_equal(live[name], resumed[name])]
        out["resume"] = dict(leaves=len(live), differ=diff, save_s=save_s,
                             bytes=os.path.getsize(path))
    return out


def _kge_table(spec):
    rng = np.random.default_rng(spec["seed"])
    n = spec["n_train"]
    tri = np.stack([rng.integers(0, spec["n_ent"], n), rng.integers(0, spec["n_rel"], n),
                    rng.integers(0, spec["n_ent"], n)], 1).astype(np.int32)
    return TripleTable.build(tri, spec["n_ent"], spec["n_rel"])


def _check_kge(spec, device) -> dict:
    """One step of the KGE trainer on the ``world/n_model × n_model`` mesh
    (entity rows over ``model``, batch over ``data``), then filtered link
    prediction on the row-split table. ``spec["batch"]`` (a NegativeBatch)
    replaces the sampled batch; ``spec["init"]`` the seeded parameters."""
    mesh = _model_mesh(spec["n_model"], device)
    table = _kge_table(spec)
    trainer = KGETrainer(table, KGETrainerConfig(**spec["cfg"]), mesh=mesh)
    if spec.get("init") is not None:
        trainer.load_params(spec["init"])
    losses, step_ms = [], []
    for i in range(spec.get("steps", 1)):
        _sync(device)
        t0 = time.perf_counter()
        if spec.get("batch") is not None:
            b = spec["batch"]
            loss = trainer.step_with_batch(type(b)(*(None if x is None else x.to(device)
                                                     for x in b)))
        else:
            loss = trainer.train_step()["loss"]
        _sync(device)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    out = dict(losses=losses, step_ms=step_ms, mesh=(mesh.n_data, mesh.n_model),
               params={k: _host(v) for k, v in trainer.full_params().items()})
    if spec.get("n_test"):
        rng = np.random.default_rng(spec["test_seed"])
        test = np.stack([rng.integers(0, spec["n_ent"], spec["n_test"]),
                         rng.integers(0, spec["n_rel"], spec["n_test"]),
                         rng.integers(0, spec["n_ent"], spec["n_test"])], 1).astype(np.int32)
        if spec.get("lp_init") is not None:
            trainer.load_params(spec["lp_init"])
        _sync(device)
        t0 = time.perf_counter()
        res = trainer.link_prediction(test, filter_table=table, chunk=spec["chunk"])
        _sync(device)
        out["lp_ms_per_triple"] = 1e3 * (time.perf_counter() - t0) / len(test)
        out["metrics"] = {s: (res[s].mr, res[s].mrr, res[s].hits10) for s in ("raw", "filter")}
        filt = trainer.filter_kg(table)
        out["ranks"] = ranking.rank_arrays(*trainer.predictors(filt), trainer.params, filt, test,
                                           chunk=spec["chunk"], shard=trainer.ent_shard)
    return out


# -- comparisons ---------------------------------------------------------------

def param_gap(a: dict, b: dict) -> tuple[float, float]:
    """(largest |a − b| over every parameter, largest |b|)."""
    gap = max(float(np.max(np.abs(a[k] - b[k]))) for k in b)
    scale = max(float(np.max(np.abs(b[k]))) for k in b)
    return gap, scale


def moment_gap(a: dict, b: dict) -> float:
    """The largest |a − b| of a leaf over that leaf's largest |b| (leaves
    with an all-zero ``b`` count their absolute gap)."""
    if set(a) != set(b):
        return float("inf")
    return max(float(np.max(np.abs(a[k] - b[k]))) / max(float(np.max(np.abs(b[k]))), 1e-30)
               if np.any(b[k]) else float(np.max(np.abs(a[k]))) for k in b)


def compare(sharded: dict, single: dict) -> list[tuple[bool, str]]:
    """(holds, line) for each equality both runs carry, in
    ``_dryrun_impl``'s order and wording."""
    lines = []
    world = sharded["world"]
    if "fusion" in sharded:
        f, f1 = sharded["fusion"], single["fusion"]
        gap, scale = param_gap(f["params"], f1["params"])
        l0, l1 = f["infos"][0]["loss"], f1["infos"][0]["loss"]
        m_gap = moment_gap(f["moment"], f1["moment"])
        ok = (gap <= PARAM_REL * scale + PARAM_ABS and m_gap <= MOMENT_REL
              and np.isclose(l0, l1, rtol=LOSS_RTOL, atol=1e-5))
        lines.append((ok, f"fusion dp {len(f['infos'])}-step scan: {world}-way final params == "
                          f"1-device (max abs diff {gap:.2e}; step-0 adam moment "
                          f"{m_gap:.2e} of each leaf's largest); step-0 loss {l0:.6f} == "
                          f"{l1:.6f}"))
        if "resume" in f:
            r = f["resume"]
            lines.append((not r["differ"],
                          f"mesh checkpoint resume: save/restore + {K_RESUME} steps bitwise == "
                          f"live continuation ({r['leaves']} leaves"
                          + (f"; differ: {r['differ'][:4]}" if r["differ"] else "") + ")"))
    if "kge" in sharded:
        k, k1 = sharded["kge"], single["kge"]
        ok = np.allclose(k["losses"], k1["losses"], rtol=LOSS_RTOL, atol=1e-5)
        lines.append((ok, f"kge dp×mp step: sharded loss {k['losses'][0]:.6f} == "
                          f"1-device loss {k1['losses'][0]:.6f} (mesh {k['mesh'][0]}x"
                          f"{k['mesh'][1]})"))
    if "tp" in sharded:
        e, e1 = sharded["tp"]["emb"], single["tp"]["emb"]
        ok = np.allclose(e, e1, rtol=TP_RTOL, atol=TP_ATOL)
        lines.append((ok, f"fusion TP entity sweep: dp×mp == replicated "
                          f"(max abs diff {np.max(np.abs(e - e1)):.2e})"))
    if "kge" in sharded and "metrics" in sharded["kge"]:
        m, m1 = sharded["kge"]["metrics"], single["kge"]["metrics"]
        ok = all(np.allclose(m[s], m1[s], rtol=METRIC_RTOL) for s in m1) and all(
            np.array_equal(v, single["kge"]["ranks"][k]) for k, v in sharded["kge"]["ranks"].items())
        lines.append((ok, f"sharded filtered link-prediction == replicated "
                          f"(filter mr {m['filter'][0]:.4f}, mrr {m['filter'][1]:.6f})"))
    if "zsl" in sharded:
        z, z1 = sharded["zsl"], single["zsl"]
        got = [x["loss_D"] for x in z["d"]] + [x["loss_G"] for x in z["g"]]
        ref = [x["loss_D"] for x in z1["d"]] + [x["loss_G"] for x in z1["g"]]
        ok = bool(np.all(np.isfinite(got + ref))) and np.allclose(got, ref, rtol=LOSS_RTOL,
                                                                   atol=1e-5)
        lines.append((ok, f"zsl {len(z['d'])}-step GAN loop under mesh: loss_D "
                          f"{z['d'][-1]['loss_D']:.6f} == {z1['d'][-1]['loss_D']:.6f}, loss_G "
                          f"{z['g'][-1]['loss_G']:.6f} == {z1['g'][-1]['loss_G']:.6f} (final)"))
        ok = np.array_equal(z["ranks"], z1["ranks"]) and z["n"] == z1["n"] > 0
        lines.append((ok, f"rel_shared eval under mesh: {z['n']} query ranks == "
                          f"single-device (hits10 {z['hits10']:.3f})"))
    return lines


def ranks_agree(results: list) -> list[str]:
    """Names of the quantities on which the ranks of one world disagree
    (every rank must hold the same parameters and results)."""
    bad = []
    first = results[0]
    for r in results[1:]:
        if "fusion" in first and r["fusion"]["digest"] != first["fusion"]["digest"]:
            bad.append(f"fusion params of rank {r['rank']}")
        if "zsl" in first and not np.array_equal(r["zsl"]["ranks"], first["zsl"]["ranks"]):
            bad.append(f"rel_shared ranks of rank {r['rank']}")
        if "kge" in first and r["kge"]["losses"] != first["kge"]["losses"]:
            bad.append(f"kge losses of rank {r['rank']}")
    return bad


def run_worlds(cfg: dict, world: int, device: str | None = None, backend: str | None = None,
               single_backend: str | None = None, threads=(1, 1)):
    """(the 1-rank world's result, the ``world``-rank world's results): the
    1-rank world runs first and the other starts its ZSL checks from the
    1-rank world's state, as _dryrun_impl's two runs share ``host_state``."""
    single = spawn(run_checks, 1, cfg, device=device, backend=single_backend or backend,
                   threads=threads[0])[0]
    if "zsl" in cfg and "state" not in cfg["zsl"]:
        cfg = dict(cfg, zsl=dict(cfg["zsl"], state=single["zsl"]["state"]))
    return single, spawn(run_checks, world, cfg, device=device, backend=backend,
                         threads=threads[1])


def dryrun(world: int, device: str | None = None, backend: str | None = None) -> bool:
    """Run the checks on ``world`` ranks and on one, print a line per
    equality (and per disagreement between ranks); True when all hold."""
    single, sharded = run_worlds(dryrun_config(world), world, device, backend)
    ok = True
    for holds, line in compare(sharded[0], single):
        ok &= bool(holds)
        print(("" if holds else "FAILED: ") + line, flush=True)
    for line in ranks_agree(sharded):
        ok = False
        print(f"FAILED: ranks disagree: {line}", flush=True)
    if ok:
        print(f"dryrun_multichip ok on {world} ranks ({sharded[0]['backend']}, "
              f"{sharded[0]['device']})", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="default: the cards (raises without one)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    return 0 if dryrun(args.world, args.device, args.backend) else 1


if __name__ == "__main__":
    sys.exit(main())
