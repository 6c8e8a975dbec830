"""The port's parallel layer (``mre_tpu_torch/parallel/mesh.py``) on spawned
gloo worlds on the CPU, held against the port's own 1-rank run and against
the JAX package's mesh runs on the 8 virtual CPU devices.

One world of 4 ranks runs every check of ``tools/dryrun_multichip.run_checks``
on ``__graft_entry__._tiny_setup``'s fixture (one spawn for the module: a
4 × 1 mesh for the data-parallel paths, 2 × 2 for the tensor-parallel
sweep), and a 1-rank world runs the same config. Both take the JAX
trainer's initial weights, its first step's draws (the key split as
fusion.py:254 and :174 split it; the masking permutations from the masks
under ``k_mask``, as tests/test_torch_port_train_step.py does), and the
JAX ZSL module's state, GAN batch and per-step draws (noise and α from the
keys the JAX steps receive; dropout masks recorded by an interceptor while
the sharded JAX steps are traced, as tests/test_torch_port_zsl_train.py
does; a jitted step keeps the masks it was traced with, so each iteration
reuses them).

Tolerances, JAX's own (``__graft_entry__._dryrun_impl``) unless stated:
* one dp fusion step vs JAX's ``_step_fn`` on a 2- and a 4-device mesh:
  every info term rtol 1e-4 (tests/test_torch_port_train_step.py's bound);
* three dp steps vs the port's 1-rank run: parameters within 5e-4·scale +
  1e-5; adam's first moment after step 0 within 1e-4 of each leaf's
  largest (adam's steps barely move when every gradient is scaled alike,
  so the moment is what catches a lost or doubled 1/world factor);
* the mesh checkpoint resume: bitwise;
* the TP sweep vs JAX's ``generate_ent_embeddings(mesh=make_mesh(2, 2))``
  and vs the replicated sweep: rtol 2e-4, atol 2e-5;
* ``rel_shared`` ranks: equal (JAX's mesh eval on the same state, and the
  synthetic stream of tests/test_sharding.py whose chunk count needs
  padding to the axis);
* three D/G iterations vs JAX's sharded loop and vs the port's 1-rank
  run: rtol 2e-4.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.multiprocessing.spawn import ProcessException

import __graft_entry__ as ge
import test_torch_port_mesh_tasks as tasks
from mre_tpu.eval.zero_shot import evaluate_zero_shot_rel_shared as j_rel_shared
from mre_tpu.ops import sampling as jsampling
from mre_tpu.parallel import mesh as jmesh
from mre_tpu.zsl.module import ZSLConfig as JZSLConfig
from mre_tpu.zsl.module import ZSLModule as JZSL
from mre_tpu_torch.parallel import mesh as pmesh
from mre_tpu_torch.tools import dryrun_multichip as dry
from mre_tpu_torch.train.fusion import INFO_KEYS

WORLD = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class DropoutRecorder:
    """flax interceptor: each non-deterministic ``nn.Dropout`` draws its keep
    mask with numpy while the step is traced, records it, applies it."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.masks = []

    def __call__(self, next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, nn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        det = nn.merge_param("deterministic", mod.deterministic,
                             kwargs.get("deterministic", args[1] if len(args) > 1 else None))
        if det or mod.rate == 0.0:
            return next_fun(*args, **kwargs)
        x, keep = args[0], 1.0 - mod.rate
        mask = self.rng.random(x.shape) < keep
        self.masks.append(mask)
        return jnp.where(mask, x / keep, jnp.zeros_like(x))

    def take(self) -> list:
        out, self.masks = self.masks, []
        return out


def _jax_fusion(jf, meshes):
    """JAX's first step on each of ``meshes`` (batch sharded as
    _dryrun_impl shards it; one device batch: the store draws new crops on
    each call) and that step's draws for the port."""
    graph_batch = jf.sampler.sample_batch(np.arange(jf.cfg.batch_size))
    db = jf.prepare_device_batch(graph_batch)
    _, sub = jax.random.split(jf._rng)
    k_mask, k_drop, k_neg = jax.random.split(sub, 3)
    ei = db["edge_index"]
    neg_h, neg_t, failed = jsampling.corrupt_within_nodes(
        k_neg, jf.kg, db["n_id"], ei[0], db["edge_type"], ei[1], jf.cfg.neg_ent)
    keys = ("text", "text_padding_mask", "rel_des", "rel_des_padding_mask", "image_patches")
    (_, _, out), _ = jax.jit(lambda p, s: jf.model.apply(
        {"params": p, "spectral": s}, ei, db["edge_type"], {k: db[k] for k in keys},
        False, edge_mask=db["edge_mask"], update_sn=True, node_mask=db["node_mask"],
        mutable=["spectral"], rngs={"masking": k_mask, "dropout": k_drop}))(
            jf.params, jf.spectral)
    draws = {
        "image_ids_shuffle": torch.from_numpy(
            np.argsort(np.asarray(out["image_mask"])[0], kind="stable")),
        "text_ids_shuffle": torch.from_numpy(
            np.argsort(np.asarray(out["text_mask"])[0], kind="stable")),
        "neg_h": torch.from_numpy(np.array(neg_h)),
        "neg_t": torch.from_numpy(np.array(neg_t)),
        "neg_failed": torch.from_numpy(np.array(failed)),
    }
    infos = {}
    for mesh in meshes:
        n = mesh.shape[jmesh.DATA_AXIS]
        repl = NamedSharding(mesh, P())
        sharded = []

        def shard(k, x):
            x = np.asarray(x)
            if x.ndim >= 1 and x.shape[0] % n == 0:
                sharded.append(k)
                return jax.device_put(x, NamedSharding(mesh, P(jmesh.DATA_AXIS)))
            if x.ndim >= 2 and x.shape[0] == 2 and x.shape[1] % n == 0:
                sharded.append(k)
                return jax.device_put(x, NamedSharding(mesh, P(None, jmesh.DATA_AXIS)))
            return jax.device_put(x, repl)

        batch = {k: shard(k, v) for k, v in db.items()}
        assert "image_patches" in sharded and "edge_index" in sharded
        put = lambda tree: jax.tree_util.tree_map(  # noqa: E731
            lambda x: jax.device_put(np.asarray(x), repl), tree)
        rng = jax.random.wrap_key_data(put(np.asarray(jax.random.key_data(jf._rng))))
        *_, info = jf._step_fn(put(jf.params), put(jf.spectral), put(jf.opt_state), rng,
                               batch)
        infos[n] = {k: float(v) for k, v in info.items()}
    return graph_batch, draws, infos


def _jax_zsl(jf, path, data, mesh, iters=3):
    """The dry run's ZSL module on ``mesh`` (_dryrun_impl's zsl_once and
    zs_eval_once, sharded): its state before the loop, the GAN batch, each
    step's draws, the losses and the rel_shared ranks."""
    zcfg = JZSLConfig(**dry.dryrun_config(WORLD)["zsl"]["cfg"])
    jz = JZSL(path, data["r2id"], data["e2id"], zcfg, jf)
    jz.update_embed(np.asarray(jf.generate_ent_embeddings(batch_size=8)),
                    np.asarray(jf.generate_rel_embeddings(batch_size=8)))
    jz.compute_centroids()
    batch = tuple(np.asarray(a) for a in jz._padded_gan_batch())
    run_g, g0, gopt0 = jz._make_g_step(jf)
    state = dict(ex=_np(jz.ex_params), d=(_np(jz.d_params), _np(jz.d_spectral)),
                 symbols=np.asarray(jz.symbol_table), centroid=np.asarray(jz.centroid_matrix),
                 test_noises=np.asarray(jz.test_noises))
    fusion = (_np(jf.params), _np(jf.spectral))
    repl = NamedSharding(mesh, P())
    put = lambda tree: jax.tree_util.tree_map(lambda x: jax.device_put(np.asarray(x), repl),
                                              tree)
    batch_in = tuple(jax.device_put(a, NamedSharding(
        mesh, P(jmesh.DATA_AXIS, *([None] * (a.ndim - 1))))) for a in batch)
    jz.d_params, jz.d_spectral = put(jz.d_params), put(jz.d_spectral)
    jz.opt_D_state, jz.ex_params = put(jz.opt_D_state), put(jz.ex_params)
    jz.symbol_table = jax.device_put(state["symbols"], repl)
    jz.centroid_matrix = jax.device_put(state["centroid"], repl)
    jf.params, jf.spectral = put(jf.params), put(jf.spectral)
    jz._rng = jax.random.wrap_key_data(put(np.asarray(jax.random.key_data(jz._rng))))
    gp, gopt = put(g0), put(gopt0)
    Q = len(batch[1])
    rec = DropoutRecorder(21)
    draws, d_losses, g_losses = [], [], []
    masks_d = masks_g = None
    for _ in range(iters):
        r, k_noise = jax.random.split(jz._rng)
        _, k_d = jax.random.split(r)
        d_draw = dict(noise=np.asarray(jax.random.normal(k_noise, (Q, zcfg.noise_dim))),
                      alpha=np.asarray(jax.random.uniform(jax.random.split(k_d, 3)[2], (Q, 1))))
        with nn.intercept_methods(rec):
            info_d = jz._run_d_step(jf, gp, batch_in)
        masks_d = masks_d or rec.take()
        _, k_g = jax.random.split(jz._rng)
        g_draw = dict(noise=np.asarray(jax.random.normal(jax.random.split(k_g)[0],
                                                         (Q, zcfg.noise_dim))))
        with nn.intercept_methods(rec):
            gp, gopt, info_g = run_g(gp, gopt, batch_in)
        masks_g = masks_g or rec.take()
        draws += [dict(d_draw, dropout=masks_d), dict(g_draw, dropout=masks_g)]
        d_losses.append(float(info_d["loss_D"]))
        g_losses.append(float(info_g["loss_G"]))
    assert len(masks_d) == 20 and len(masks_g) == 10 and not rec.take()
    # rel_shared on the pre-loop state, sharded (zs_eval_once)
    jz.ex_params = put(state["ex"])
    jz.symbol_table = jax.device_put(state["symbols"], repl)
    jf.params, jf.spectral = put(fusion[0]), put(fusion[1])
    ev = jz.evaluate(jf, mode="test", verbose=False, query_chunk=4, eval_path="rel_shared",
                     mesh=mesh, return_ranks=True)
    jf.params, jf.spectral = fusion          # the host trees again
    return dict(state=state, batch=batch, draws=draws, d=d_losses, g=g_losses,
                ranks=np.asarray(ev["ranks"]), n=ev["n"])


@pytest.fixture(scope="module")
def runs():
    """The JAX mesh runs, then the port's world of 4 and 1-rank world on the
    same weights, draws and state."""
    jf, path, data = ge._tiny_setup(return_all=True)
    init = (_np(jf.params), _np(jf.spectral))
    mesh4 = jmesh.make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    graph_batch, draws, j_info = _jax_fusion(
        jf, [mesh4, jmesh.make_mesh(n_data=2, devices=jax.devices()[:2])])
    j_tp = np.asarray(jf.generate_ent_embeddings(
        batch_size=8, mesh=jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])))
    j_zsl = _jax_zsl(jf, path, data, mesh4)

    cfg = dry.dryrun_config(WORLD)
    cfg.pop("kge")                                   # tests/test_torch_port_mesh_kge.py
    cfg["setup"] = dict(cfg["setup"], init=init)
    cfg["fusion"] = dict(cfg["fusion"], graph_batch=graph_batch, draws=[draws])
    cfg["zsl"] = dict(cfg["zsl"], state=j_zsl["state"], batch=j_zsl["batch"],
                      draws=j_zsl["draws"])
    sharded = dry.spawn(dry.run_checks, WORLD, cfg, device="cpu")
    single = dry.spawn(dry.run_checks, 1, cfg, device="cpu")
    return dict(cfg=cfg, sharded=sharded, single=single, j_info=j_info, j_tp=j_tp,
                j_zsl=j_zsl)


def _lines(runs):
    return dict(zip(("fusion", "resume", "tp", "gan", "rel_shared"),
                    dry.compare(runs["sharded"][0], runs["single"][0])))


def test_every_rank_holds_the_same_results(runs):
    assert [r["rank"] for r in runs["sharded"]] == list(range(WORLD))
    assert {r["backend"] for r in runs["sharded"]} == {"gloo"}
    assert dry.ranks_agree(runs["sharded"]) == []


@pytest.mark.parametrize("n_jax", [2, WORLD])
def test_dp_fusion_step_info_matches_jax_mesh_step(runs, n_jax):
    """The port's first data-parallel step (4 × 1) and its 1-rank step give
    JAX's first step on a 2- and a 4-device mesh, term by term."""
    for res in (runs["sharded"][0], runs["single"][0]):
        info = res["fusion"]["infos"][0]
        assert set(info) == set(INFO_KEYS)
        for k in INFO_KEYS:
            np.testing.assert_allclose(info[k], runs["j_info"][n_jax][k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_dp_fusion_three_steps_match_one_rank(runs):
    holds, line = _lines(runs)["fusion"]
    assert holds, line
    f = runs["sharded"][0]["fusion"]
    assert (f["n_nodes"], f["n_edges"]) == (12, 8)      # both split over 4 ranks


def test_mesh_checkpoint_resume_is_bitwise(runs):
    holds, line = _lines(runs)["resume"]
    assert holds, line
    assert runs["sharded"][0]["fusion"]["resume"]["leaves"] > 80


def test_tp_sweep_matches_jax_and_replicated(runs):
    tp = runs["sharded"][0]["tp"]
    assert tp["mesh"] == (2, 2) and runs["single"][0]["tp"]["mesh"] == (1, 1)
    np.testing.assert_allclose(tp["emb"], runs["j_tp"], rtol=2e-4, atol=2e-5)
    holds, line = _lines(runs)["tp"]
    assert holds, line


def test_gan_loop_matches_jax_mesh_and_one_rank(runs):
    j = runs["j_zsl"]
    for res in (runs["sharded"][0], runs["single"][0]):
        z = res["zsl"]
        np.testing.assert_allclose([x["loss_D"] for x in z["d"]], j["d"], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose([x["loss_G"] for x in z["g"]], j["g"], rtol=2e-4, atol=1e-5)
    holds, line = _lines(runs)["gan"]
    assert holds, line


def test_rel_shared_ranks_equal_jax_mesh_and_one_rank(runs):
    z = runs["sharded"][0]["zsl"]
    assert z["n"] == runs["j_zsl"]["n"] > 0
    np.testing.assert_array_equal(z["ranks"], runs["j_zsl"]["ranks"])
    holds, line = _lines(runs)["rel_shared"]
    assert holds, line


def test_launches_per_step_do_not_depend_on_the_world(runs):
    """On the CPU the wrappers take the plain attention: no launch on any
    rank (the card's exact counts: chip_smoke.py's mesh phase)."""
    for res in runs["sharded"] + runs["single"]:
        for counts in res["fusion"]["launches"]:
            assert counts == {"attention_fwd": 0, "attention_fwd_packed": 0}


def test_rel_shared_synthetic_stream_with_padding_equals_jax_mesh():
    """The synthetic stream (5 chunks, padded to 8 on 4 ranks) ranks as the
    port's own 1-rank run does, exactly, and equals the float64 pessimistic
    rank on every query (query 6, whose list holds its own true tail among
    the negatives: 10). JAX's 8-device mesh agrees except that its float32
    scores may drop such an exact tie: the duplicate is scored through the
    shared row and the true tail through its own embedding, whose sums may
    differ in the last bit, while the port counts the true tail's id as a
    tie by id (ROADMAP.md §3)."""
    spec = tasks.synthetic_stream()
    Tj = jnp.asarray(spec["T"])
    kw = dict(query_chunk=4, verbose=False, return_ranks=True)
    ref = j_rel_shared(spec["test_candidates"], spec["e2id"],
                       lambda h, s: Tj[h][:, None, :] + 2.0 * Tj[s][None, :, :],
                       lambda h, t: Tj[h] + 2.0 * Tj[t],
                       lambda rel: spec["rel_vecs"][rel],
                       mesh=jmesh.make_mesh(n_data=8), **kw)
    outs = dry.spawn(tasks.synthetic_rel_shared, WORLD, spec, device="cpu")
    single = dry.spawn(tasks.synthetic_rel_shared, 1, spec, device="cpu")[0]
    dups = np.array([cands[1:].count(cands[0]) for q in spec["test_candidates"].values()
                     for cands in q.values()])
    assert single["n"] == ref["n"] > 0 and dups.any()
    gap = np.abs(single["ranks"] - np.asarray(ref["ranks"]))
    assert np.all(gap <= dups), (single["ranks"], ref["ranks"], dups)
    np.testing.assert_array_equal(single["ranks"][dups == 0], np.asarray(ref["ranks"])[dups == 0])
    exact = tasks.exact_ranks(spec)
    assert exact[6] == 10 and dups[6] == 1
    np.testing.assert_array_equal(single["ranks"], exact)
    for out in outs:
        np.testing.assert_array_equal(out["ranks"], single["ranks"])
        for m in ("n", "hits10", "hits5", "hits1", "mrr"):
            assert out[m] == single[m]


@pytest.mark.parametrize("task", ["unscaled_checks", "averaged_checks"])
def test_dp_check_fails_without_the_sum_rule(runs, task):
    """Leaving out the 1/world factor of the replicated terms, or averaging
    the gradients where the design sums them, fails the three-step check
    against the 1-rank run (its adam-moment part)."""
    cfg = {k: runs["cfg"][k] for k in ("setup", "fusion")}
    cfg["fusion"] = dict(cfg["fusion"], resume=0)
    mutated = dry.spawn(getattr(tasks, task), 2, cfg, device="cpu")
    holds, line = dry.compare(mutated[0], runs["single"][0])[0]
    assert not holds, line
    assert "moment" in line


def test_autograd_collectives_on_uneven_rows():
    """gather_rows' backward sums every rank's copy (so a loss every rank
    repeats reaches each row world times), all_reduce_sum's is the adjoint
    or the identity, allreduce_grads sums and skips missing gradients, and
    a row-split table looks rows up exactly."""
    outs = dry.spawn(tasks.collectives, 2, device="cpu")
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["gathered"],
                                      np.array([[1.0] * 3] + [[2.0] * 3] * 2, np.float32))
        np.testing.assert_array_equal(out["gather_grad"], np.full((rank + 1, 3), 2.0))
        assert out["sum"] == 6.0 and out["sum_grad"] == 2 * (2 * 2 * 6.0)
        assert out["replicated_grad"] == 1.0
        np.testing.assert_array_equal(out["grads"], [3.0, 3.0])
        assert out["no_grad"] is None
        table = np.arange(20, dtype=np.float32).reshape(10, 2)
        np.testing.assert_array_equal(out["lookup"], table[[[0, 9], [4, 4]]])
        lo, hi = out["table_rows"]
        want = np.zeros((10, 2), np.float32)
        np.add.at(want, [0, 9, 4, 4], 1.0)
        np.testing.assert_array_equal(out["lookup_grad"], want[lo:hi])
        np.testing.assert_array_equal(out["full"], table)
    assert [o["table_rows"] for o in outs] == [(0, 5), (5, 10)]


def test_mesh_coordinates_follow_jax_reshape():
    """Rank r sits at (r // n_model, r % n_model): the model index varies
    fastest, as mesh.py:43 reshapes the device list; a grid that does not
    cover the world raises."""
    outs = dry.spawn(tasks.make_mesh_shapes, WORLD, device="cpu")
    for rank, out in enumerate(outs):
        assert out[(4, 1)] == (rank, 0, 4, 1)
        assert out[(2, 2)] == (rank // 2, rank % 2, 2, 2)
        assert out[(1, 4)] == (0, rank, 1, 4)
        assert "needs 3 ranks" in out["refused"]


def test_a_failing_rank_fails_the_spawn():
    """Rank 1 raises; rank 0 then fails in its closing barrier or is
    stopped, whichever the spawn sees first: the spawn raises, no hang."""
    with pytest.raises(ProcessException) as err:
        dry.spawn(tasks.failing_task, 2, device="cpu")
    assert ("rank 1 fails on purpose" in str(err.value)
            or getattr(err.value, "error_index", None) == 0)


def test_the_dry_run_needs_a_card_unless_told(monkeypatch):
    """No device given and no card: ``spawn``, ``run_worlds``, ``dryrun``
    and the command raise before any rank starts, never running CPU ranks
    on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: dry.spawn(tasks.failing_task, 2),
                 lambda: dry.run_worlds(dry.dryrun_config(2), 2),
                 lambda: dry.dryrun(2),
                 lambda: dry.main(["--world", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_a_one_rank_world_mesh_runs_no_collective():
    """A 1 × 1 mesh in an initialized 1-rank world has no group on either
    axis, as with no process group at all."""
    assert dry.spawn(tasks.one_rank_mesh, 1, device="cpu") == [(True, True)]


def test_tensor_parallel_ffn_slices_the_live_weights():
    """``shard_transformer_ffn`` on 1 × 2: the FFN output equals the
    replicated one, the rank's slices are views of the module's own
    weights (no copy), and the module is restored after the block."""
    for out in dry.spawn(tasks.tensor_parallel_ffn, 2, device="cpu"):
        np.testing.assert_allclose(out["out"], out["ref"], rtol=1e-5, atol=1e-6)
        assert out["swapped"] and out["shares"] and out["restored"]


def test_a_multi_rank_mesh_needs_a_process_group():
    """No process group in this process: a 2-rank mesh raises instead of
    quietly running one rank; a 1 × 1 mesh needs none and its collectives
    are the identity."""
    with pytest.raises(RuntimeError, match="initialized process group"):
        pmesh.make_mesh(n_data=2, device="cpu")
    with pytest.raises(RuntimeError, match="initialized process group"):
        pmesh.make_mesh(n_data=1, n_model=2, device="cpu")
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.n_data, mesh.n_model, mesh.data_group, mesh.model_group) == (1, 1, None, None)
    x = torch.arange(3.0)
    assert pmesh.gather_rows(x, mesh.data_group) is x
    assert pmesh.all_reduce_sum(x, mesh.model_group) is x


@pytest.mark.parametrize("n,parts,want", [(2721 * 25, 2, [34013, 34012]),
                                          (2721, 2, [1361, 1360]),
                                          (40943, 2, [20472, 20471]),
                                          (10, 4, [3, 3, 2, 2])])
def test_split_bounds_cover_uneven_rows(n, parts, want):
    bounds = [pmesh.split_bounds(n, parts, i) for i in range(parts)]
    assert [hi - lo for lo, hi in bounds] == want
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
