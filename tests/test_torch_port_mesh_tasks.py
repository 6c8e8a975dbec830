"""Rank tasks of the mesh tests, run on spawned gloo worlds on the CPU by
``mre_tpu_torch.tools.dryrun_multichip.spawn`` (each is called as
``task(device, work_dir, *args)``). The module imports no JAX, so a spawned
rank starts quickly."""

import numpy as np
import torch
import torch.distributed as dist

from mre_tpu_torch.eval.zero_shot import evaluate_zero_shot_rel_shared
from mre_tpu_torch.parallel import mesh as pmesh
from mre_tpu_torch.tools import dryrun_multichip as dry
from mre_tpu_torch.train.fusion import FusionTrainer


def unscaled_checks(device, work_dir, cfg):
    """``run_checks`` with the replicated terms of the fusion step left at
    full weight on every rank (no 1/n_data)."""
    shares = FusionTrainer._shares
    FusionTrainer._shares = lambda self, node_shard: (shares(self, node_shard)[0], 1.0)
    return dry.run_checks(device, work_dir, cfg)


def averaged_checks(device, work_dir, cfg):
    """``run_checks`` with the gradients averaged over the data group
    (DDP's rule) where the design sums them."""
    summed = pmesh.allreduce_grads

    def averaged(params, group):
        params = list(params)
        summed(params, group)
        for p in params:
            if p.grad is not None:
                p.grad /= pmesh.group_size(group)

    pmesh.allreduce_grads = averaged
    return dry.run_checks(device, work_dir, cfg)


def failing_task(device, work_dir):
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    pmesh.barrier()
    return dist.get_rank()


def collectives(device, work_dir):
    """Forward values and gradients of the autograd-aware collectives on
    this rank, with uneven row counts (rank r holds r + 1 rows)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = pmesh.make_mesh(n_data=world, device=device)
    out = {}
    x = torch.full((rank + 1, 3), float(rank + 1), requires_grad=True)
    y = pmesh.gather_rows(x, mesh.data_group)
    y.sum().backward()
    out["gathered"] = y.detach().numpy()
    out["gather_grad"] = x.grad.numpy()
    w = torch.tensor([float(rank + 1)], requires_grad=True)
    s = pmesh.all_reduce_sum(w * 2.0, mesh.data_group)
    (s * s).sum().backward()
    out["sum"], out["sum_grad"] = float(s), float(w.grad)
    w2 = torch.tensor([float(rank + 1)], requires_grad=True)
    pmesh.all_reduce_sum(w2, mesh.data_group, replicated_grad=True).sum().backward()
    out["replicated_grad"] = float(w2.grad)
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.full((2,), float(rank + 1))
    q = torch.nn.Parameter(torch.zeros(1))          # no gradient: skipped
    pmesh.allreduce_grads([p, q], mesh.data_group)
    out["grads"], out["no_grad"] = p.grad.numpy(), q.grad
    table = torch.arange(10 * 2, dtype=torch.float32).reshape(10, 2)
    shard = pmesh.table_shard(pmesh.make_mesh(n_data=1, n_model=world, device=device), 10)
    local = table[shard.rows].clone().requires_grad_()
    sharded = pmesh.ShardedTable(local, shard)
    rows = sharded[torch.tensor([[0, 9], [4, 4]])]
    rows.sum().backward()
    out["lookup"], out["lookup_grad"] = rows.detach().numpy(), local.grad.numpy()
    out["table_rows"] = (shard.rows.start, shard.rows.stop)
    out["full"] = sharded.full().numpy()
    return out


def synthetic_stream(extra_true: int = 0):
    """tests/test_sharding.py's rel_shared stream: 3 relations of 5-7
    queries, chunks of 4 (5 chunks: padded to 8 on 4 ranks). Query 6's list
    holds its own true tail among the negatives; ``extra_true`` appends the
    true tail that many more times to every list."""
    rng = np.random.RandomState(0)
    n_ent, D = 40, 8
    T = rng.randn(n_ent, D).astype(np.float32)
    names = [f"e{i}" for i in range(n_ent)]
    e2id = {n: i for i, n in enumerate(names)}
    test_candidates = {}
    for r in range(3):
        rel = f"rel{r}"
        pool = rng.choice(n_ent, size=12, replace=False)
        queries = {}
        for k in range(5 + r):
            head = names[(3 * k + r) % n_ent]
            true = names[(5 * k + 2 * r + 1) % n_ent]
            negs = [names[i] for i in pool[rng.rand(len(pool)) < 0.8]]
            queries[f"{head}\t{rel}\t{true}"] = [true] + negs + [true] * extra_true
        test_candidates[rel] = queries
    rel_vecs = {f"rel{r}": np.random.RandomState(100 + r).randn(4, D).astype(np.float32)
                for r in range(3)}
    return dict(T=T, e2id=e2id, test_candidates=test_candidates, rel_vecs=rel_vecs)


def exact_ranks(spec) -> np.ndarray:
    """The pessimistic rank of each query of a synthetic stream in float64:
    1 + every negative (each occurrence) whose cosine with the relation's
    mean unit vector is at least the true tail's, + every occurrence of the
    true tail among the negatives (its cosine is the true tail's exactly;
    it is counted by id, since a vectorised float64 product may still round
    two equal rows apart)."""
    T = spec["T"].astype(np.float64)
    e2id = spec["e2id"]
    out = []
    for rel, queries in spec["test_candidates"].items():
        rv = spec["rel_vecs"][rel].astype(np.float64)
        vbar = (rv / np.linalg.norm(rv, axis=-1, keepdims=True)).mean(0)
        for key, cands in queries.items():
            ids = np.asarray([e2id[c] for c in cands])
            emb = T[e2id[key.split("\t")[0]]] + 2.0 * T[ids]
            s = emb / np.linalg.norm(emb, axis=-1, keepdims=True) @ vbar
            dup = ids[1:] == ids[0]
            out.append(1 + int(((s[1:] >= s[0]) & ~dup).sum()) + int(dup.sum()))
    return np.asarray(out)


def synthetic_rel_shared(device, work_dir, spec):
    """``tests/test_sharding.py::test_rel_shared_eval_sharded_matches_single``'s
    synthetic query stream through the port's rel_shared ranking, data
    parallel over every rank of the world."""
    T = torch.as_tensor(spec["T"])
    mesh = pmesh.make_mesh(n_data=dist.get_world_size(), device=device)
    out = evaluate_zero_shot_rel_shared(
        spec["test_candidates"], spec["e2id"],
        lambda heads, shared: T[heads][:, None, :] + 2.0 * T[shared][None, :, :],
        lambda heads, trues: T[heads] + 2.0 * T[trues],
        lambda rel: spec["rel_vecs"][rel], query_chunk=4, verbose=False,
        return_ranks=True, device=device, mesh=mesh)
    return {k: out[k] for k in ("ranks", "n", "hits10", "hits5", "hits1", "mrr")}


def make_mesh_shapes(device, work_dir):
    """Each rank's coordinates on the meshes a 4-rank world can make, and
    the refusal of a grid that does not cover the world."""
    out = {}
    for shape in ((4, 1), (2, 2), (1, 4)):
        m = pmesh.make_mesh(*shape, device=device)
        out[shape] = (m.data_index, m.model_index, pmesh.group_size(m.data_group),
                      pmesh.group_size(m.model_group))
    try:
        pmesh.make_mesh(3, 1, device=device)
    except ValueError as e:
        out["refused"] = str(e)
    return out


def one_rank_mesh(device, work_dir):
    """A 1 × 1 mesh in an initialized 1-rank world: its axes have no group,
    so no collective runs on its paths."""
    mesh = pmesh.make_mesh(device=device)
    return mesh.data_group is None, mesh.model_group is None


def tensor_parallel_ffn(device, work_dir):
    """A ``TransformerMLP`` inside ``shard_transformer_ffn`` on a 1 × world
    mesh: the replicated and the tensor-parallel outputs, whether the
    slices share the live weights' storage, and the module restored after
    the block."""
    from mre_tpu_torch.models.transformer import TensorParallelMLP, TransformerMLP

    torch.manual_seed(0)
    mlp = TransformerMLP(8, 6)
    holder = torch.nn.Sequential(mlp)
    x = torch.randn(5, 8)
    mesh = pmesh.make_mesh(n_data=1, n_model=dist.get_world_size(), device=device)
    with torch.no_grad():
        ref = mlp(x)
        with pmesh.shard_transformer_ffn(holder, mesh) as sharded:
            tp = sharded[0]
            out = tp(x)
            shares = all(a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
                         for a, b in ((tp.w1, mlp.fc1.weight), (tp.b1, mlp.fc1.bias),
                                      (tp.w2, mlp.fc2.weight), (tp.b2, mlp.fc2.bias)))
            swapped = isinstance(tp, TensorParallelMLP)
    return dict(ref=ref.numpy().copy(), out=out.numpy().copy(), shares=shares,
                swapped=swapped, restored=holder[0] is mlp)


def synthetic_rel_shared_specs(device, work_dir, specs):
    """``synthetic_rel_shared`` on each stream of ``specs`` in turn."""
    return [synthetic_rel_shared(device, work_dir, spec) for spec in specs]
