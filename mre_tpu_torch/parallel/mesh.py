"""The ``(data, model)`` process mesh and its sharding rules (port of
mre_tpu/parallel/mesh.py).

The JAX package runs one global program over a ``jax.sharding.Mesh`` and
lets GSPMD insert the collectives. The port is multi-process, as PyTorch
is: one process per rank, ``torch.distributed`` process groups (NCCL on
cards, gloo on the CPU). The rule for every path that takes a mesh: a rank
computes its part of the same global function, never a different function
of its own shard.

* ``Mesh`` — this rank's place in an ``n_data × n_model`` grid (the model
  index varies fastest, as ``mesh.py:43`` reshapes the device list), the
  process group of its model column (the ``data`` axis: ranks that share a
  model index) and of its data row (the ``model`` axis), and its device. A
  1 × 1 mesh needs no process group: every collective is then the identity
  (``mesh.py:10-13``: "with a 1-device mesh everything degrades to plain
  jit").
* ``batch_sharding`` / ``table_sharding`` / ``replicated`` — the rows of a
  batch (over ``data``) or of a table (over ``model``) that this rank
  holds, as a ``slice``; splits need not be even (2721 rows at 2 ranks are
  1361 and 1360).
* Collectives with gradients: ``gather_rows`` (all-gather on dim 0; its
  backward sums the incoming gradients over the group and keeps this rank's
  rows), ``all_reduce_sum`` (sum; its backward is the adjoint sum, or the
  identity where the result feeds a computation every rank of the group
  repeats — Megatron's vocab-parallel and row-parallel reductions),
  ``copy_to_group`` (identity; its backward sums), and ``allreduce_grads``
  (one flat SUM of the ``.grad`` of a parameter list). Every collective is
  an ``all_reduce``: a gather sums zero-padded blocks, which is exact and
  takes uneven row counts, so one route serves every backend and device.
* ``shard_transformer_ffn`` — Megatron tensor parallelism of the
  transformer FFNs over ``model`` (``models/transformer.py::
  TensorParallelMLP``), for the duration of a ``with`` block.
* ``init_distributed`` — the default process group over a ``file://``
  store (no network, and no port to clash under parallel test workers).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from mre_tpu_torch.core.device import rank_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(backend: str | None = None, init_file: str | None = None,
                     rank: int = 0, world: int = 1,
                     device: str | torch.device | None = None) -> torch.device:
    """Initialize the default process group of ``world`` ranks over the
    file store ``init_file`` (a fresh file under a temporary directory when
    None, which only a 1-rank world can share) and return this rank's
    device (``core/device.py::rank_device``). ``backend`` defaults to
    ``nccl`` for a CUDA device and ``gloo`` for the CPU; gloo may be asked
    for on a card (several ranks on one card: NCCL refuses them)."""
    dev = rank_device(rank, device)
    if init_file is None:
        if world != 1:
            raise ValueError("init_distributed: ranks of a multi-rank world must share "
                             "one init_file")
        init_file = os.path.join(tempfile.mkdtemp(), "store")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{os.path.abspath(init_file)}",
                            rank=rank, world_size=world, timeout=TIMEOUT, **kw)
    return dev


def split_bounds(n: int, parts: int, index: int) -> tuple[int, int]:
    """Rows ``[lo, hi)`` of part ``index`` when ``n`` rows split into
    ``parts`` contiguous parts, the first ``n % parts`` one row longer."""
    base, rem = divmod(n, parts)
    lo = index * base + min(index, rem)
    return lo, lo + base + (index < rem)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(data, model)`` grid; ``data_group`` and
    ``model_group`` are None where the axis has one rank."""

    rank: int
    world: int
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        """Ranks per axis, as a JAX mesh's ``shape``."""
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def _axis_group(ranks: list[int], world: int):
    """The process group of ``ranks`` (None for one rank: no collective);
    every rank of the world must call this for every group, in the same
    order (``dist.new_group``)."""
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """The ``n_data × n_model`` mesh over the initialized default group
    (``n_data`` None: the world size over ``n_model``). Raises when the
    grid does not cover the world exactly; more than one rank without an
    initialized group raises too, never quietly running one rank. A 1 × 1
    mesh needs no group. The mesh's device is ``rank_device(rank, device)``:
    ``cuda:(rank % cards)`` unless the caller passes another."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model}: both axes need at least one rank")
    if n_data * n_model > 1 and not initialized:
        raise RuntimeError(f"mesh {n_data}x{n_model} needs an initialized process group "
                           "(parallel.mesh.init_distributed); none is")
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks, "
                         f"the world has {world}")
    d_idx, m_idx = divmod(rank, n_model)
    data_group = model_group = None
    for m in range(n_model):                      # one group per model column
        g = _axis_group([d * n_model + m for d in range(n_data)], world)
        if m == m_idx:
            data_group = g
    for d in range(n_data):                       # one group per data row
        g = _axis_group([d * n_model + m for m in range(n_model)], world)
        if d == d_idx:
            model_group = g
    return Mesh(rank, world, n_data, n_model, d_idx, m_idx, data_group, model_group,
                rank_device(rank, device))


def replicated(mesh: Mesh) -> slice:
    """Every row: the value is the same on every rank."""
    return slice(None)


def batch_sharding(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of an ``n_rows`` batch, split over ``data``."""
    return slice(*split_bounds(n_rows, mesh.n_data, mesh.data_index))


def table_sharding(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of an ``n_rows`` table, split over ``model``."""
    return slice(*split_bounds(n_rows, mesh.n_model, mesh.model_index))


def shard_batch(mesh: Mesh, tree, n_rows: int | None = None):
    """This rank's rows (``batch_sharding``) of every leaf of ``tree`` (a
    dict, list, tuple or NamedTuple of tensors or arrays) whose leading axis
    has ``n_rows`` rows (default: the first leaf's); other leaves and None
    stay whole."""
    if n_rows is None:
        n_rows = _first_leaf(tree).shape[0]
    rows = batch_sharding(mesh, n_rows)

    def cut(x):
        if x is None or getattr(x, "ndim", 0) < 1 or x.shape[0] != n_rows:
            return x
        return x[rows]

    return _tree_map(cut, tree)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """The rows ``rows`` of an ``n``-row batch that this rank computes, and
    the group (with every rank's row count) that holds the others."""

    rows: slice
    n: int
    group: object
    counts: tuple

    @property
    def n_local(self) -> int:
        return self.rows.stop - self.rows.start

    def local(self, x):
        return x[self.rows]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_rows(x, self.group, list(self.counts))


def row_shard(mesh: Mesh, n_rows: int) -> RowShard:
    """This rank's ``batch_sharding`` of ``n_rows`` as a ``RowShard`` over
    the data group (the counts follow from the split: no collective)."""
    counts = tuple(hi - lo for lo, hi in (split_bounds(n_rows, mesh.n_data, d)
                                          for d in range(mesh.n_data)))
    return RowShard(batch_sharding(mesh, n_rows), n_rows, mesh.data_group, counts)


def table_shard(mesh: Mesh, n_rows: int) -> RowShard:
    """This rank's ``table_sharding`` of ``n_rows`` as a ``RowShard`` over
    the model group."""
    counts = tuple(hi - lo for lo, hi in (split_bounds(n_rows, mesh.n_model, m)
                                          for m in range(mesh.n_model)))
    return RowShard(table_sharding(mesh, n_rows), n_rows, mesh.model_group, counts)


def lookup_rows(local: torch.Tensor, idx: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """Rows ``idx`` (global ids, any shape) of a table whose rows are split
    over ``shard.group``, ``local`` holding this rank's ``shard.rows``:
    Megatron's vocab-parallel embedding. Each rank gathers the rows it owns
    (zeros elsewhere) and the group sums them, exactly. The result feeds a
    computation every rank of the group repeats, so the backward is the
    identity: the gradient lands in the owner's rows only."""
    lo, n_local = shard.rows.start, shard.n_local
    idx = torch.as_tensor(idx, device=local.device).long()
    own = (idx >= lo) & (idx < lo + n_local)
    rows = local[torch.clamp(idx - lo, 0, max(n_local - 1, 0))]
    rows = torch.where(own.reshape(own.shape + (1,) * (rows.dim() - own.dim())),
                       rows, torch.zeros_like(rows))
    return all_reduce_sum(rows, shard.group, replicated_grad=True)


class ShardedTable:
    """A table split by rows over a group, indexed like the whole tensor:
    ``table[idx]`` is ``lookup_rows``; ``shape`` is the whole table's."""

    def __init__(self, local: torch.Tensor, shard: RowShard):
        self.local, self.shard = local, shard

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.shard.n,) + tuple(self.local.shape[1:]))

    def __getitem__(self, idx):
        return lookup_rows(self.local, idx, self.shard)

    def full(self) -> torch.Tensor:
        """Every row, gathered from the group (no gradient)."""
        return _gather(self.local, self.shard.group, list(self.shard.counts))


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _first_leaf(tree):
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


# -- collectives -------------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The SUM of ``x`` over ``group`` (a new tensor; ``x`` itself when the
    group has one rank and no process group)."""
    if group is None:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def row_counts(n_local: int, group, device) -> list[int]:
    """Every rank's row count in ``group``, in group-rank order."""
    counts = torch.zeros(group_size(group), dtype=torch.int64, device=device)
    counts[group_rank(group)] = n_local
    return [int(c) for c in _all_reduce(counts, group).cpu()]


def _gather(x: torch.Tensor, group, counts: list[int]) -> torch.Tensor:
    """All-gather of ``x`` [counts[i], ...] on dim 0, as the SUM of
    zero-padded blocks (exact: every element is one rank's value plus
    zeros)."""
    start = sum(counts[:group_rank(group)])
    full = x.new_zeros((sum(counts),) + tuple(x.shape[1:]))
    full[start:start + x.shape[0]] = x.detach()
    return _all_reduce(full, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, counts):
        ctx.group, ctx.counts = group, counts
        return _gather(x, group, counts)

    @staticmethod
    def backward(ctx, grad):
        start = sum(ctx.counts[:group_rank(ctx.group)])
        n = ctx.counts[group_rank(ctx.group)]
        return _all_reduce(grad, ctx.group)[start:start + n], None, None


def gather_rows(x: torch.Tensor, group, counts: list[int] | None = None) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated in group-rank order (the
    counts may differ; ``row_counts`` when not given). The backward sums
    the incoming gradient over the group and keeps this rank's rows: a loss
    every rank repeats therefore reaches ``x`` ``group_size`` times, and a
    caller scales such a loss by ``1 / group_size``."""
    if group is None:
        return x
    if counts is None:
        counts = row_counts(x.shape[0], group, x.device)
    return _GatherRows.apply(x, group, counts)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, replicated_grad):
        ctx.group, ctx.replicated_grad = group, replicated_grad
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.replicated_grad:
            return grad, None, None
        return _all_reduce(grad, ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, group, replicated_grad: bool = False) -> torch.Tensor:
    """The SUM of ``x`` over ``group``. The backward is the adjoint, the sum
    of the incoming gradients over the group; with ``replicated_grad`` it is
    the identity, which is the gradient when every rank of the group
    computes the same function of the result (Megatron's row-parallel and
    vocab-parallel reductions)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group, replicated_grad)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``group``
    (Megatron's column-parallel input: every rank feeds its slice of a
    layer from the same replicated ``x``)."""
    if group is None:
        return x
    return _CopyToGroup.apply(x, group)


def allreduce_grads(params, group) -> None:
    """SUM the ``.grad`` of ``params`` over ``group`` in one flat buffer.
    Parameters without a gradient are skipped; every rank runs the same
    graph, so every rank skips the same ones."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def barrier() -> None:
    """Wait for every rank of the default group (no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


# -- tensor parallelism ------------------------------------------------------

@contextlib.contextmanager
def shard_transformer_ffn(module: torch.nn.Module, mesh: Mesh):
    """Within the ``with`` block, ``module``'s ``TransformerMLP`` blocks are
    Megatron tensor-parallel over ``model`` (``mesh.py:68-89``): each is
    replaced by a ``TensorParallelMLP`` over views of its own weights
    (``fc1``'s output columns and bias, ``fc2``'s input rows: no copy), whose
    ``fc2`` product is summed over the model group before its bias is added
    once. A hidden width that the model axis does not divide stays
    replicated, as in JAX. The blocks are put back on exit. Yields
    ``module``; with one model rank it is left as it is."""
    from mre_tpu_torch.models.lfm2 import LFM2
    from mre_tpu_torch.models.transformer import TensorParallelMLP, TransformerMLP

    if any(isinstance(m, LFM2) for m in module.modules()):
        raise NotImplementedError("shard_transformer_ffn: the LFM2 encoder has no "
                                  "tensor-parallel FFN")
    swapped = []
    if mesh.n_model > 1:
        for parent in list(module.modules()):
            for name, child in list(parent.named_children()):
                if (isinstance(child, TransformerMLP)
                        and child.fc1.out_features % mesh.n_model == 0):
                    setattr(parent, name, TensorParallelMLP(child, mesh))
                    swapped.append((parent, name, child))
    try:
        yield module
    finally:
        for parent, name, child in swapped:
            setattr(parent, name, child)
