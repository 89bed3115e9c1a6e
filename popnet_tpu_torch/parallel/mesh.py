"""A mesh of ranks, its process groups, the collectives the layouts use, and
data parallelism (the JAX package's `popnet_tpu/parallel/mesh.py` and the
data-parallel step of `train/steps.py jit_step_over_mesh`).

A `Mesh` lays the ranks of a job out as JAX lays devices out: axis `data`
first, then at most one of `model`, `spatial` or `pipe`, row-major, so
ranks d * n + i for i < n share a data index. It holds this rank's
coordinates and one process group an axis (the ranks that differ only
along it) and one over the whole mesh. Outside a job it is a mesh of one.

Sharding is layout, not semantics: every rank sees the global batch and
takes its own rows (`shard_batch`), and a step under any layout computes
what the one-device step computes on the global batch. Each rank seeds the
backward with its own batch's loss; `DataParallel.reduce_gradients` then
averages the gradients over the data group, which is the global gradient
because every loss is a mean over equal local batches. BatchNorm's train-mode
statistics are the only other state across ranks: the layout hands each
`models.layers.BatchNorm` its reduction group (`attach`).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

AXES = ("model", "spatial", "pipe")


class Mesh:
    """`shape`: {"data": n_data, <axis>: n} (the second axis optional).
    `ranks`: the job's ranks the mesh covers, in order (all by default: a
    mesh may use the first ranks of a job, and the others then hold no
    coordinates). Every rank of the job must build the same meshes in the
    same order: groups are created collectively."""

    def __init__(self, shape: dict[str, int], ranks: list[int] | None = None):
        names = tuple(shape)
        if names[0] != "data" or len(names) > 2 or any(a not in AXES for a in names[1:]):
            raise ValueError(f"a mesh is data plus at most one of {AXES}, got {names}")
        self.shape = dict(shape)
        self.axis_names = names
        self.size = math.prod(shape.values())
        job = dist.get_world_size() if dist.is_initialized() else 1
        self.ranks = list(range(self.size)) if ranks is None else list(ranks)
        if len(self.ranks) != self.size or max(self.ranks) >= job:
            raise ValueError(f"a mesh of {self.size} ranks {shape} does not fit a job of {job}")
        me = dist.get_rank() if dist.is_initialized() else 0
        self.member = me in self.ranks
        idx = self.ranks.index(me) if self.member else None
        sizes = [shape[a] for a in names]
        self.coords = {}
        if idx is not None:
            for a, n in zip(reversed(names), reversed(sizes)):
                self.coords[a] = idx % n
                idx //= n
        self.groups = {}
        self.world_group = None
        if not dist.is_initialized():
            return
        # one group for every line of every axis, created in the same order on every rank
        for axis in names:
            pos = names.index(axis)
            for other in _product([range(n) for i, n in enumerate(sizes) if i != pos]):
                line = []
                for k in range(sizes[pos]):
                    c = list(other)
                    c.insert(pos, k)
                    line.append(self.ranks[_ravel(c, sizes)])
                g = dist.new_group(line)
                if self.member and me in line:
                    self.groups[axis] = g
        self.world_group = dist.new_group(self.ranks) if self.size < job else dist.group.WORLD

    @property
    def rank0(self) -> bool:
        """The mesh's first rank: it alone writes files."""
        return self.member and all(c == 0 for c in self.coords.values())

    def global_rank(self, **coords) -> int:
        """The job rank at `coords` (this rank's coordinates elsewhere)."""
        c = [coords.get(a, self.coords[a]) for a in self.axis_names]
        return self.ranks[_ravel(c, [self.shape[a] for a in self.axis_names])]


def _product(ranges):
    out = [()]
    for r in ranges:
        out = [o + (v,) for o in out for v in r]
    return out


def _ravel(coords, sizes) -> int:
    i = 0
    for c, n in zip(coords, sizes):
        i = i * n + c
    return i


def make_mesh(n_data: int | None = None, ranks: list[int] | None = None) -> Mesh:
    """1-D data-parallel mesh over the job's ranks (or its first `n_data`)."""
    job = dist.get_world_size() if dist.is_initialized() else 1
    n = n_data or (len(ranks) if ranks else job)
    return Mesh({"data": n}, ranks if ranks is not None else list(range(n)))


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def shard_rows(x: torch.Tensor, index: int, n: int) -> torch.Tensor:
    """Rows [index * B / n, (index + 1) * B / n) of x's leading axis."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not divide over {n} data ranks")
    return x[index * (b // n):(index + 1) * (b // n)]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every (B, ...) tensor of a batch (a pytree)."""
    n, d = mesh.shape["data"], mesh.coords["data"]
    return tree_map(lambda x: shard_rows(x, d, n) if isinstance(x, torch.Tensor) else x, batch)


# -- collectives --------------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place, without autograd; nothing outside a job."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the gradients over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`, with autograd."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    """The identity; the backward sums the gradients over the group (the
    input of a layer whose output channels the group shares)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def _gather(x: torch.Tensor, dim: int, sizes: list[int], group) -> torch.Tensor:
    """Concatenate each rank's x along `dim` (rank i's holds sizes[i]); the
    pieces travel padded to the largest, as gloo gathers equal shapes."""
    top = max(sizes)
    x = x.contiguous()
    if x.shape[dim] < top:
        pad = list(x.shape)
        pad[dim] = top - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    parts = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(parts, x, group=group)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim)


class _GatherOwnSlice(torch.autograd.Function):
    """All-gather along `dim`; the backward keeps this rank's own slice of
    the gradient. Every rank of the group computes the same function of the
    gathered tensor, so each already holds the whole gradient: summing it
    over the group (what `all_gather`'s autograd does) would count it once
    a rank."""

    @staticmethod
    def forward(ctx, x, dim, sizes, group):
        ctx.dim, ctx.start, ctx.n = dim, sum(sizes[:dist.get_rank(group)]), x.shape[dim]
        return _gather(x, dim, sizes, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None, None, None


def gather_own_slice(x: torch.Tensor, dim: int, sizes: list[int], group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _GatherOwnSlice.apply(x, dim, list(sizes), group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated along the batch, without autograd."""
    n = group_size(group)
    if n == 1:
        return x
    return _gather(x, 0, [x.shape[0]] * n, group)


def reduce_logs(logs: dict, group, n: int) -> dict:
    """0-d logs over a group: `max_*` by their maximum, `min_*` by their
    minimum, the rest averaged over `n` (the sum divided by n)."""
    if group is None:
        return logs
    out = dict(logs)
    kinds = {"max_": dist.ReduceOp.MAX, "min_": dist.ReduceOp.MIN, "": dist.ReduceOp.SUM}
    for prefix, op in kinds.items():
        keys = [k for k in logs if k.startswith(prefix)
                and (prefix or not k.startswith(("max_", "min_")))]
        if not keys:
            continue
        v = torch.stack([logs[k].to(torch.float64 if logs[k].dtype == torch.float64
                                    else torch.float32) for k in keys])
        dist.all_reduce(v, op=op, group=group)
        if op == dist.ReduceOp.SUM:
            v = v / n
        out.update({k: v[i] for i, k in enumerate(keys)})
    return out


def reduce_gradients(params, group, divisor: int) -> None:
    """Sum the gradients of `params` over `group` and divide by `divisor`,
    in one flat buffer a dtype. Parameters without a gradient are skipped
    (every rank runs the same graph, so they agree)."""
    if group is None:
        return
    by_type: dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_type.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_type.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat /= divisor
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def set_batchnorm_group(model: torch.nn.Module, group) -> torch.nn.Module:
    """Hand each `layers.BatchNorm` of `model` its train-mode reduction group."""
    from popnet_tpu_torch.models.layers import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return model


# -- data parallelism ----------------------------------------------------------------------------

class DataParallel:
    """Data parallelism over `mesh`'s data axis: parameters replicated, the
    batch's rows split, gradients averaged over the data group, BatchNorm
    normalizing by the global batch. The other layouts extend it."""

    name = "dp"

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.data_group = mesh.groups.get("data")

    @property
    def batchnorm_group(self):
        return self.data_group

    def attach(self, model: torch.nn.Module) -> torch.nn.Module:
        """Make `model` (the same weights on every rank) this layout's."""
        return set_batchnorm_group(model, self.batchnorm_group)

    def shard_batch(self, batch):
        return shard_batch(batch, self.mesh)

    def forward(self, model, x):
        return model(x)

    def reduce_gradients(self, model) -> None:
        reduce_gradients(model.parameters(), self.data_group, self.n_data)

    def reduce_logs(self, logs: dict) -> dict:
        return reduce_logs(logs, self.data_group, self.n_data)

    def reduce_mean(self, value: torch.Tensor) -> torch.Tensor:
        """A scalar's mean over the data group."""
        v = value.detach().clone()
        return all_reduce(v, self.data_group) / self.n_data

    def model_state_dict(self, model) -> dict:
        """The model's state dict in the one-device layout (on every rank)."""
        return model.state_dict()

    def optimizer_state_dict(self, model, optimizer) -> dict:
        return optimizer.state_dict()

    def load_state(self, model, optimizer, model_sd: dict, opt_sd: dict | None) -> None:
        """Load a one-device layout's state dicts into this rank's model."""
        model.load_state_dict(model_sd)
        if opt_sd is not None:
            optimizer.load_state_dict(opt_sd)
