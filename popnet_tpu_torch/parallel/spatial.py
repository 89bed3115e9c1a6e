"""Spatial parallelism: height bands over a ("data", "spatial") mesh, with
explicit halo exchange (the JAX package's `popnet_tpu/parallel/spatial.py`,
where GSPMD inserts the exchanges).

Rank j of a spatial group of n holds rows [floor(j H / n), floor((j + 1) H
/ n)) of every NCHW activation of global height H (`bands`): any H, so a
band boundary need not fall on a stride, and a layer's window may cross
two bands or more. Under `SpatialMode` each conv and pool of the model
(`F.conv2d`, `F.avg_pool2d`, `F.max_pool2d`) is computed for this rank's
band of its output: `_Halo` fetches the input rows that band's windows
cover from the ranks that own them (send/recv forward, the reverse
backward, where each row's gradient returns to its owner and is added),
pads the frame's global top and bottom as the layer pads (zeros for the
convs and for `avg_pool_3x3_s2`, which counts its padding; -inf for the
max pools, where the activations after LeakyReLU are negative), and the op
runs on those rows with its height padding taken off. A group of one rank
has no rows to swap: there each op runs as it is.

Every other op is elementwise along the height, and each tensor whose
height is banded carries the global height as an attribute (`_sp_height`,
passed on to the outputs of the same local height). BatchNorm reduces
over the data and spatial groups (the mesh's whole group). The outputs
are gathered whole on every rank of the spatial group (their backward
keeps each rank's own band), so the loss and the batch-parallel decode
read whole maps; a train step's loss is then the global mean, and the
gradients are summed over the spatial group and averaged over the data
group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_map

from popnet_tpu_torch.parallel.mesh import (DataParallel, Mesh, gather_own_slice, gather_rows,
                                            reduce_gradients, shard_batch, shard_rows)

_TAG = "_sp_height"


def bands(height: int, n: int) -> list[int]:
    """The n + 1 band boundaries of `height` rows over n ranks."""
    return [i * height // n for i in range(n + 1)]


def _pair(v) -> tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _plan(height: int, k: int, s: int, p: int, n: int, j: int):
    """For rank j of n, an op of kernel k, stride s and padding p along a
    height of `height` rows: (out_height, pieces, sends). `pieces` lists
    the input rows of this rank's output band in order, as ("pad", count),
    ("own", start, count) (local rows) or ("recv", rank, count); `sends`
    lists (rank, local start, count) for the rows another rank needs."""
    out_h = (height + 2 * p - k) // s + 1
    ob = bands(out_h, n)
    ib = bands(height, n)
    if min(b - a for a, b in zip(ob, ob[1:])) < 1:
        raise ValueError(f"spatial={n} leaves a band of a {out_h}-row map empty "
                         f"(kernel {k}, stride {s} over {height} rows)")

    def need(i):
        return ob[i] * s - p, (ob[i + 1] - 1) * s - p + k

    lo, hi = need(j)
    pieces = []
    if lo < 0:
        pieces.append(("pad", -lo))
    for i in range(n):
        a, b = max(lo, ib[i]), min(hi, ib[i + 1])
        if a < b:
            pieces.append(("own", a - ib[j], b - a) if i == j else ("recv", i, b - a))
    if hi > height:
        pieces.append(("pad", hi - height))
    sends = []
    for i in range(n):
        if i != j:
            a, b = need(i)
            a, b = max(a, ib[j]), min(b, ib[j + 1])
            if a < b:
                sends.append((i, a - ib[j], b - a))
    return out_h, pieces, sends


def _exchange(send: list, recv: list) -> None:
    """Post every send and receive ((tensor, peer) pairs) and wait for all."""
    ops = [dist.P2POp(dist.isend, t, peer) for t, peer in send]
    ops += [dist.P2POp(dist.irecv, t, peer) for t, peer in recv]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Halo(torch.autograd.Function):
    """x (this rank's band, NCHW) -> the input rows of its output band,
    padded at the frame's edges with `fill`."""

    @staticmethod
    def forward(ctx, x, pieces, sends, ranks, fill):
        ctx.pieces, ctx.sends, ctx.ranks, ctx.shape = pieces, sends, ranks, x.shape
        b, c, _, w = x.shape
        outgoing = [(x[:, :, st:st + cnt].contiguous(), ranks[i]) for i, st, cnt in sends]
        parts, incoming = [], []
        for piece in pieces:
            if piece[0] == "pad":
                parts.append(x.new_full((b, c, piece[1], w), fill))
            elif piece[0] == "own":
                parts.append(x[:, :, piece[1]:piece[1] + piece[2]])
            else:
                t = x.new_empty((b, c, piece[2], w))
                incoming.append((t, ranks[piece[1]]))
                parts.append(t)
        _exchange(outgoing, incoming)
        return torch.cat(parts, 2)

    @staticmethod
    def backward(ctx, g):
        grad = g.new_zeros(ctx.shape)
        row, outgoing = 0, []
        for piece in ctx.pieces:
            cnt = piece[1] if piece[0] == "pad" else piece[2]
            if piece[0] == "own":
                grad[:, :, piece[1]:piece[1] + cnt] += g[:, :, row:row + cnt]
            elif piece[0] == "recv":
                outgoing.append((g[:, :, row:row + cnt].contiguous(), ctx.ranks[piece[1]]))
            row += cnt
        incoming = [(g.new_empty((g.shape[0], g.shape[1], cnt, g.shape[3])), ctx.ranks[i])
                    for i, _, cnt in ctx.sends]
        _exchange(outgoing, incoming)
        for (t, _), (_, st, cnt) in zip(incoming, ctx.sends):
            grad[:, :, st:st + cnt] += t
        return grad, None, None, None, None


def _tag(t, height: int):
    setattr(t, _TAG, height)
    return t


class SpatialMode(TorchFunctionMode):
    """Computes convs and pools band by band over `group` (see the module
    docstring); `ranks` are the group's job ranks in group order."""

    def __init__(self, group, ranks: list[int]):
        super().__init__()
        self.group, self.ranks = group, ranks
        self.n = len(ranks)
        self.j = dist.get_rank(group) if self.n > 1 else 0

    def _banded(self, op, x, k, s, p, fill, call):
        height = getattr(x, _TAG, None)
        if height is None:
            raise RuntimeError(f"spatial: the input of {op} carries no band (an op the "
                               "spatial mode does not follow changed its height)")
        if self.n == 1:
            y = call(x, p)
            return _tag(y, y.shape[-2])
        out_h, pieces, sends = _plan(height, k, s, p, self.n, self.j)
        ext = _Halo.apply(x, pieces, sends, self.ranks, fill)
        return _tag(call(ext, 0), out_h)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.conv2d:
            return self._conv(*args, **kwargs)
        if func is F.avg_pool2d:
            return self._avg_pool(*args, **kwargs)
        if func is F.max_pool2d:
            return self._max_pool(*args, **kwargs)
        out = func(*args, **kwargs)
        heights = {(t.shape[-2], getattr(t, _TAG)) for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor) and hasattr(t, _TAG)}
        if heights:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.dim() >= 4:
                    for local, height in heights:
                        if t.shape[-2] == local:
                            _tag(t, height)
        return out

    def _conv(self, x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
        (s, sw), (p, pw) = _pair(stride), _pair(padding)
        if _pair(dilation) != (1, 1) or isinstance(padding, str):
            raise NotImplementedError("spatial: dilated or string-padded convs")
        return self._banded("conv2d", x, weight.shape[2], s, p, 0.0, lambda t, ph: torch.conv2d(
            t, weight, bias, (s, sw), (ph, pw), 1, groups))

    def _avg_pool(self, x, kernel_size, stride=None, padding=0, ceil_mode=False,
                  count_include_pad=True, divisor_override=None):
        (k, kw), (p, pw) = _pair(kernel_size), _pair(padding)
        s, sw = _pair(stride if stride is not None else kernel_size)
        if ceil_mode or (p and not count_include_pad) or divisor_override:
            raise NotImplementedError("spatial: avg_pool2d counts its padding rows here")
        return self._banded("avg_pool2d", x, k, s, p, 0.0, lambda t, ph: F.avg_pool2d(
            t, (k, kw), (s, sw), (ph, pw), False, count_include_pad))

    def _max_pool(self, x, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                  return_indices=False):
        (k, kw), (p, pw) = _pair(kernel_size), _pair(padding)
        s, sw = _pair(stride if stride is not None else kernel_size)
        if ceil_mode or return_indices or _pair(dilation) != (1, 1):
            raise NotImplementedError("spatial: max_pool2d with ceil_mode, indices or dilation")
        return self._banded("max_pool2d", x, k, s, p, float("-inf"), lambda t, ph: F.max_pool2d(
            t, (k, kw), (s, sw), (ph, pw)))


def _group_ranks(mesh: Mesh) -> list[int]:
    return [mesh.global_rank(spatial=i) for i in range(mesh.shape["spatial"])]


def forward_bands(model, x: torch.Tensor, group, ranks: list[int]):
    """model(x) with x's height banded over `group` (x: the whole NCHW
    tensor of this data shard); the outputs come back whole on every rank
    of the group, each with autograd to its own band."""
    n = len(ranks)
    j = dist.get_rank(group) if n > 1 else 0
    b = bands(x.shape[2], n)
    band = _tag(x[:, :, b[j]:b[j + 1]], x.shape[2])
    with SpatialMode(group, ranks):
        out = model(band)
    done = {}

    def whole(t):
        if not isinstance(t, torch.Tensor):
            return t
        if id(t) not in done:
            height = getattr(t, _TAG, None)
            if height is None:
                raise RuntimeError("spatial: an output of the model carries no band")
            sizes = [hi - lo for lo, hi in zip(bands(height, n), bands(height, n)[1:])]
            done[id(t)] = gather_own_slice(t, t.dim() - 2, sizes, group)
        return done[id(t)]

    return tree_map(whole, out)


class SpatialParallel(DataParallel):
    """Height bands over the mesh's spatial axis, data parallelism over its
    data axis (see the module docstring)."""

    name = "sp"

    def __init__(self, mesh: Mesh):
        super().__init__(mesh)
        self.n_spatial = mesh.shape["spatial"]
        self.spatial_group = mesh.groups.get("spatial")
        self.spatial_ranks = _group_ranks(mesh)

    @property
    def batchnorm_group(self):
        return self.mesh.world_group

    def forward(self, model, x):
        return forward_bands(model, x, self.spatial_group, self.spatial_ranks)

    def reduce_gradients(self, model) -> None:
        reduce_gradients(model.parameters(), self.mesh.world_group, self.n_data)


class SpatialModel(torch.nn.Module):
    """`net` (a module or a function: NCHW in, a pytree of NCHW maps out) run under the spatial
    layout for inference: the global batch goes in on every rank, each
    rank takes its data rows and its band, and every rank gets the whole
    outputs back. A batch the data axis does not divide (a ragged tail)
    runs on the plain path."""

    def __init__(self, net, mesh: Mesh):
        super().__init__()
        self.net, self.layout = net, SpatialParallel(mesh)

    def forward(self, x):
        lay = self.layout
        if x.shape[0] % lay.n_data:
            return self.net(x)
        rows = shard_rows(x, lay.mesh.coords["data"], lay.n_data)
        out = lay.forward(self.net, rows)
        return tree_map(lambda t: gather_rows(t.contiguous(), lay.data_group)
                        if isinstance(t, torch.Tensor) else t, out)


# -- the JAX module's entry points ----------------------------------------------------------------

def make_spatial_mesh(n_spatial: int = 2, n_data: int | None = None) -> Mesh:
    """A (n_data, n_spatial) mesh over the job's ranks; n_data defaults to
    the job's size over n_spatial."""
    job = dist.get_world_size() if dist.is_initialized() else 1
    n_data = n_data or job // n_spatial
    if n_data * n_spatial > job or n_data < 1:
        raise ValueError(f"{job} ranks cannot hold a (data={n_data}, spatial={n_spatial}) mesh")
    return Mesh({"data": n_data, "spatial": n_spatial})


def shard_batch_spatial(batch, mesh: Mesh):
    """This rank's data rows of a batch; the bands are cut as the step's
    forward reads the image (`SpatialParallel.forward`)."""
    return shard_batch(batch, mesh)


def jit_forward_spatial(apply_fn, mesh: Mesh) -> SpatialModel:
    """apply_fn (NCHW images -> maps; a module or a function) with the
    input height banded over `mesh`; the outputs come back whole on every
    rank."""
    return SpatialModel(apply_fn, mesh)


def replicate_state(state, mesh: Mesh):
    """A TrainState under the spatial layout: parameters replicated,
    BatchNorm over the whole mesh."""
    state.layout = SpatialParallel(mesh)
    state.layout.attach(state.model)
    return state


def jit_step_spatial(step, mesh: Mesh):
    """`step` for states that `replicate_state` put under the spatial layout."""
    def spatial_step(state, batch):
        if not isinstance(state.layout, SpatialParallel):
            raise ValueError("jit_step_spatial: the state is not under the spatial layout "
                             "(replicate_state)")
        return step(state, batch)

    return spatial_step

