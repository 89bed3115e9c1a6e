"""Tensor parallelism: conv weights sharded by output channel over a
("data", "model") mesh (the JAX package's `popnet_tpu/parallel/tensor.py`).

JAX's rule (`_leaf_spec`) shards a leaf's output-channel dimension over the
model axis where it divides by n_model and the leaf holds at least 8192
elements; GSPMD then inserts the collectives. Here the same rule picks the
convs (a conv weight's dim 0; grouped convs stay whole), and each sharded
conv becomes column-parallel, `ColumnParallelConv2d`:

- the input is copied to the model group: the identity forward, the sum of
  the input gradients over the group backward;
- the rank convolves with its slice of the weight and of the bias;
- the slices are all-gathered over the model group, so the layers after it
  see every channel, replicated; the backward keeps this rank's own slice
  of the gradient (every rank of the group holds the whole gradient of the
  same replicated function, so a sum would count it n_model times).

A rank's parameter is its slice, so the optimizer's moments exist for that
slice only: the ZeRO-style saving JAX gets from sharding the moments like
the parameters. Biases and BatchNorm leaves stay replicated. The gradient
of a sharded conv's bias is nonzero on a rank in its own slice only, so it
is summed over the model group; then every gradient is averaged over the
data group. BatchNorm reduces over the data group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from popnet_tpu_torch.parallel.mesh import (DataParallel, Mesh, copy_to_group,
                                            gather_own_slice, gather_rows, reduce_gradients)

MIN_SIZE = 8192


def shards(conv: nn.Module, n_model: int, min_size: int = MIN_SIZE) -> bool:
    """JAX's rule on a conv: its output channels divide by n_model and its
    weight holds at least `min_size` elements (and it is not grouped)."""
    return (isinstance(conv, nn.Conv2d) and conv.groups == 1 and conv.padding_mode == "zeros"
            and conv.out_channels % n_model == 0 and conv.weight.numel() >= min_size)


class ColumnParallelConv2d(nn.Module):
    """A conv whose output channels are split over `group`: `weight` is
    this rank's slice of the whole weight (rows [r * C / n, (r + 1) * C / n)),
    `bias` the whole bias (replicated). The state-dict keys are the conv's."""

    def __init__(self, conv: nn.Conv2d, group, index: int, n: int):
        super().__init__()
        c = conv.out_channels // n
        self.group, self.index, self.n = group, index, n
        self.lo, self.hi = index * c, (index + 1) * c
        self.out_channels = conv.out_channels
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.weight = nn.Parameter(conv.weight.detach()[self.lo:self.hi].clone())
        self.bias = None if conv.bias is None else nn.Parameter(conv.bias.detach().clone())

    def forward(self, x):
        x = copy_to_group(x, self.group)
        b = None if self.bias is None else self.bias[self.lo:self.hi]
        y = F.conv2d(x, self.weight, b, self.stride, self.padding, self.dilation)
        return gather_own_slice(y, 1, [self.hi - self.lo] * self.n, self.group)


class TensorParallel(DataParallel):
    """Channel sharding over the mesh's model axis and data parallelism over
    its data axis (see the module docstring)."""

    name = "tp"

    def __init__(self, mesh: Mesh, min_size: int = MIN_SIZE):
        super().__init__(mesh)
        self.n_model = mesh.shape["model"]
        self.model_group = mesh.groups.get("model")
        self.min_size = min_size

    def attach(self, model: nn.Module) -> nn.Module:
        """Swap each conv that JAX's rule shards for its column-parallel
        slice (the same weights on every rank go in)."""
        for parent in list(model.modules()):
            for name, child in list(parent.named_children()):
                if shards(child, self.n_model, self.min_size):
                    setattr(parent, name, ColumnParallelConv2d(
                        child, self.model_group, self.mesh.coords["model"], self.n_model))
        return super().attach(model)

    def sharded(self, model: nn.Module) -> dict[str, ColumnParallelConv2d]:
        """The column-parallel convs of `model` by module name."""
        return {n: m for n, m in model.named_modules() if isinstance(m, ColumnParallelConv2d)}

    def reduce_gradients(self, model) -> None:
        biases = [m.bias for m in self.sharded(model).values() if m.bias is not None]
        reduce_gradients(biases, self.model_group, 1)
        super().reduce_gradients(model)

    def _full(self, t: torch.Tensor) -> torch.Tensor:
        return gather_rows(t.detach().contiguous(), self.model_group)

    def model_state_dict(self, model) -> dict:
        """Each sharded weight gathered whole (on every rank of the group)."""
        sd = model.state_dict()
        for name in self.sharded(model):
            sd[f"{name}.weight"] = self._full(sd[f"{name}.weight"])
        return sd

    def optimizer_state_dict(self, model, optimizer) -> dict:
        """The optimizer's state with each sharded weight's moments gathered whole."""
        sd = optimizer.state_dict()
        index = {id(p): i for i, p in enumerate(model.parameters())}
        sliced = {index[id(m.weight)] for m in self.sharded(model).values()}
        sd["state"] = {i: {k: self._full(v) if i in sliced and torch.is_tensor(v) and v.dim()
                           else v for k, v in st.items()} for i, st in sd["state"].items()}
        return sd

    def load_state(self, model, optimizer, model_sd: dict, opt_sd: dict | None) -> None:
        sharded = self.sharded(model)
        model_sd = dict(model_sd)
        for name, m in sharded.items():
            model_sd[f"{name}.weight"] = model_sd[f"{name}.weight"][m.lo:m.hi]
        model.load_state_dict(model_sd)
        if opt_sd is None:
            return
        index = {id(p): i for i, p in enumerate(model.parameters())}
        cut = {index[id(m.weight)]: m for m in sharded.values()}
        opt_sd = dict(opt_sd)
        opt_sd["state"] = {i: {k: v[cut[i].lo:cut[i].hi] if i in cut and torch.is_tensor(v)
                               and v.dim() else v for k, v in st.items()}
                           for i, st in opt_sd["state"].items()}
        optimizer.load_state_dict(opt_sd)


def state_shardings(model: nn.Module) -> dict[str, str | None]:
    """Each parameter's layout on a model that `TensorParallel.attach` made:
    "model" for a slice along dim 0, None for a replicated one."""
    sliced = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, ColumnParallelConv2d)}
    return {n: ("model" if n in sliced else None) for n, _ in model.named_parameters()}

