"""The reference's PyTorch checkpoints into the port's models, and back.

The port of `popnet_tpu/interop/torch_import.py`: the reference's `.pth`
files (the `module.`-prefixed state dicts every reference evaluation
script loads) import into `RTPoseLight3D`, `RTPoseAlign3D`, `RTPoseLight`,
`YoloPoseNet` and `A2J`, and `export_state_dict` writes a model back into
a reference-keyed state dict.

Pairing: the reference dict is walked as typed units (conv {weight[,
bias]}, bn {weight, bias, running_mean, running_var}, linear {weight[,
bias]}) in its key order, and the port's modules as the same units, in
the Flax creation order the JAX importer pairs with (the dict order of the
first trace of `init`). The port's modules carry the Flax names and
register in that order, so the walk is `named_modules()`;
tests/test_torch_reference_checkpoint.py holds every family's import equal
to the JAX importer's carried across by `from_jax`, exactly. Each pair is
checked as JAX checks it: kind, shape and bias presence, and (with
`strict`) the unit count, so structural drift raises a ValueError instead
of misassigning. The port's convs are OIHW like the reference's and its
linears (out, in): nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# the reference's A2J registers its heads as (regression, classification,
# depth) but the Flax model creates (classification, regression, depth)
A2J_ORDER = ("Backbone.", "classificationModel.", "regressionModel.", "DepthRegressionModel.")
A2J_DEAD = ("Backbone.model.fc.",)          # resnet50's fc, registered and never run
YOLO_DEAD = ("model0.layer3.",)             # resnet34's layer3, registered and never run
VGG_TRUNK = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3",
             "conv3_4", "conv4_1", "conv4_2")


def strip_module_prefix(state_dict: dict) -> dict:
    """Drop the DataParallel 'module.' prefix of every key that has it."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def _numpy(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)


def _torch_units(state_dict: dict, skip_prefixes=(), reorder_prefixes=None) -> list:
    """The reference dict as ordered (kind, name, {leaf: array}) units,
    without `skip_prefixes` and num_batches_tracked, bucketed by
    `reorder_prefixes` (stable within a bucket) when given."""
    items = [(k, _numpy(v)) for k, v in state_dict.items()
             if "num_batches_tracked" not in k and not any(k.startswith(p) for p in skip_prefixes)]
    units = []
    i = 0
    while i < len(items):
        prefix = items[i][0].rsplit(".", 1)[0]
        group = {}
        while i < len(items) and items[i][0].rsplit(".", 1)[0] == prefix:
            group[items[i][0].rsplit(".", 1)[1]] = items[i][1]
            i += 1
        if "running_mean" in group:
            units.append(("bn", prefix, group))
        elif group["weight"].ndim == 4:
            units.append(("conv", prefix, group))
        elif group["weight"].ndim == 2:
            units.append(("linear", prefix, group))
        else:
            raise ValueError(f"unclassifiable torch unit {prefix}: "
                             f"{ {k: v.shape for k, v in group.items()} }")
    if reorder_prefixes:
        buckets = [[] for _ in reorder_prefixes]
        for u in units:
            for bi, p in enumerate(reorder_prefixes):
                if u[1].startswith(p):
                    buckets[bi].append(u)
                    break
            else:
                raise ValueError(f"torch unit {u[1]} matches no reorder prefix")
        units = [u for b in buckets for u in b]
    return units


def _port_units(model: nn.Module) -> list:
    """The model's (kind, name, module) units in the Flax creation order."""
    units = []
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            units.append(("conv", name, m))
        elif isinstance(m, nn.BatchNorm2d):
            units.append(("bn", name, m))
        elif isinstance(m, nn.Linear):
            units.append(("linear", name, m))
    return units


def _pairs(model: nn.Module, state_dict: dict, skip_prefixes, reorder_prefixes, strict: bool,
           importing: bool):
    tunits = _torch_units(strip_module_prefix(state_dict), skip_prefixes, reorder_prefixes)
    punits = _port_units(model)
    if strict and len(tunits) != len(punits):
        raise ValueError(f"unit count mismatch: torch {len(tunits)} vs port {len(punits)}")
    for (tk, tname, tg), (pk, pname, m) in zip(tunits, punits):
        where = f"{tname} -> {pname}" if importing else f"{pname} -> {tname}"
        if tk != pk:
            raise ValueError(f"unit kind mismatch at {where}: {tk} vs {pk}")
        if tk != "bn" and ("bias" in tg) != (m.bias is not None):
            raise ValueError(f"bias presence mismatch at {where}: "
                             f"port={m.bias is not None} torch={'bias' in tg}")
        yield tk, tname, tg, m, where


def _leaves(kind: str, m: nn.Module) -> dict:
    """{reference leaf: the module's tensor} of one unit."""
    if kind == "bn":
        return {"weight": m.weight, "bias": m.bias, "running_mean": m.running_mean,
                "running_var": m.running_var}
    return {"weight": m.weight} if m.bias is None else {"weight": m.weight, "bias": m.bias}


def _check_shape(where: str, port_shape, torch_shape) -> None:
    if tuple(port_shape) != tuple(torch_shape):
        raise ValueError(f"shape mismatch at {where}: port {tuple(port_shape)} "
                         f"vs torch {tuple(torch_shape)}")


def import_state_dict(model: nn.Module, state_dict: dict, skip_prefixes=(),
                      reorder_prefixes=None, strict: bool = True) -> nn.Module:
    """Load a reference state dict into `model` in place; returns it.

    `skip_prefixes`: reference keys to ignore (the dead branches the
    reference registers and never runs). `reorder_prefixes`: where the
    reference registers units in another order than the Flax model creates
    them, the ordered key prefixes of the Flax order (units bucket by their
    first matching prefix, stable within a bucket). Raises ValueError on a
    kind, shape, bias or (with `strict`) count mismatch, before any tensor
    of the model changes."""
    staged = []
    for kind, _, tg, m, where in _pairs(model, state_dict, skip_prefixes, reorder_prefixes,
                                        strict, importing=True):
        for leaf, dst in _leaves(kind, m).items():
            _check_shape(where, dst.shape, tg[leaf].shape)
            staged.append((dst, tg[leaf]))
    with torch.no_grad():
        for dst, value in staged:
            dst.copy_(torch.from_numpy(np.ascontiguousarray(value)).to(dst.dtype))
    return model


def import_rtpose_light3d(model: nn.Module, state_dict: dict) -> nn.Module:
    """RTPoseLight3D, RTPoseLight and RTPoseAlign3D: the reference registers
    in the creation order, the generic walk applies."""
    return import_state_dict(model, state_dict)


import_rtpose_light = import_rtpose_light3d
import_rtpose_align3d = import_rtpose_light3d


def import_yolo_posenet(model: nn.Module, state_dict: dict) -> nn.Module:
    """YoloPoseNet: the reference registers resnet34's layer3 and never
    runs it; those weights are skipped."""
    return import_state_dict(model, state_dict, skip_prefixes=YOLO_DEAD)


def import_a2j(model: nn.Module, state_dict: dict) -> nn.Module:
    """A2J: the heads reordered to the creation order (backbone,
    classification, regression, depth) and resnet50's dead fc skipped."""
    return import_state_dict(model, state_dict, skip_prefixes=A2J_DEAD,
                             reorder_prefixes=A2J_ORDER)


def use_vgg(model: nn.Module, vgg19_state_dict: dict) -> nn.Module:
    """torchvision VGG19's ImageNet weights into an RTPoseVGG's trunk: its
    first 20 tensors, in order, are conv1_1 .. conv4_2's weights and
    biases (the reference's use_vgg); the two CPM convs keep their init."""
    tensors = [_numpy(v) for v in vgg19_state_dict.values()][:2 * len(VGG_TRUNK)]
    staged = []
    for i, name in enumerate(VGG_TRUNK):
        conv = getattr(model.trunk, name)
        for dst, value in ((conv.weight, tensors[2 * i]), (conv.bias, tensors[2 * i + 1])):
            _check_shape(name, dst.shape, value.shape)
            staged.append((dst, value))
    with torch.no_grad():
        for dst, value in staged:
            dst.copy_(torch.from_numpy(np.ascontiguousarray(value)).to(dst.dtype))
    return model


def export_state_dict(model: nn.Module, template_state_dict: dict, skip_prefixes=(),
                      reorder_prefixes=None) -> dict[str, np.ndarray]:
    """The inverse of `import_state_dict`: `model`'s tensors as a reference
    state dict of NumPy arrays, keyed and ordered like `template_state_dict`
    (a reference net's state dict, its 'module.' prefix dropped: it gives
    the key names and the num_batches_tracked counters). Keys under
    `skip_prefixes` keep the template's values; the same pairing and checks
    as the import, the unit count always."""
    out = {k: _numpy(v) for k, v in strip_module_prefix(template_state_dict).items()}
    for kind, tname, _, m, where in _pairs(model, template_state_dict, skip_prefixes,
                                           reorder_prefixes, strict=True, importing=False):
        for leaf, src in _leaves(kind, m).items():
            key = f"{tname}.{leaf}"
            if key not in out:
                raise ValueError(f"export target key missing at {where}: {key}")
            _check_shape(where, src.shape, out[key].shape)
            out[key] = src.detach().cpu().numpy().astype(out[key].dtype)
    return out


def export_rtpose_light3d(model: nn.Module, template_state_dict: dict) -> dict:
    """RTPoseLight3D, RTPoseLight and RTPoseAlign3D: the generic walk."""
    return export_state_dict(model, template_state_dict)


export_rtpose_light = export_rtpose_light3d
export_rtpose_align3d = export_rtpose_light3d


def export_yolo_posenet(model: nn.Module, template_state_dict: dict) -> dict:
    """YoloPoseNet: the dead layer3 keeps the template's values."""
    return export_state_dict(model, template_state_dict, skip_prefixes=YOLO_DEAD)


def export_a2j(model: nn.Module, template_state_dict: dict) -> dict:
    """A2J: `import_a2j`'s reordering and dead fc, mirrored."""
    return export_state_dict(model, template_state_dict, skip_prefixes=A2J_DEAD,
                             reorder_prefixes=A2J_ORDER)


def load_torch_checkpoint(path) -> dict:
    """A reference `.pth` checkpoint's state dict (its 'state_dict' entry
    where it wraps one), loaded to the CPU without unpickling code."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd
