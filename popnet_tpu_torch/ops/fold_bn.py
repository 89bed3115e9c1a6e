"""Inference-time BatchNorm folding (the JAX package's `ops/fold_bn.py`).

At inference a BatchNorm is the per-channel affine map
`y = (x - mean) * scale / sqrt(var + eps) + beta`; when it directly follows
a convolution, the multiplicative part folds into the conv's kernel and the
additive part into the conv's bias. The fold is exact algebra on the
checkpoint: no calibration, any wire format.

`fold_batchnorm` works on the flat '/'-joined Flax variables the port loads
(`interop.load_npz`) with the JAX function's contract and arithmetic
(eager float32), so the folded dict equals JAX's bit for bit:

- it pairs `Conv_i` / `BatchNorm_i` siblings of one scope, and skips a pair
  whose BatchNorm width differs from the conv's output width;
- a conv with a bias takes the whole BatchNorm; a bias-free conv leaves
  the BatchNorm as a pure bias (scale 1, mean 0, var 1 - eps, bias
  `beta - mean * k`);
- a second fold changes nothing, and eps is Flax's 1e-5.

XLA constant-folds the neutral BatchNorm away under jit; eager PyTorch does
not, so `fuse_folded` then moves each folded BatchNorm's bias into its
conv's bias and replaces the BatchNorm with `nn.Identity`: without that the
fold saves nothing on the card. In float32, (1 - 1e-5) + 1e-5 == 1.0
exactly, so a folded BatchNorm in eval mode is `x + bias`, and the fused
module equals the unfused folded one but for where that add rounds.
`fold_module` does both on a model in place.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["fold_batchnorm", "fold_module", "fuse_folded"]

# Flax's BatchNorm default, which every model of the port keeps (`models.layers.BatchNorm`)
_BN_EPS = 1e-5


def _nest(flat: dict) -> dict:
    """{'a/b/c': v} -> {'a': {'b': {'c': v}}}, keeping the keys' order."""
    tree: dict = {}
    for key, value in flat.items():
        *scopes, leaf = key.split("/")
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = value
    return tree


def _leaf(tree: dict, key: str):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def _fold_scope(pnode: dict, snode: dict, folded: list, path: str) -> None:
    """Fold every Conv_i / BatchNorm_i sibling pair in this scope, then
    recurse into the child scopes (the JAX function's order)."""
    f32 = np.float32
    for key in list(pnode.keys()):
        if not key.startswith("BatchNorm_"):
            continue
        conv_key = "Conv_" + key.split("_", 1)[1]
        conv = pnode.get(conv_key)
        bn_p = pnode[key]
        bn_s = snode.get(key)
        if conv is None or bn_s is None or "kernel" not in conv:
            continue
        kernel = np.asarray(conv["kernel"])
        scale = np.asarray(bn_p["scale"], f32)
        beta = np.asarray(bn_p["bias"], f32)
        mean = np.asarray(bn_s["mean"], f32)
        var = np.asarray(bn_s["var"], f32)
        if kernel.shape[-1] != scale.shape[0]:
            continue                    # the BatchNorm does not normalize this conv's output
        k = scale / np.sqrt(var + f32(_BN_EPS))
        conv["kernel"] = (kernel.astype(f32) * k).astype(kernel.dtype)
        if "bias" in conv:
            b = np.asarray(conv["bias"])
            conv["bias"] = ((b.astype(f32) - mean) * k + beta).astype(b.dtype)
            residual = np.zeros_like(beta)
        else:
            residual = beta - mean * k  # a bias-free conv: the BatchNorm stays as a bias add
        bn_p["scale"] = np.ones_like(scale)
        bn_p["bias"] = residual
        bn_s["mean"] = np.zeros_like(mean)
        bn_s["var"] = np.full_like(var, 1.0 - _BN_EPS)      # var + eps == 1
        folded.append(f"{path}/{conv_key}")
    for key, child in pnode.items():
        if isinstance(child, dict):
            _fold_scope(child, snode.get(key, {}), folded, f"{path}/{key}")


def fold_batchnorm(weights: dict[str, np.ndarray]) -> tuple[dict[str, np.ndarray], list[str]]:
    """Fold every Conv -> BatchNorm pair of the flat Flax variables
    `weights` ({'params/.../kernel': array, 'batch_stats/.../mean': ...}).
    Returns (a new flat dict with the same keys, the folded conv scopes as
    JAX names them, e.g. '/stem/Conv_0'). `weights` is left as it is."""
    tree = _nest({k: np.array(v) for k, v in weights.items()})
    folded: list[str] = []
    _fold_scope(tree.get("params", {}), tree.get("batch_stats", {}), folded, "")
    return {k: _leaf(tree, k) for k in weights}, folded


def fuse_folded(model: nn.Module, folded_paths: list[str]) -> nn.Module:
    """After `fold_batchnorm`'s weights are loaded into `model`: add each
    folded BatchNorm's bias (its residual term) to its conv's bias, giving
    a bias-free conv one, and replace the BatchNorm with `nn.Identity`.
    Raises on a path whose BatchNorm is not the neutral one the fold
    leaves. Returns `model`, changed in place."""
    for path in folded_paths:
        parent_name, _, conv_key = path.strip("/").rpartition("/")
        parent = model.get_submodule(parent_name.replace("/", "."))
        conv = getattr(parent, conv_key)
        bn_key = "BatchNorm_" + conv_key.split("_", 1)[1]
        bn = getattr(parent, bn_key)
        if not (isinstance(bn, nn.BatchNorm2d) and bool((bn.weight == 1).all())
                and bool((bn.running_mean == 0).all())
                and bool((bn.running_var == np.float32(1.0 - _BN_EPS)).all())):
            raise ValueError(f"{path}: {bn_key} is not a folded BatchNorm")
        with torch.no_grad():
            beta = bn.bias.detach().to(conv.weight.dtype)
            if conv.bias is None:
                conv.bias = nn.Parameter(beta.clone(), requires_grad=conv.weight.requires_grad)
            else:
                conv.bias.add_(beta)
        setattr(parent, bn_key, nn.Identity())
    return model


def fold_module(model: nn.Module) -> list[str]:
    """Fold and fuse every Conv -> BatchNorm pair of `model` in place,
    through its flat Flax variables; returns the folded paths."""
    from popnet_tpu_torch.interop.from_jax import flat_from_module, load_into

    weights, paths = fold_batchnorm(flat_from_module(model))
    load_into(model, weights)
    fuse_folded(model, paths)
    return paths
