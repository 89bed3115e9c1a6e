"""Flax variables -> torch state dict, numpy only.

The JAX package saves a model's variables as one .npz whose keys are
'/'-joined Flax paths (`params/stem/Conv_0/kernel`,
`batch_stats/stem/BatchNorm_0/mean`, ...) with float16 values. The port's
modules carry the Flax auto-names as attribute names, so the mapping is by
name: conv `kernel` HWIO -> `weight` OIHW, BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var. `load_sgd_momentum` carries the
trace of a JAX train state's SGD-Nesterov optimizer (optax `trace`, keyed
by the same paths) into a torch SGD's momentum buffers, and
`load_adam_state` the moments and count of its Adam (optax
`scale_by_adam`) into a torch Adam's state, so a JAX run can continue in
the port.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def load_npz(path) -> dict[str, np.ndarray]:
    """Read a variables .npz into {flax path: float32 array}."""
    with np.load(path) as data:
        return {k: np.asarray(data[k], np.float32) for k in data.files}


def state_dict_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map '/'-joined Flax paths onto state-dict keys of the port's modules
    (float32 tensors, float64 where the value is float64).

    Raises ValueError on any key it cannot map."""
    out: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        parts = key.split("/")
        leaf = _LEAF.get((parts[0], parts[-1]))
        if leaf is None or len(parts) < 3:
            raise ValueError(f"unmapped Flax variable {key!r}")
        arr = np.asarray(value)
        arr = arr.astype(np.float64 if arr.dtype == np.float64 else np.float32, copy=False)
        if parts[-1] == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{key!r}: expected an HWIO kernel, got {arr.shape}")
            arr = arr.transpose(3, 2, 0, 1)
        name = ".".join(parts[1:-1] + [leaf])
        if name in out:
            raise ValueError(f"two Flax variables map onto {name!r}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_into(module: torch.nn.Module, flat: dict[str, np.ndarray]) -> torch.nn.Module:
    """Load Flax variables into `module`; raises on a key left unmapped on
    either side (BatchNorm's `num_batches_tracked` counters excepted)."""
    sd = state_dict_from_jax(flat)
    want = {k for k in module.state_dict() if not k.endswith("num_batches_tracked")}
    missing, extra = sorted(want - sd.keys()), sorted(sd.keys() - want)
    if missing or extra:
        raise ValueError(f"weights do not fit the module: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    module.load_state_dict(sd, strict=False)
    return module


def flat_from_module(module: torch.nn.Module) -> dict[str, np.ndarray]:
    """The inverse of `state_dict_from_jax` on a module of the port: its
    convs' and BatchNorms' tensors as '/'-joined Flax paths (kernels HWIO),
    float32 numpy arrays, in the module's order."""
    flat: dict[str, np.ndarray] = {}
    for name, m in module.named_modules():
        scope = name.replace(".", "/")
        if isinstance(m, torch.nn.Conv2d):
            leaves = (("params", "kernel", m.weight), ("params", "bias", m.bias))
        elif isinstance(m, torch.nn.BatchNorm2d):
            leaves = (("params", "scale", m.weight), ("params", "bias", m.bias),
                      ("batch_stats", "mean", m.running_mean),
                      ("batch_stats", "var", m.running_var))
        else:
            continue
        for collection, leaf, t in leaves:
            if t is not None:
                arr = t.detach().float().cpu().numpy()
                flat[f"{collection}/{scope}/{leaf}"] = (arr.transpose(2, 3, 1, 0)
                                                        if leaf == "kernel" else arr)
    return flat


def load_sgd_momentum(module: torch.nn.Module, optimizer: torch.optim.Optimizer,
                      flat_trace: dict[str, np.ndarray]) -> torch.optim.Optimizer:
    """Set each parameter's `momentum_buffer` in `optimizer` (a torch SGD
    over `module`'s parameters) from optax's trace, given as
    {'params/<path>/kernel' | '.../bias' | '.../scale': array}; raises on a
    parameter the trace leaves out or a trace key no parameter takes."""
    bufs = _per_parameter(module, flat_trace, "trace")
    for name, p in module.named_parameters():
        optimizer.state[p]["momentum_buffer"] = bufs[name].to(device=p.device, dtype=p.dtype)
    return optimizer


def _per_parameter(module: torch.nn.Module, flat: dict[str, np.ndarray], what: str) -> dict:
    """{parameter name: tensor} from optax's per-parameter tree, given as
    {'params/<path>/kernel' | '.../bias' | '.../scale': array}; raises on a
    parameter it leaves out or a key no parameter takes."""
    values = state_dict_from_jax(flat)
    params = dict(module.named_parameters())
    missing, extra = sorted(params.keys() - values.keys()), sorted(values.keys() - params.keys())
    if missing or extra:
        raise ValueError(f"{what} does not fit the module: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    return values


def load_adam_state(module: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    flat_mu: dict[str, np.ndarray], flat_nu: dict[str, np.ndarray],
                    count: int) -> torch.optim.Optimizer:
    """Set `optimizer` (a torch Adam over `module`'s parameters) to the
    state of optax's `scale_by_adam` after `count` steps: mu is torch's
    `exp_avg`, nu its `exp_avg_sq` (both keyed as `load_sgd_momentum`'s
    trace), and the count its `step`, so the next step's bias correction
    is the same. Raises on a tree that does not fit the module."""
    mu = _per_parameter(module, flat_mu, "mu")
    nu = _per_parameter(module, flat_nu, "nu")
    for name, p in module.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype),
        }
    return optimizer
