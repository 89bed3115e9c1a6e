"""Train state: a model, its optimizer and the learning rate they run at.

The JAX package's optax chains as torch optimizers (`popnet_tpu/train/state.py`):

- `sgd`: `add_decayed_weights(wd)` -> `trace(momentum, nesterov=True)` ->
  `scale_by_learning_rate` is `torch.optim.SGD(momentum, nesterov=True,
  weight_decay)`: the decay is added to the gradient before the momentum,
  the first step's buffer is the gradient itself, and the update is
  g + momentum * buffer;
- `adam`: `add_decayed_weights(wd)` -> `scale_by_adam` is
  `torch.optim.Adam(weight_decay=wd)`, L2 folded into the gradient (not
  AdamW).

The rate is a float32 hyperparameter in JAX (`inject_hyperparams`); here
it is set rounded to float32, so the two update by the same amount.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TrainState:
    """A model, its optimizer and, under a parallel layout
    (`parallel.mesh.DataParallel` and its kin), the layout: the step then
    reads the forward, the gradients' and the logs' reductions from it, and
    the state dicts are the one-device layout's on every rank."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    layout: object = None

    def state_dict(self) -> dict:
        if self.layout is None:
            return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}
        return {"model": self.layout.model_state_dict(self.model),
                "optimizer": self.layout.optimizer_state_dict(self.model, self.optimizer)}

    def load_state_dict(self, sd: dict) -> None:
        if self.layout is None:
            self.model.load_state_dict(sd["model"])
            self.optimizer.load_state_dict(sd["optimizer"])
        else:
            self.layout.load_state(self.model, self.optimizer, sd["model"], sd["optimizer"])


def _f32(x: float) -> float:
    return float(np.float32(x))


def make_optimizer(model: torch.nn.Module, optimizer: str = "sgd", learning_rate: float = 1.0,
                   momentum: float = 0.9, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """The optimizer over `model`'s parameters (on their device)."""
    params = list(model.parameters())
    if optimizer == "sgd":
        return torch.optim.SGD(params, lr=_f32(learning_rate), momentum=momentum,
                               nesterov=momentum > 0, weight_decay=weight_decay)
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=_f32(learning_rate), weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {optimizer!r}")


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the rate (the plateau controller's hook), rounded to float32."""
    for group in state.optimizer.param_groups:
        group["lr"] = _f32(lr)
    return state


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])
