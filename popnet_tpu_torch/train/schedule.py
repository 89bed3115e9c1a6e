"""Learning-rate controllers, stepped once an epoch with a metric (plain
Python copies of `popnet_tpu/train/schedule.py`, so the rates equal the
JAX package's for any sequence of metrics).

- `ReduceLROnPlateau`: mode 'min', factor 0.8, patience 5, threshold 1e-4
  relative, cooldown 3, min_lr 0 (the CPM recipe's);
- `StepLR`: lr0 * gamma^(epoch // step_size);
- `WarmupCosine`: linear warmup, then cosine decay to `min_lr`.

Each has `.step(metric) -> lr` and `.best`; the Trainer checkpoints their
attributes (`vars`) whole.
"""

from __future__ import annotations

import math


class WarmupCosine:
    """Linear warmup then cosine decay to `min_lr` over `total_epochs`."""

    def __init__(self, lr: float, total_epochs: int, warmup_epochs: int = 0,
                 min_lr: float = 0.0):
        self.lr0 = lr
        self.total = total_epochs
        self.warmup = warmup_epochs
        self.min_lr = min_lr
        self.epoch = 0
        self.lr = self.lr_for(0)
        self.best = None

    def lr_for(self, e: int) -> float:
        if self.warmup > 0 and e < self.warmup:
            return self.lr0 * (e + 1) / self.warmup
        t = min(max(e - self.warmup, 0) / max(self.total - self.warmup, 1), 1.0)
        return self.min_lr + (self.lr0 - self.min_lr) * 0.5 * (1.0 + math.cos(math.pi * t))

    @property
    def initial_lr(self) -> float:
        return self.lr_for(0)

    def step(self, metric: float) -> float:
        if self.best is None or metric < self.best:
            self.best = metric
        self.epoch += 1
        self.lr = self.lr_for(self.epoch)
        return self.lr


class StepLR:
    """lr = lr0 * gamma^(epoch // step_size); the metric only sets `.best`."""

    def __init__(self, lr: float, step_size: int = 10, gamma: float = 0.2):
        self.lr0 = lr
        self.lr = lr
        self.step_size = step_size
        self.gamma = gamma
        self.epoch = 0
        self.best = None

    def step(self, metric: float) -> float:
        if self.best is None or metric < self.best:
            self.best = metric
        self.epoch += 1
        self.lr = self.lr0 * self.gamma ** (self.epoch // self.step_size)
        return self.lr


class ReduceLROnPlateau:
    """torch's ReduceLROnPlateau, as a controller of a float rate."""

    def __init__(self, lr: float, mode: str = "min", factor: float = 0.8,
                 patience: int = 5, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 3, min_lr: float = 0.0):
        assert mode in ("min", "max") and threshold_mode in ("rel", "abs")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, current, best):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < best * (1.0 - self.threshold)
            return current < best - self.threshold
        if self.threshold_mode == "rel":
            return current > best * (1.0 + self.threshold)
        return current > best + self.threshold

    def step(self, metric: float) -> float:
        """Record an epoch metric; returns the (possibly reduced) rate."""
        if self.best is None or self._is_better(metric, self.best):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr
