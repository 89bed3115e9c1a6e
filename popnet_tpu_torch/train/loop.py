"""Epoch-driven trainer on one device (the JAX package's
`popnet_tpu/train/loop.py`): per epoch, train, validate, step the
learning-rate controller on the validation loss, append to
`<out_dir>/history.jsonl` (and, where `tensorboard` imports, the
scalars `train_loss`, `val_loss` and `lr` to a SummaryWriter in
`<out_dir>/tb`), keep the best-validation checkpoint in
`<out_dir>/ckpt_best` (1 kept) and the periodic one in `<out_dir>/ckpt`
(3 kept); `resume` continues from the latest, `resume(best=True)` from the
best. With `profile_epoch`, that epoch's training runs under
torch.profiler (the CPU, and CUDA on a card) and its Chrome trace goes to
`<out_dir>/trace/`.

A checkpoint holds the model, the optimizer (momentum buffers included),
the controller's attributes whole and the state of every generator of the
training dataset (`rng_state`), so a resumed run continues as the
uninterrupted one would (the JAX package restores the rate, `best` and the
epoch of its controller, and its data generators start again from the
seed). The losses of an epoch are read
from the device once, at its end, as in the JAX package.

Over a mesh (`parallel.mesh.Mesh`) the Trainer runs one of the JAX
package's layouts: "dp" (data parallel), "tp" (channel-sharded convs,
`parallel.tensor`) or "sp" (height bands, `parallel.spatial`). Every rank
builds the same seeded model and iterates the same global batches, takes
its rows (`layout.shard_batch`) and steps; the logged losses are the
global batch's. The mesh's first rank alone writes the history and the
checkpoints (in the one-device layout: a sharded conv's weight and moments
gathered whole), and `resume` restores on every rank. Validation follows
JAX's rule: a batch the data axis divides is split and its loss averaged
over the data group; a ragged tail is scored whole on every rank. A batch
size the data axis does not divide shrinks a data-parallel mesh to the
largest divisor (the ranks left out sit the run out); under the other
layouts it raises.
"""

from __future__ import annotations

import copy
import json
import os
import time

import torch

from popnet_tpu_torch.core.device import resolve_device
from popnet_tpu_torch.train import checkpoint as ckpt
from popnet_tpu_torch.train.schedule import ReduceLROnPlateau
from popnet_tpu_torch.train.state import (TrainState, get_learning_rate, make_optimizer,
                                          set_learning_rate)


def make_layout(name: str, mesh):
    """The layout `name` ("dp", "tp" or "sp") over `mesh`."""
    from popnet_tpu_torch.parallel.mesh import DataParallel
    from popnet_tpu_torch.parallel.spatial import SpatialParallel
    from popnet_tpu_torch.parallel.tensor import TensorParallel

    layouts = {"dp": DataParallel, "tp": TensorParallel, "sp": SpatialParallel}
    if name not in layouts:
        raise ValueError(f"unknown layout {name!r} (dp | tp | sp)")
    return layouts[name](mesh)


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = self.avg = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Trainer:
    """Trains `model` (an `nn.Module` with `init_seeded(seed)`) with the
    step `make_step` (`train.steps`) and scores validation with
    `make_eval_loss`, on `device`."""

    def __init__(self, model, make_step, make_eval_loss, learning_rate: float = 1.0,
                 momentum: float = 0.9, weight_decay: float = 0.0, mesh=None,
                 out_dir: str = "runs/default", print_freq: int = 20, seed: int = 0,
                 optimizer: str = "sgd", scheduler=None, layout: str = "dp",
                 device: str | torch.device = "cuda", profile_epoch: int | None = None):
        if mesh is None and layout != "dp":
            raise ValueError(f"layout {layout!r} needs a mesh (parallel.mesh.Mesh)")
        self.device = resolve_device(device)
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.print_freq = print_freq
        self.profile_epoch = profile_epoch
        model = model.init_seeded(seed).to(self.device)
        self.layout = None if mesh is None else make_layout(layout, mesh)
        if self.layout is not None:
            model = self.layout.attach(model)
        self.state = TrainState(model, make_optimizer(model, optimizer, learning_rate,
                                                      momentum, weight_decay), self.layout)
        self.step_fn = make_step
        self.eval_loss_fn = make_eval_loss
        self.scheduler = scheduler or ReduceLROnPlateau(learning_rate)
        # warmup schedules start below the nominal rate; honour epoch 0's
        lr0 = getattr(self.scheduler, "initial_lr", None)
        if lr0 is not None and abs(lr0 - learning_rate) > 1e-12:
            set_learning_rate(self.state, lr0)
        self.best_val = float("inf")
        self.epoch = 0
        self.history = []
        self._data_rng_state = None     # a resumed run's training generators
        self.writer = None              # made at the first epoch's end (`_scalars`)

    @property
    def writes(self) -> bool:
        """This rank writes the history and the checkpoints."""
        return self.layout is None or self.layout.mesh.rank0

    def train_epoch(self, dataset, batch_size: int) -> float:
        batch_time, data_time = AverageMeter(), AverageMeter()
        device_losses = []  # read once an epoch, not once a step
        end = time.time()
        for i, batch in enumerate(dataset.iter_batches(batch_size)):
            data_time.update(time.time() - end)
            if self.layout is not None:
                batch = self.layout.shard_batch(batch)
            self.state, logs = self.step_fn(self.state, batch)
            device_losses.append(logs["loss"])
            batch_time.update(time.time() - end)
            end = time.time()
            if i % self.print_freq == 0 and self.writes:
                # reading the loss waits for the step, here only
                print(f"epoch {self.epoch} [{i}] loss {float(logs['loss']):.4f} "
                      f"batch {batch_time.avg:.3f}s data {data_time.avg:.3f}s "
                      f"lr {get_learning_rate(self.state):.4g}", flush=True)
        if not device_losses:
            return 0.0
        return float(torch.stack(device_losses).double().mean())

    def validate(self, dataset, batch_size: int) -> float:
        losses = AverageMeter()
        lay = self.layout
        for batch in dataset.iter_batches(batch_size, shuffle=False, drop_last=False):
            first = batch.get("image", next(iter(batch.values())))
            n = first.shape[0]
            if lay is None or n % lay.n_data:
                # one device, or a ragged tail scored whole on every rank
                losses.update(float(self.eval_loss_fn(self.state, batch)), n)
            else:
                loss = self.eval_loss_fn(self.state, lay.shard_batch(batch))
                losses.update(float(lay.reduce_mean(loss)), n)
        if losses.count == 0:
            raise ValueError(f"validation set yielded no batches (len={len(dataset)}, "
                             f"batch_size={batch_size})")
        return losses.avg

    def _payload(self, train_ds) -> dict:
        return {**self.state.state_dict(), "scheduler": copy.deepcopy(vars(self.scheduler)),
                "data_rng": train_ds.rng_state()}

    def fit(self, train_ds, val_ds, epochs: int, batch_size: int,
            checkpoint_every: int | None = None, val_every: int = 1):
        """`epochs` more epochs; `val_every` and `checkpoint_every` thin the
        validation and the periodic checkpoint, and the last epoch always
        validates and checkpoints. Each history record also holds
        `train_seconds`, the host clock of the epoch's training loop."""
        if self._data_rng_state is not None:
            train_ds.set_rng_state(self._data_rng_state)
            self._data_rng_state = None
        if self.layout is not None and batch_size % self.layout.n_data:
            self._shrink(batch_size)
        if self.layout is not None and not self.layout.mesh.member:
            return self.history         # a rank the mesh leaves out sits the run out
        for k in range(epochs):
            last = k == epochs - 1
            t0 = time.perf_counter()
            if self.profile_epoch is not None and self.epoch == self.profile_epoch:
                train_loss = self._profiled_epoch(train_ds, batch_size)
            else:
                train_loss = self.train_epoch(train_ds, batch_size)
            train_seconds = time.perf_counter() - t0

            do_val = val_ds is not None and (last or (self.epoch + 1) % val_every == 0)
            val_loss = self.validate(val_ds, batch_size) if do_val else train_loss
            new_lr = self.scheduler.step(val_loss)
            if abs(new_lr - get_learning_rate(self.state)) > 1e-12:
                set_learning_rate(self.state, new_lr)

            rec = {"epoch": self.epoch, "train_loss": train_loss, "val_loss": val_loss,
                   "lr": new_lr, "train_seconds": train_seconds}
            self.history.append(rec)
            if self.writes:
                with open(os.path.join(self.out_dir, "history.jsonl"), "a") as f:
                    f.write(json.dumps(rec) + "\n")
                self._scalars(rec)

            meta = {"val_loss": val_loss, "epoch": self.epoch, "lr": new_lr,
                    "scheduler_best": self.scheduler.best,
                    "best_val": min(self.best_val, val_loss)}
            if (do_val or val_ds is None) and val_loss < self.best_val:
                self.best_val = val_loss
                # its own directory, so periodic checkpoints never evict it
                self._save("ckpt_best", train_ds, meta, keep=1)
            if last or checkpoint_every is None or (self.epoch + 1) % checkpoint_every == 0:
                self._save("ckpt", train_ds, meta)
            self.epoch += 1
        return self.history

    def _scalars(self, rec: dict) -> None:
        """The epoch's train_loss, val_loss and lr to TensorBoard, where it
        imports (as the JAX package's `try` does; its import is slow, so it
        is made when the first epoch ends, not with the Trainer)."""
        if self.writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(os.path.join(self.out_dir, "tb"))
            except Exception:
                self.writer = False
        if self.writer:
            for key in ("train_loss", "val_loss", "lr"):
                self.writer.add_scalar(key, rec[key], rec["epoch"])
            self.writer.flush()

    def _profiled_epoch(self, train_ds, batch_size: int) -> float:
        """`train_epoch` under torch.profiler; the writing rank puts its
        Chrome trace in `<out_dir>/trace/epoch<N>.json`."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            loss = self.train_epoch(train_ds, batch_size)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if self.writes:
            trace_dir = os.path.join(self.out_dir, "trace")
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, f"epoch{self.epoch}.json"))
        return loss

    def _save(self, directory: str, train_ds, meta: dict, keep: int = 3) -> None:
        payload = self._payload(train_ds)       # every rank: a sharded layout gathers
        if self.writes:
            ckpt.save_checkpoint(os.path.join(self.out_dir, directory), payload,
                                 step=self.epoch, metadata=meta, keep=keep)

    def _shrink(self, batch_size: int) -> None:
        """JAX's rule for a batch the data axis does not divide: a
        data-parallel mesh shrinks to the largest divisor; other layouts raise."""
        lay = self.layout
        if lay.name != "dp":
            raise ValueError(f"batch {batch_size} must divide the mesh's data axis "
                             f"({lay.n_data}) under layout {lay.name!r}")
        from popnet_tpu_torch.parallel.mesh import make_mesh

        n = max(d for d in range(1, lay.n_data + 1) if batch_size % d == 0)
        self.layout = make_layout("dp", make_mesh(n, lay.mesh.ranks[:n]))
        self.layout.attach(self.state.model)
        self.state.layout = self.layout

    def resume(self, best: bool = False):
        """Continue from the latest checkpoint (`ckpt`), or with `best` from
        the best-validation one (`ckpt_best`): the model, the optimizer, the
        controller, the epoch, the best loss and the training dataset's
        generators (applied when `fit` starts)."""
        directory = "ckpt_best" if best else "ckpt"
        payload, meta, step = ckpt.restore_checkpoint(os.path.join(self.out_dir, directory))
        self.state.load_state_dict(payload)
        vars(self.scheduler).update(payload["scheduler"])
        self._data_rng_state = payload["data_rng"]
        self.epoch = meta.get("epoch", step) + 1
        self.best_val = meta.get("best_val", meta.get("val_loss", float("inf")))
        return self
