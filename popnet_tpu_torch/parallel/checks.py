"""Jobs that hold the layouts against one device: each function runs on
every rank of a job (`distributed.launch` spawns them by name) and returns,
from rank 0, numpy arrays that the caller compares with the one-device
port or with the JAX package. The CPU tests and `chip_smoke.py` run them.

Inputs come as numpy arrays (the global batch, the same on every rank) and
Flax variables as a flat {'/'-joined path: array} dict (`interop.load_into`),
or None for the model's seeded init. A job's mesh may use the job's first
ranks only: the others build it too (groups are made collectively) and
return None.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from popnet_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows

def _model(family: str, flat: dict | None, seed: int, dtype, device, num_stages: int = 2):
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import PopNet, RTPoseLight3D, YoloPoseNet

    if family == "openpose":
        model = RTPoseLight3D(num_stages=num_stages)
    else:
        model = {"popnet": PopNet, "yolo": YoloPoseNet}[family]()
    model = load_into(model, flat) if flat is not None else model.init_seeded(seed)
    return model.to(device=device, dtype=dtype)


def _step(family: str):
    from popnet_tpu_torch.train import steps

    return {"openpose": steps.make_rtpose_train_step, "popnet": steps.make_popnet_train_step,
            "yolo": steps.make_yolo_train_step}[family]()


def _tensors(batch: dict, dtype, device) -> dict:
    return {k: torch.as_tensor(np.array(v)).to(
        device=device, dtype=dtype if np.asarray(v).dtype.kind == "f" else None)
        for k, v in batch.items()}


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy (a CPU tensor's numpy view would follow later in-place updates)."""
    return t.detach().cpu().numpy().copy()


def batchnorm_job(x: np.ndarray, weight: np.ndarray, bias: np.ndarray, n: int,
                  device: str = "cpu"):
    """A `layers.BatchNorm` in train mode over a data group of the first n
    ranks, each on its rows of x (N, C, H, W): the output gathered, the
    running statistics, and the input gradient of sum(y * y) gathered."""
    from popnet_tpu_torch.models.layers import BatchNorm

    mesh = Mesh({"data": n})
    if not mesh.member:
        return None
    bn = BatchNorm(x.shape[1]).to(device=device, dtype=torch.float64)
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(weight))
        bn.bias.copy_(torch.as_tensor(bias))
    bn.group = mesh.groups["data"]
    bn.train()
    xl = shard_rows(torch.as_tensor(x, device=device), mesh.coords["data"], mesh.shape["data"])
    xl = xl.clone().requires_grad_()
    y = bn(xl)
    (y * y).sum().backward()
    g = mesh.groups["data"]
    return {"y": _np(gather_rows(y.detach(), g)), "grad": _np(gather_rows(xl.grad, g)),
            "running_mean": _np(bn.running_mean), "running_var": _np(bn.running_var)}


def train_job(family: str, flat: dict | None, batch: dict, shape: dict | None,
              layout: str = "dp", steps: int = 1, lr: float = 0.05, dtype: str = "float32",
              seed: int = 0, device: str = "cpu", deterministic: bool = False,
              wait_for: str | None = None):
    """`steps` steps of the family's SGD-Nesterov step under `layout` over
    a mesh of `shape` (None: one device, no layout) on the global batch:
    the losses, each step's seconds, the whole state dict after the first
    step (one-device layout), and, under "tp", the names of the sharded
    weights and the shapes of this rank's weight and momentum for each.
    With `wait_for`, the steps after the first wait until that file exists
    (a caller that shares the device with the job times them alone)."""
    from popnet_tpu_torch.parallel import spatial
    from popnet_tpu_torch.train.loop import make_layout
    from popnet_tpu_torch.train.state import TrainState, make_optimizer

    dt = getattr(torch, dtype)
    mesh = None if shape is None else Mesh(dict(shape))
    if mesh is not None and not mesh.member:
        return None
    model = _model(family, flat, seed, dt, device)
    step = _step(family)
    if layout == "sp":          # the JAX module's two calls
        state = spatial.replicate_state(TrainState(model, make_optimizer(model, "sgd", lr, 0.9,
                                                                         0.0)), mesh)
        step = spatial.jit_step_spatial(step, mesh)
    else:
        lay = None if mesh is None else make_layout(layout, mesh)
        if lay is not None:
            model = lay.attach(model)
        state = TrainState(model, make_optimizer(model, "sgd", lr, 0.9, 0.0), lay)
    lay = state.layout
    data = _tensors(batch, dt, device)
    data = data if lay is None else lay.shard_batch(data)
    losses, seconds, first = [], [], None
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=deterministic):
        for i in range(steps):
            while i == 1 and wait_for is not None and not os.path.exists(wait_for):
                time.sleep(0.02)
            t0 = _now(device)
            state, logs = step(state, data)
            losses.append(float(logs["loss"]))
            seconds.append(_now(device) - t0)
            if first is None:
                first = {k: _np(v) for k, v in state.state_dict()["model"].items()}
    out = {"losses": np.asarray(losses), "seconds": np.asarray(seconds), "state": first}
    if layout == "tp":
        from popnet_tpu_torch.parallel.tensor import state_shardings

        opt = state.optimizer.state
        sliced = [n for n, s in state_shardings(model).items() if s == "model"]
        params = dict(model.named_parameters())
        out["sharded"] = sliced
        out["local_shapes"] = {n: (tuple(params[n].shape),
                                   tuple(opt[params[n]]["momentum_buffer"].shape))
                               for n in sliced}
        # the checkpoint's round trip: gathered whole, loaded back into a fresh sharded state
        whole = state.state_dict()
        fresh = lay.attach(_model(family, flat, seed + 1, dt, device))
        back = TrainState(fresh, make_optimizer(fresh, "sgd", lr, 0.9, 0.0), lay)
        back.load_state_dict(whole)
        mine = dict(fresh.named_parameters())
        out["round_trip"] = all(
            torch.equal(mine[n], p) and torch.equal(back.optimizer.state[mine[n]]["momentum_buffer"],
                                                    opt[p]["momentum_buffer"])
            for n, p in params.items())
    return out


class _Frames:
    """A dataset of fixed frames for the Trainer: batches in order, no
    augmentation, no generator."""

    def __init__(self, batch: dict, dtype, device):
        self.batch = _tensors(batch, dtype, device)
        self.n = len(next(iter(self.batch.values())))

    def __len__(self):
        return self.n

    def iter_batches(self, batch_size: int, shuffle: bool = True, drop_last: bool = True):
        stop = self.n - (self.n % batch_size if drop_last else 0)
        for s in range(0, stop, batch_size):
            yield {k: v[s:s + batch_size] for k, v in self.batch.items()}

    def rng_state(self):
        return None

    def set_rng_state(self, state) -> None:
        pass


def trainer_job(batch: dict, val: dict, shape: dict | None, batch_size: int,
                layout: str = "dp", lr: float = 0.05):
    """Open-Pose+'s Trainer for one epoch over the frames of `batch`
    (`batch_size`, in order) under `layout` over a mesh of `shape` (None:
    one device), validating on `val` (its ragged tail included): the
    history, and the data ranks the run ended on (a data axis that does
    not divide the batch shrinks; the ranks left out return an empty
    history)."""
    import tempfile

    from popnet_tpu_torch.models import RTPoseLight3D
    from popnet_tpu_torch.train import steps
    from popnet_tpu_torch.train.loop import Trainer

    mesh = None if shape is None else Mesh(dict(shape))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(RTPoseLight3D(), steps.make_rtpose_train_step(),
                          steps.make_rtpose_eval_loss(), learning_rate=lr, mesh=mesh,
                          layout=layout, out_dir=tmp, device="cpu", print_freq=10 ** 6)
        hist = trainer.fit(_Frames(batch, torch.float32, "cpu"),
                           _Frames(val, torch.float32, "cpu"), 1, batch_size)
    return {"history": hist, "n_data": None if trainer.layout is None else
            (trainer.layout.n_data if trainer.layout.mesh.member else 0)}


def _now(device: str) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def spatial_forward_job(family: str, flat: dict | None, x: np.ndarray, shape: dict,
                        seed: int = 0, device: str = "cpu", dtype: str = "float32"):
    """The family's eval-mode forward in height bands (`SpatialModel`) of x
    (B, C, H, W): its maps (the first output tuple), whole, as numpy."""
    from popnet_tpu_torch.parallel.spatial import jit_forward_spatial

    dt = getattr(torch, dtype)
    mesh = Mesh(dict(shape))
    if not mesh.member:
        return None
    net = jit_forward_spatial(_model(family, flat, seed, dt, device).eval(), mesh)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = net(torch.as_tensor(x).to(device=device, dtype=dt))
    maps = out if isinstance(out, torch.Tensor) else out[0]
    maps = (maps,) if isinstance(maps, torch.Tensor) else maps
    return [_np(t) for t in maps]


def pipeline_job(flat: dict | None, x: np.ndarray, batch: dict | None, shape: dict,
                 n_micro: int = 2, num_stages: int = 2, lr: float = 0.01, seed: int = 0,
                 device: str = "cpu", dtype: str = "float32"):
    """Open-Pose+ over a ("data", "pipe") mesh: the pipelined forward of
    x's stem outputs (every stage's maps over the global batch), and with a
    `batch`, one pipelined step: its loss and logs, the whole state dict
    after it in the sequential layout (`state`), stage 1's first paf conv
    weight in that layout before and after, and that weight as rank 0's
    first stage holds it, zero-widened, after (`wide`)."""
    from popnet_tpu_torch.parallel import pipeline as pp

    dt = getattr(torch, dtype)
    mesh = Mesh(dict(shape))
    if not mesh.member:
        return None
    model = _model("openpose", flat, seed, dt, device, num_stages).eval()
    state = pp.create_pipeline_train_state(model, mesh, learning_rate=lr)
    xt = torch.as_tensor(x).to(device=device, dtype=dt)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        state.front.eval()
        saved = pp.pipeline_stages(mesh, state.stages, state.front(xt), n_micro)
    out = {"saved": [_np(t) for t in saved]}
    if batch is not None:
        step = pp.make_pipeline_train_step(n_micro)
        key = "stage1_paf.ConvBN_0.Conv_0.weight"
        before = pp.sequential_state_dict(state)[key]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            _, logs = step(state, _tensors(batch, dt, device))
        after = pp.sequential_state_dict(state)
        out.update(loss=float(logs["loss"]), logs={k: float(v) for k, v in logs.items()},
                   state={k: _np(v) for k, v in after.items()}, before=_np(before),
                   after=_np(after[key]), wide=_np(state.stages[0].paf.ConvBN_0.Conv_0.weight))
    return out


def sequential_pipeline_step(flat: dict | None, batch: dict, lr: float = 0.01, seed: int = 0,
                             device: str = "cpu", dtype: str = "float32",
                             num_stages: int = 2):
    """What `pipeline_job`'s step computes, on one device and in order: one
    SGD-Nesterov step (momentum 0.9, as `create_pipeline_train_state`) of
    the sequential eval-mode Open-Pose+ (BatchNorm on its running
    statistics) on the whole `batch`, of `losses.rtpose_light3d_loss` over
    every stage: the loss and the state dict after."""
    from popnet_tpu_torch.losses.losses import rtpose_light3d_loss
    from popnet_tpu_torch.train.state import make_optimizer

    dt = getattr(torch, dtype)
    model = _model("openpose", flat, seed, dt, device, num_stages).eval()
    opt = make_optimizer(model, "sgd", lr, 0.9, 0.0)
    data = _tensors(batch, dt, device)
    image = data["image"].permute(0, 3, 1, 2).contiguous()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        _, saved = model(image)
        loss, _ = rtpose_light3d_loss(saved, data["heatmaps"], data["pafs"], data["zmaps"],
                                      num_stages)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return {"loss": float(loss.detach()),
            "state": {k: _np(v) for k, v in model.state_dict().items()}}


def vgg_pipeline_job(flat: dict | None, x: np.ndarray, batch: dict, shape: dict,
                     n_micro: int = 2, lr: float = 1e-3, trunk: str = "mobilenet", seed: int = 0,
                     device: str = "cpu"):
    """RTPoseVGG (`trunk`) with stages 2..6 over a ("data", "pipe") mesh:
    the pipelined forward's saved list over the global batch, and one step's
    loss with a stacked stage weight before and after."""
    from popnet_tpu_torch.interop.from_jax import load_into
    from popnet_tpu_torch.models import RTPoseVGG
    from popnet_tpu_torch.parallel import pipeline as pp

    mesh = Mesh(dict(shape))
    if not mesh.member:
        return None
    model = RTPoseVGG(trunk=trunk)
    model = (load_into(model, flat) if flat is not None else model.init_seeded(seed))
    model = model.to(device).eval()
    state = pp.create_vgg_pipeline_train_state(model, mesh, learning_rate=lr)
    xt = torch.as_tensor(x).to(device)
    with torch.no_grad():
        paf1, heat1, feat = state.front(xt)
        saved = pp.vgg_pipeline_stages(mesh, state.stages, paf1, heat1, feat, n_micro)
    before = _np(next(state.stages[0].parameters()))
    _, logs = pp.make_vgg_pipeline_train_step(n_micro)(state, _tensors(batch, torch.float32,
                                                                       device))
    return {"saved": [_np(t) for t in saved], "loss": float(logs["loss"]), "before": before,
            "after": _np(next(state.stages[0].parameters()))}


def jobs(calls: list[tuple[str, dict]]) -> list:
    """Several of this module's jobs, one after another in one job (one
    start-up): calls are (function name, keyword arguments)."""
    return [globals()[name](**kw) for name, kw in calls]
