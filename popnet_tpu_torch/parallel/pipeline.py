"""Pipeline parallelism: GPipe over a ("data", "pipe") mesh (the JAX
package's `popnet_tpu/parallel/pipeline.py`).

Open-Pose+'s CPM stages are one program each: here every stage takes the
187-channel concat (paf 2L | heat K+1 | z L+1 | stem 128), `CPMStageUniform`.
`build_pipelined_state_dict` embeds stage 1's first convs at the stem
slice of a zero-widened weight, so the uniform stage 1 computes exactly
what the sequential one computes on concat(0, 0, 0, stem); the dead slice
sees zero inputs, gets zero gradients and stays zero under training.
`unstack_pipelined_state_dict` is its inverse, for the sequential model.

The stem runs on each data shard's first pipe rank; the stages lie one
after another on the pipe ranks (S / P consecutive stages a rank: one, as
in JAX, where P = S). The schedule is JAX's `_run_pipeline`: the local
batch splits into n_micro microbatches, over n_micro + P - 1 ticks rank p
applies its stages to microbatch t - p and sends the (outputs | pass-through)
carry one hop down the pipe, so stage i's output for microbatch m comes at
tick m + i, and the bubble is (P - 1) / (n_micro + P - 1). The backward
runs the ticks in reverse: each rank first takes its own stages' loss
gradients, then for each microbatch, last first, receives the carry's
gradient from the next rank, runs the backward of its stages and sends
its input's gradient to the previous one; the first rank ends with the
stem's backward. BatchNorm runs on its running statistics in the stem and
in the stages, as JAX's step runs them.

The RTPoseVGG variant pipelines stages 2-6, each `VGGStageUniform` over
concat(paf 2L | heat K+1 | trunk 128); the front (trunk and stage 1) runs
on the first pipe rank.

Gradients: a stage's are averaged over the data group; the front's, which
only the first pipe rank computes, are summed over the mesh and divided by
n_data. Each rank's moments exist for its own stages only.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from popnet_tpu_torch.models.layers import CPMBranch, ResPreprocessStem
from popnet_tpu_torch.parallel.mesh import Mesh, reduce_gradients, reduce_logs, shard_batch
from popnet_tpu_torch.train.state import make_optimizer

_STEM = 128


class CPMStageUniform(nn.Module):
    """One Open-Pose+ stage over the uniform 187-channel input; its branches
    are those of `models.rtpose_light3d`."""

    def __init__(self, num_parts: int = 15, num_limbs: int = 14):
        super().__init__()
        c_in = stage_channels(num_parts, num_limbs) + _STEM
        self.paf = CPMBranch(c_in, ((256, 3), (256, 3), (256, 3), (128, 1)),
                             out_features=2 * num_limbs, out_kernel=1)
        self.heat = CPMBranch(c_in, ((128, 3),) * 4, out_features=num_parts + 1, out_kernel=3)
        self.z = CPMBranch(c_in, ((128, 3), (64, 3), (64, 3), (64, 3)),
                           out_features=num_limbs + 1, out_kernel=3)

    def forward(self, x):
        paf = (torch.sigmoid(self.paf(x)) - 0.5) * 4.0
        heat = torch.sigmoid(self.heat(x))
        z = (torch.sigmoid(self.z(x)) - 0.5) * 4.0
        return paf, heat, z


def stage_channels(num_parts: int = 15, num_limbs: int = 14) -> int:
    """C_out of one stage, which is also the stem's channel offset."""
    return 2 * num_limbs + (num_parts + 1) + (num_limbs + 1)


_BRANCHES = ("paf", "heat", "z")


def build_pipelined_state_dict(sd: dict, num_stages: int = 2, num_parts: int = 15,
                               num_limbs: int = 14):
    """A sequential RTPoseLight3D state dict -> (stem state dict, stages
    state dict with every tensor stacked on a leading (S,) axis), stage 1's
    first convs widened to the uniform input with zeros."""
    c_out = stage_channels(num_parts, num_limbs)
    stem = {k[len("stem."):]: v for k, v in sd.items() if k.startswith("stem.")}
    per_stage = []
    for i in range(1, num_stages + 1):
        tree = {}
        for branch in _BRANCHES:
            prefix = f"stage{i}_{branch}."
            for k, v in sd.items():
                if k.startswith(prefix):
                    name = f"{branch}.{k[len(prefix):]}"
                    if i == 1 and name.endswith("ConvBN_0.Conv_0.weight") and \
                            v.shape[1] != c_out + _STEM:
                        wide = v.new_zeros((v.shape[0], c_out + _STEM) + tuple(v.shape[2:]))
                        wide[:, c_out:] = v
                        v = wide
                    tree[name] = v
        per_stage.append(tree)
    stacked = {k: torch.stack([t[k] for t in per_stage]) for k in per_stage[0]}
    return stem, stacked


def unstack_pipelined_state_dict(stem: dict, stacked: dict, num_stages: int = 2,
                                 num_parts: int = 15, num_limbs: int = 14) -> dict:
    """The inverse of `build_pipelined_state_dict`: a sequential
    RTPoseLight3D state dict, stage 1's first convs cut back to the stem
    slice (exact: the dead slice stays zero)."""
    c_out = stage_channels(num_parts, num_limbs)
    sd = {f"stem.{k}": v for k, v in stem.items()}
    for i in range(1, num_stages + 1):
        for k, v in stacked.items():
            branch, rest = k.split(".", 1)
            t = v[i - 1]
            if i == 1 and rest == "ConvBN_0.Conv_0.weight" and t.shape[1] == c_out + _STEM:
                t = t[:, c_out:]
            sd[f"stage{i}_{branch}.{rest}"] = t.clone()
    return sd


def stage_slice(stacked: dict, index: int) -> dict:
    """Stage `index`'s state dict (0-based) of a stacked one."""
    return {k: v[index] for k, v in stacked.items()}


# -- the RTPoseVGG variant ----------------------------------------------------------------------

class VGGStageUniform(nn.Module):
    """One RTPoseVGG stage after the first: PAF and heat branches of five
    7x7 convs and a 1x1, ReLU, no BatchNorm, over the 185-channel concat."""

    def __init__(self, num_parts: int = 18, num_limbs: int = 19):
        super().__init__()
        c_in = vgg_stage_channels(num_parts, num_limbs) + _STEM
        spec = ((128, 7),) * 5 + ((128, 1),)
        self.paf = CPMBranch(c_in, spec, 2 * num_limbs, 1, norm=False, act="relu")
        self.heat = CPMBranch(c_in, spec, num_parts + 1, 1, norm=False, act="relu")

    def forward(self, x):
        return self.paf(x), self.heat(x)


def vgg_stage_channels(num_parts: int = 18, num_limbs: int = 19) -> int:
    return 2 * num_limbs + (num_parts + 1)


class VGGFront(nn.Module):
    """RTPoseVGG's trunk and stage 1: x -> (paf1, heat1, features)."""

    def __init__(self, trunk: nn.Module, stage1_paf: nn.Module, stage1_heat: nn.Module):
        super().__init__()
        self.trunk, self.stage1_paf, self.stage1_heat = trunk, stage1_paf, stage1_heat

    def forward(self, x):
        feat = self.trunk(x)
        return self.stage1_paf(feat), self.stage1_heat(feat), feat


_FRONT = ("trunk.", "stage1_paf.", "stage1_heat.")


def build_vgg_pipelined_state_dict(sd: dict, num_stages: int = 6):
    """A sequential RTPoseVGG state dict -> (front state dict: trunk and
    stage 1, stages 2..S stacked on a leading (S - 1,) axis)."""
    front = {k: v for k, v in sd.items() if k.startswith(_FRONT)}
    per_stage = [{f"{b}.{k[len(f'stage{i}_{b}.'):]}": v for b in ("paf", "heat")
                  for k, v in sd.items() if k.startswith(f"stage{i}_{b}.")}
                 for i in range(2, num_stages + 1)]
    return front, {k: torch.stack([t[k] for t in per_stage]) for k in per_stage[0]}


def unstack_vgg_pipelined_state_dict(front: dict, stacked: dict, num_stages: int = 6) -> dict:
    """The inverse of `build_vgg_pipelined_state_dict`."""
    sd = dict(front)
    for i in range(2, num_stages + 1):
        for k, v in stacked.items():
            branch, rest = k.split(".", 1)
            sd[f"stage{i}_{branch}.{rest}"] = v[i - 2].clone()
    return sd


# -- the schedule -----------------------------------------------------------------------------

@dataclasses.dataclass
class _Tick:
    x: torch.Tensor         # the stage input (a leaf where gradients flow)
    ys: list                # each local stage's concatenated outputs
    carry: torch.Tensor     # what goes down the pipe


def _forward_ticks(mesh: Mesh, stages, inject, shape, n_micro: int, c_out: int,
                   grad: bool) -> list[_Tick]:
    """The forward schedule on this rank; `inject` (the tick inputs, first
    pipe rank only) or `shape` (the local batch's tick-input shape)."""
    n_pipe, p = mesh.shape["pipe"], mesh.coords["pipe"]
    b = shape[0]
    if b % n_micro:
        raise ValueError(f"local batch {b} not divisible by {n_micro}")
    mb = b // n_micro
    stages.eval()       # BatchNorm on its running statistics, as in JAX's pipeline
    ticks, sent = [], []
    for t in range(n_micro + n_pipe - 1):
        m = t - p
        if not 0 <= m < n_micro:
            continue
        if p == 0:
            x = inject[m * mb:(m + 1) * mb]
        else:
            p0 = next(stages[0].parameters())
            x = torch.empty((mb,) + tuple(shape[1:]), dtype=p0.dtype, device=p0.device)
            dist.recv(x, mesh.global_rank(pipe=p - 1))
        if grad:
            x = x.detach().requires_grad_()
        cur, ys = x, []
        for stage in stages:
            y = torch.cat(stage(cur), 1)
            ys.append(y)
            cur = torch.cat([y, cur[:, c_out:]], 1)
        if p < n_pipe - 1:
            buf = cur.detach().contiguous()
            sent.append((dist.isend(buf, mesh.global_rank(pipe=p + 1)), buf))
        ticks.append(_Tick(x, ys, cur))
    for req, _ in sent:
        req.wait()
    return ticks


def _backward_ticks(mesh: Mesh, ticks: list[_Tick], stage_grads: list[list]) -> None:
    """The reverse schedule: stage_grads[m][k] is the loss's gradient of
    local stage k's output for microbatch m."""
    n_pipe, p = mesh.shape["pipe"], mesh.coords["pipe"]
    sent = []
    for m in reversed(range(len(ticks))):
        tick = ticks[m]
        tensors, grads = list(tick.ys), list(stage_grads[m])
        if p < n_pipe - 1:
            g = torch.empty_like(tick.carry)
            dist.recv(g, mesh.global_rank(pipe=p + 1))
            tensors.append(tick.carry)
            grads.append(g)
        torch.autograd.backward(tensors, grads)
        if p > 0:
            buf = tick.x.grad.contiguous()
            sent.append((dist.isend(buf, mesh.global_rank(pipe=p - 1)), buf))
    for req, _ in sent:
        req.wait()


def _gather_stages(mesh: Mesh, local: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every stage's output over the global batch, on every rank: `local`
    holds this rank's stages' outputs over its data shard."""
    if mesh.world_group is None:
        return local
    mine = torch.stack(local).contiguous()
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.world_group)
    n_data, n_pipe = mesh.shape["data"], mesh.shape["pipe"]
    out = []
    for p in range(n_pipe):
        for k in range(len(local)):
            out.append(torch.cat([parts[d * n_pipe + p][k] for d in range(n_data)], 0))
    return out


def _run_forward(mesh: Mesh, stages, inject: torch.Tensor, n_micro: int,
                 c_out: int) -> list[torch.Tensor]:
    """Each stage's output (B, c_out, h, w) over the global batch of
    `inject` (the tick inputs of the whole batch, on every rank)."""
    local = shard_batch(inject, mesh)
    with torch.no_grad():
        ticks = _forward_ticks(mesh, stages, local, local.shape, n_micro, c_out, grad=False)
    per_stage = [torch.cat([t.ys[k] for t in ticks], 0) for k in range(len(stages))]
    return _gather_stages(mesh, per_stage)


def pipeline_stages(mesh: Mesh, stages, stem_out: torch.Tensor, n_micro: int,
                    num_parts: int = 15, num_limbs: int = 14) -> list[torch.Tensor]:
    """The Open-Pose+ stages as a pipeline over the mesh's pipe axis (this
    rank's `stages`), forward only. stem_out: (B, 128, h, w), the global
    batch, on every rank. Returns [paf1, heat1, z1, ...] over the global
    batch on every rank, as the sequential model's saved list."""
    c_out = stage_channels(num_parts, num_limbs)
    inject = torch.cat([stem_out.new_zeros((stem_out.shape[0], c_out) + stem_out.shape[2:]),
                        stem_out], 1)
    saved = []
    for y in _run_forward(mesh, stages, inject, n_micro, c_out):
        saved += list(torch.split(y, [2 * num_limbs, num_parts + 1, num_limbs + 1], 1))
    return saved


def vgg_pipeline_stages(mesh: Mesh, stages, paf1, heat1, feat, n_micro: int,
                        num_parts: int = 18, num_limbs: int = 19) -> list[torch.Tensor]:
    """RTPoseVGG stages 2..S as a pipeline, forward only; paf1, heat1 and
    feat over the global batch on every rank. Returns [paf1, heat1, paf2,
    heat2, ...]."""
    c_out = vgg_stage_channels(num_parts, num_limbs)
    saved = [paf1, heat1]
    for y in _run_forward(mesh, stages, torch.cat([paf1, heat1, feat], 1), n_micro, c_out):
        saved += list(torch.split(y, [2 * num_limbs, num_parts + 1], 1))
    return saved


# -- the train state and step -------------------------------------------------------------------

@dataclasses.dataclass
class PipelineState:
    """The pipelined model on one rank: the front (the stem, or RTPoseVGG's
    trunk and stage 1), replicated; this rank's stages (`first` is the
    0-based index of stages[0]); the optimizer over both."""
    front: nn.Module
    stages: nn.ModuleList
    optimizer: torch.optim.Optimizer
    mesh: Mesh
    first: int
    num_stages: int


def _stages_per_rank(num_stages: int, n_pipe: int) -> int:
    if num_stages % n_pipe:
        raise ValueError(f"{num_stages} stages do not divide over pipe={n_pipe}")
    return num_stages // n_pipe


def _state(mesh, front, stage_cls, stacked, num_stages, device, learning_rate, momentum,
           weight_decay) -> PipelineState:
    per = _stages_per_rank(num_stages, mesh.shape["pipe"])
    first = mesh.coords["pipe"] * per
    stages = nn.ModuleList()
    for k in range(per):
        stage = stage_cls()
        stage.load_state_dict(stage_slice(stacked, first + k))
        stages.append(stage)
    stages.to(device=device, dtype=next(front.parameters()).dtype)
    front.eval()
    both = nn.ModuleList([front, stages])
    opt = make_optimizer(both, "sgd", learning_rate, momentum, weight_decay)
    return PipelineState(front, stages, opt, mesh, first, num_stages)


def create_pipeline_train_state(model: nn.Module, mesh: Mesh, learning_rate: float = 0.05,
                                momentum: float = 0.9, weight_decay: float = 0.0,
                                num_parts: int = 15, num_limbs: int = 14) -> PipelineState:
    """The pipelined state of a sequential RTPoseLight3D `model` (the same
    weights on every rank), on its device and in its dtype."""
    stem_sd, stacked = build_pipelined_state_dict(model.state_dict(), model.num_stages,
                                                  num_parts, num_limbs)
    p = next(model.parameters())
    stem = ResPreprocessStem().to(device=p.device, dtype=p.dtype)
    stem.load_state_dict(stem_sd)
    return _state(mesh, stem, lambda: CPMStageUniform(num_parts, num_limbs), stacked,
                  model.num_stages, p.device, learning_rate, momentum, weight_decay)


def create_vgg_pipeline_train_state(model: nn.Module, mesh: Mesh, learning_rate: float = 1e-4,
                                    momentum: float = 0.9,
                                    weight_decay: float = 0.0) -> PipelineState:
    """The pipelined state of a sequential RTPoseVGG `model`: the front on
    every rank, stages 2..S over the pipe."""
    front = VGGFront(model.trunk, model.stage1_paf, model.stage1_heat)
    _, stacked = build_vgg_pipelined_state_dict(model.state_dict(), model.num_stages)
    p = next(model.parameters())
    parts = model.stage2_paf.Conv_0.out_channels // 2, model.stage2_heat.Conv_0.out_channels - 1
    return _state(mesh, front, lambda: VGGStageUniform(parts[1], parts[0]), stacked,
                  model.num_stages - 1, p.device, learning_rate, momentum, weight_decay)


def sequential_state_dict(state: PipelineState, vgg: bool = False) -> dict:
    """The sequential model's state dict of a pipelined state, on every
    rank (the stages are gathered over the pipe group, on the CPU)."""
    local = [{k: v.detach().cpu() for k, v in s.state_dict().items()} for s in state.stages]
    group = state.mesh.groups.get("pipe")
    if group is not None and dist.get_world_size(group) > 1:
        parts = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, local, group=group)
        local = [s for part in parts for s in part]
    stacked = {k: torch.stack([s[k] for s in local]) for k in local[0]}
    front = {k: v.detach().cpu() for k, v in state.front.state_dict().items()}
    if vgg:
        return unstack_vgg_pipelined_state_dict(front, stacked, state.num_stages + 1)
    return unstack_pipelined_state_dict(front, stacked, state.num_stages)


def _nchw(image):
    return image.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)


def _loss_grads(ys_per_tick, loss_fn):
    """(loss, logs, [per tick [per stage gradient]]): the local loss of the
    local stages' outputs over the whole local batch and its gradients."""
    n_stage = len(ys_per_tick[0])
    whole = [torch.cat([t[k].detach() for t in ys_per_tick], 0).requires_grad_()
             for k in range(n_stage)]
    loss, logs = loss_fn(whole)
    loss.backward()
    sizes = [t[0].shape[0] for t in ys_per_tick]
    grads = [torch.split(w.grad, sizes, 0) for w in whole]
    return loss.detach(), logs, [[grads[k][m] for k in range(n_stage)] for m in range(len(sizes))]


def _finish(state: PipelineState, local_loss, logs) -> dict:
    """Reduce the gradients and the logs, step the optimizer."""
    mesh = state.mesh
    n_data = mesh.shape["data"]
    for prm in state.front.parameters():
        if prm.grad is None:
            prm.grad = torch.zeros_like(prm)
    reduce_gradients(state.front.parameters(), mesh.world_group, n_data)
    reduce_gradients(state.stages.parameters(), mesh.groups.get("data"), n_data)
    state.optimizer.step()
    logs = {k: v.detach() for k, v in logs.items()}
    logs["loss"] = local_loss
    return reduce_logs(logs, mesh.world_group, n_data)


def make_pipeline_train_step(n_micro: int, num_parts: int = 15, num_limbs: int = 14):
    """The pipelined Open-Pose+ step: step(state, batch) -> (state, logs),
    batch = {"image" (B, H, W, 1), "heatmaps", "pafs", "zmaps"} channels-last,
    the global batch (each rank takes its data rows). The loss is
    `losses.rtpose_light3d_loss` of every stage; BatchNorm runs on its
    running statistics."""
    from popnet_tpu_torch.losses.losses import rtpose_light3d_loss

    c_out = stage_channels(num_parts, num_limbs)

    def step(state: PipelineState, batch):
        mesh = state.mesh
        batch = shard_batch(batch, mesh)
        state.front.eval()
        state.stages.eval()
        state.optimizer.zero_grad(set_to_none=True)
        p = mesh.coords["pipe"]
        last = p == mesh.shape["pipe"] - 1
        inject = stem_out = None
        h, w = batch["heatmaps"].shape[1:3]
        shape = (batch["image"].shape[0], c_out + _STEM, h, w)
        if p == 0:
            stem_out = state.front(_nchw(batch["image"]))
            inject = torch.cat([stem_out.new_zeros((shape[0], c_out, h, w)), stem_out], 1)
        ticks = _forward_ticks(mesh, state.stages, inject, shape, n_micro, c_out, grad=True)

        def loss_fn(whole):
            total, logs = 0.0, {}
            for k, y in enumerate(whole):
                saved = list(torch.split(y, [2 * num_limbs, num_parts + 1, num_limbs + 1], 1))
                t, lg = rtpose_light3d_loss(saved, batch["heatmaps"], batch["pafs"],
                                            batch["zmaps"], num_stages=1)
                total = total + t
                g = state.first + k + 1
                logs.update({f"stage{g}_{n}": lg[f"stage1_{n}"] for n in _BRANCHES})
                if last and k == len(whole) - 1:
                    logs.update({n: lg[n] for n in ("max_ht", "min_ht", "max_paf", "min_paf")})
            return total, logs

        loss, logs, grads = _loss_grads([t.ys for t in ticks], loss_fn)
        _backward_ticks(mesh, ticks, grads)
        if p == 0:
            inject.backward(torch.cat([t.x.grad for t in ticks], 0))
        logs = _canaries(logs, last, loss)
        full = {f"stage{i}_{n}": loss.new_zeros(()) for i in range(1, state.num_stages + 1)
                for n in _BRANCHES}
        full.update(logs)
        return state, _finish(state, loss, full)

    return step


def _canaries(logs: dict, last: bool, like: torch.Tensor) -> dict:
    """The activation canaries on every rank: the last stage's rank holds
    them, the others the identity of their reduction."""
    if last:
        return logs
    out = dict(logs)
    for n in ("max_ht", "max_paf"):
        out[n] = like.new_tensor(float("-inf"))
    for n in ("min_ht", "min_paf"):
        out[n] = like.new_tensor(float("inf"))
    return out


def make_vgg_pipeline_train_step(n_micro: int, num_parts: int = 18, num_limbs: int = 19):
    """The pipelined RTPoseVGG step over batch = {"image" (B, H, W, 3),
    "heat", "paf"} (the global batch): the front on the first pipe rank,
    stages 2..S pipelined, `losses.rtpose_light_loss` of every stage."""
    from popnet_tpu_torch.losses.losses import rtpose_light_loss

    c_out = vgg_stage_channels(num_parts, num_limbs)

    def step(state: PipelineState, batch):
        mesh = state.mesh
        batch = shard_batch(batch, mesh)
        state.front.eval()
        state.stages.eval()
        state.optimizer.zero_grad(set_to_none=True)
        p = mesh.coords["pipe"]
        h, w = batch["heat"].shape[1:3]
        shape = (batch["image"].shape[0], c_out + _STEM, h, w)
        inject = front_loss = None
        logs = {}
        if p == 0:
            paf1, heat1, feat = state.front(_nchw(batch["image"]))
            front_loss, lg = rtpose_light_loss([paf1, heat1], batch["heat"], batch["paf"])
            logs.update(lg)
            inject = torch.cat([paf1, heat1, feat], 1)
        ticks = _forward_ticks(mesh, state.stages, inject, shape, n_micro, c_out, grad=True)

        def loss_fn(whole):
            total, out = 0.0, {}
            for k, y in enumerate(whole):
                saved = list(torch.split(y, [2 * num_limbs, num_parts + 1], 1))
                t, lg = rtpose_light_loss(saved, batch["heat"], batch["paf"])
                total = total + t
                g = state.first + k + 2
                out.update({f"stage{g}_{n}": lg[f"stage1_{n}"] for n in ("paf", "heat")})
            return total, out

        loss, stage_logs, grads = _loss_grads([t.ys for t in ticks], loss_fn)
        logs.update(stage_logs)
        _backward_ticks(mesh, ticks, grads)
        if p == 0:
            torch.autograd.backward([inject, front_loss],
                                    [torch.cat([t.x.grad for t in ticks], 0), None])
            loss = loss + front_loss.detach()
        full = {f"stage{i}_{n}": loss.new_zeros(()) for i in range(1, state.num_stages + 2)
                for n in ("paf", "heat")}
        full.update(logs)
        return state, _finish(state, loss, full)

    return step
