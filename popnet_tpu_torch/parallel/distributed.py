"""Process groups over `torch.distributed` (the JAX package's
`popnet_tpu/parallel/distributed.py`): joining a job of several ranks, and
a launcher that starts one on this host.

A job is started either by `torchrun` (it sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT, and `initialize()` reads them) or
by `launch`, which spawns the ranks with `torch.multiprocessing` (start
method `spawn`) and joins them through a file store. On CUDA (the default
of every entry point here) a rank takes the card of its local rank and the
groups use NCCL; with device="cpu" the ranks are processes and the groups
use gloo.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from popnet_tpu_torch.core.device import resolve_device

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT = 600.0     # seconds a collective, and a launched job, may take


def default_backend(device: str | torch.device) -> str:
    """NCCL for ranks on cards, gloo for ranks on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device: str | torch.device = "cuda", timeout: float = DEFAULT_TIMEOUT,
               card: int | None = None) -> bool:
    """Join the job this process belongs to; True when it runs over a process
    group, False when it stays a single process.

    With no arguments, a torchrun environment (RANK and WORLD_SIZE) is
    joined through `env://`; without one the process stays single, and a
    failure to join is logged and reported as False, as JAX's auto-init
    does. With explicit arguments the caller asked for a job, so a failure
    raises. On CUDA the rank first takes card `card`, by default that of
    LOCAL_RANK (or of its rank). `timeout` bounds every collective, so a
    hung one raises."""
    if dist.is_initialized():
        return True
    explicit = init_method is not None or world_size is not None
    if not explicit and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return False
    device = resolve_device(device)
    backend = backend or default_backend(device)
    wait = datetime.timedelta(seconds=timeout)
    if device.type == "cuda":
        torch.cuda.set_device(card if card is not None else
                              int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", rank or 0))))
    if explicit:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=wait)
        return True
    try:
        dist.init_process_group(backend, init_method="env://", timeout=wait)
    except Exception as e:  # noqa: BLE001 - JAX's auto-init falls back the same way
        log.warning("torch.distributed env init unavailable (%s); running single-process", e)
        return False
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def per_process_batch_size(global_batch: int) -> int:
    """This process's share of a global batch."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide over {n} processes")
    return global_batch // n


def under_launcher() -> bool:
    """True inside a job that torchrun or `launch` started."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


@contextlib.contextmanager
def single_rank_job(device: str | torch.device = "cuda", backend: str | None = None):
    """A job of one rank in this process (a file store in a temporary
    directory), ended on exit: a mesh of one runs its collectives here, on
    the card unless `device` says otherwise."""
    store_dir = tempfile.mkdtemp(prefix="popnet_dist_")
    try:
        initialize(f"file://{os.path.join(store_dir, 'store')}", 1, 0, backend, device)
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)


def _rank_main(local_rank: int, call: str, world: int, init_method: str, backend: str,
               device: str, timeout: float, threads: int | None, result_dir: str,
               one_card: bool):
    fn, args = torch.load(call, weights_only=False)
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank))
    if threads:
        torch.set_num_threads(threads)
    initialize(init_method, world, local_rank, backend, device, timeout,
               card=0 if one_card else local_rank)
    try:
        result = fn(*args)
        if local_rank == 0:
            torch.save(result, os.path.join(result_dir, "result.pt"))
    finally:
        dist.destroy_process_group()


def check_cards(world: int, device: str | torch.device) -> None:
    """Refuse a job on CUDA that needs more ranks (one a card) than the host has cards."""
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise SystemExit(f"the job needs {world} ranks, one a card, and this host has "
                             f"{cards} card(s)")


class Job:
    """A job that `start` launched: `result()` waits for it."""

    def __init__(self, ctx, world: int, deadline: float, timeout: float, store_dir: str,
                 store: str, own: bool):
        self.ctx, self.world, self.deadline, self.timeout = ctx, world, deadline, timeout
        self.store_dir, self.store, self.own = store_dir, store, own

    def result(self):
        """Rank 0's result. A rank that failed raises here, with its
        traceback, after the others are stopped; a job past its timeout is
        stopped and raises TimeoutError."""
        try:
            while not self.ctx.join(timeout=0.5):
                if time.monotonic() > self.deadline:
                    for p in self.ctx.processes:
                        if p.is_alive():
                            p.kill()
                    for p in self.ctx.processes:
                        p.join()
                    raise TimeoutError(f"a job of {self.world} ranks ran past "
                                       f"{self.timeout:.0f} s")
            path = os.path.join(self.store_dir, "result.pt")
            return torch.load(path, weights_only=False) if os.path.exists(path) else None
        finally:
            if self.own:
                shutil.rmtree(self.store_dir, ignore_errors=True)
            else:
                for f in (self.store, self.store + ".call",
                          os.path.join(self.store_dir, "result.pt")):
                    if os.path.exists(f):
                        os.remove(f)


def start(fn, world: int, args: tuple = (), device: str | torch.device = "cuda",
          backend: str | None = None, timeout: float = DEFAULT_TIMEOUT,
          threads: int | None = None, store_dir: str | None = None,
          one_card: bool = False) -> Job:
    """Start `fn(*args)` on `world` ranks of this host (see `launch`) and
    return at once."""
    device = torch.device(device)
    if not one_card:
        check_cards(world, device)
    backend = backend or default_backend(device)
    own = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="popnet_dist_") if own else store_dir
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.monotonic_ns()}")
    # the call goes through a file: a spawned rank reads its pipe only once it has imported
    # PyTorch, so large arguments written there would hold this process up rank by rank
    call = store + ".call"
    torch.save((fn, args), call)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(call, world, f"file://{store}", backend, str(device), timeout,
                          threads, store_dir, one_card),
        nprocs=world, join=False, start_method="spawn")
    return Job(ctx, world, time.monotonic() + timeout, timeout, store_dir, store, own)


def launch(fn, world: int, args: tuple = (), device: str | torch.device = "cuda",
           backend: str | None = None, timeout: float = DEFAULT_TIMEOUT,
           threads: int | None = None, store_dir: str | None = None, one_card: bool = False):
    """Run `fn(*args)` on `world` ranks of this host and return rank 0's
    result (`fn` must be importable, as `spawn` pickles it by name, and its
    result must be `torch.save`-able).

    On CUDA (the default) rank r takes card r, and a job that needs more
    ranks than the host has cards is refused; with `one_card` every rank
    takes card 0 (a backend that allows it, gloo, must then be asked for). `threads`
    caps each rank's PyTorch threads. A rank that fails fails the job, with
    its traceback, and the others are stopped; a job that outlasts
    `timeout` seconds is stopped and raises TimeoutError, and so does a
    collective that waits that long. The file store lives in `store_dir`
    (a fresh temporary directory by default)."""
    return start(fn, world, args, device, backend, timeout, threads, store_dir,
                 one_card).result()
