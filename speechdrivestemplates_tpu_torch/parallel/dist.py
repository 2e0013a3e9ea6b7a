"""Ranks over ``torch.distributed``: the port's data parallelism.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX runs one train
step over a 1-D ``Mesh('data')`` of the devices of one or more processes: the
batch is one global array split over the mesh, so every loss, every batch
statistic and every metric is taken over the global batch. The port runs one
process a device (a "rank") and computes the same global quantities with
collectives:

  * ``all_reduce_sum`` is a sum over ranks whose backward is the sum over
    ranks of the incoming gradients. Every rank then holds, and
    backpropagates, the same global loss; averaging the parameters'
    gradients over ranks (``average_gradients``) gives the global loss's
    gradient, including the terms that flow through a global statistic (the
    clip-code KL, BatchNorm);
  * ``batch_var_mean`` is the two-pass mean and variance over the global
    batch (JAX's ``jnp.mean``/``jnp.var`` under its sharded ``jit``);
  * ``mean_over_ranks`` averages the per-rank means of equal-sized shards;
  * ``draw_rows`` draws random numbers for the global batch on every rank
    and keeps the rank's rows (JAX draws them for its global array);
  * ``gather_rows`` concatenates equal-shaped tensors of every rank (the eval
    features for FGD, the sequence-parallel demo's time shards);
  * ``agree`` is a max over ranks of a flag (the preemption agreement of
    JAX's ``Trainer._preempt_agreed``), ``barrier`` follows a checkpoint
    write, ``broadcast_object`` hands rank 0's choice (the run directory,
    TRAIN.AUTO_RESUME's checkpoint) to every rank.

Every collective here is an ``all_reduce`` (or ``broadcast``): gloo accepts
CUDA tensors for those two, so two ranks may share one card over gloo, where
NCCL refuses them.

``distributed()`` is whether a process group runs; without one (the default
configuration, one process) every function here is the identity or the
single-process computation, and no collective is issued. With one, even at
world size 1 (SYS.DISTRIBUTED True), the collectives run.

``mesh.py``'s ``replicate`` and ``device_init`` have no counterpart: every
rank builds the same state from SYS.SEED (``tests/test_torch_port_parallel.py``
holds the states equal), so nothing is broadcast. ``pad_eval_batch`` pads an
eval batch to the *local* device count, which is always 1 with one device a
rank: the port needs no padding beyond the loader's shard padding
(``datasets.gesture_dataset.shard_indices``).

``spawn`` starts the ranks of one host (``main.py``, ``chip_smoke.py``, the
tests): one process each, a process group on each, the function run there,
and its return value handed back to the caller, rank by rank.
"""

from __future__ import annotations

import datetime
import io
import math
import os
import queue as queue_mod
import signal
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as tdist

BACKENDS = ("nccl", "gloo")


def distributed() -> bool:
    """Whether a process group runs in this process."""
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    """This process's rank (JAX ``process_index``); 0 without a group."""
    return tdist.get_rank() if distributed() else 0


def world_size() -> int:
    """The number of ranks (JAX ``process_count``); 1 without a group."""
    return tdist.get_world_size() if distributed() else 1


def is_master() -> bool:
    """Rank 0, which alone writes the run's files (JAX ``is_master_process``)."""
    return rank() == 0


def init_process_group(rank_: int, world: int, device, init_method: str = "env://",
                       backend: Optional[str] = None, timeout_s: float = 1800.0) -> str:
    """Join the process group of ``world`` ranks as ``rank_`` at
    ``init_method`` (``tcp://addr:port``, or ``env://`` under torchrun), over
    ``backend`` (default: NCCL on the card, gloo on the CPU; gloo on the card
    when asked for: a card may then hold several ranks). On the card the
    rank's device becomes the current one. Returns the backend."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices: pass backend='gloo' on the CPU")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(f"NCCL takes one card a rank: {world} ranks, "
                             f"{torch.cuda.device_count()} cards; pass backend='gloo' to "
                             "share a card")
        torch.cuda.set_device(device)
    tdist.init_process_group(backend, init_method=init_method, rank=rank_, world_size=world,
                             timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def destroy_process_group() -> None:
    if distributed():
        tdist.destroy_process_group()


def _collective_device() -> torch.device:
    """Where the small tensors of ``agree`` and ``broadcast_object`` live:
    the current card under NCCL, the CPU under gloo."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the gradients over ranks."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ranks, with gradient (``x`` itself without a group)."""
    return _AllReduceSum.apply(x) if distributed() else x


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of ``x`` (a rank's mean over its shard: with
    equal-sized shards, the global batch's mean), with gradient; ``x``
    itself without a group."""
    return all_reduce_sum(x) / world_size() if distributed() else x


def batch_var_mean(x: torch.Tensor, dims: Sequence[int], correction: int):
    """``(var, mean, n)`` over ``dims`` of ``x`` and over every rank's ``x``
    (equal shapes), in two passes (the mean, then the squared deviations
    from it), with gradient: the variance divides by ``n - correction``, n
    the global count of values per kept index. ``x`` keeps one axis, whose
    statistics come back flat."""
    n = math.prod(x.shape[d] for d in dims) * world_size()
    mean = all_reduce_sum(x.sum(dim=tuple(dims), keepdim=True)) / n
    dev2 = ((x - mean) ** 2).sum(dim=tuple(dims), keepdim=True)
    var = all_reduce_sum(dev2) / max(n - correction, 1)
    return var.reshape(-1), mean.reshape(-1), n


def average_gradients(params) -> None:
    """Replace each parameter's ``.grad`` by its mean over ranks: one
    all-reduce of every gradient, flattened together (per dtype). Every rank
    must hold gradients for the same parameters. Nothing without a group."""
    if not distributed():
        return
    grads = [p.grad for p in params if p.grad is not None]
    world = world_size()
    for dtype in sorted({g.dtype for g in grads}, key=str):
        group = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in group])
        tdist.all_reduce(flat)
        flat /= world
        offset = 0
        for g in group:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def draw_rows(draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """This rank's ``n`` rows of a draw for the global batch: ``draw(n *
    world)``'s rows ``[rank * n, (rank + 1) * n)``, every rank drawing the
    whole from the same generator (which so stays in step on every rank);
    ``draw(n)`` without a group."""
    if not distributed():
        return draw(n)
    r = rank()
    return draw(n * world_size())[r * n:(r + 1) * n]


@torch.no_grad()
def exchange(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), stacked in rank order into a
    (world, ...) tensor on every rank: each rank writes its slot of a zeroed
    buffer and one all-reduce sums them (adding zeros is exact). ``x[None]``
    without a group."""
    if not distributed():
        return x[None]
    buf = x.new_zeros((world_size(), *x.shape))
    buf[rank()] = x
    tdist.all_reduce(buf)
    return buf


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, on every rank (``exchange``); ``x`` without a group."""
    if not distributed():
        return x
    return torch.cat(exchange(x).unbind(0), dim=dim)


def agree(flag: bool) -> bool:
    """Whether any rank's ``flag`` is set: every rank decides the same, at
    the same step (one 4-byte all-reduce)."""
    if not distributed():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_collective_device())
    tdist.all_reduce(t)
    return bool(t.item() > 0)


def barrier() -> None:
    """Wait for every rank (after rank 0 writes a checkpoint)."""
    if not distributed():
        return
    if tdist.get_backend() == "nccl":
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if not distributed():
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=0, device=_collective_device())
    return box[0]


# ---- launching the ranks of one host ---------------------------------------------

class RendezvousError(RuntimeError):
    """A rank could not join its process group (a port taken, a rendezvous
    timed out): an infrastructure failure, which ``spawn`` retries on a new
    port when it chose the port."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device, rank_: int) -> torch.device:
    """Rank ``rank_``'s device: the CPU, or card ``rank_`` modulo the cards
    present (several ranks share a card only over gloo)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank_ % max(torch.cuda.device_count(), 1))


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _pack(obj) -> bytes:
    """``obj`` with its tensors on the CPU, as bytes: a queue would share a
    tensor's memory with a process that may exit before it is read."""
    buf = io.BytesIO()
    torch.save(_to_host(obj), buf)
    return buf.getvalue()


def _rank_entry(rank_, world, fn, args, device, backend, init_method, out_queue):
    dev = rank_device(device, rank_)
    if dev.type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # the host's cores shared by its ranks (torchrun sets OMP_NUM_THREADS instead)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        init_process_group(rank_, world, dev, init_method, backend)
    except Exception:  # noqa: BLE001 - reported to the parent as a rendezvous failure
        out_queue.put(("rendezvous", rank_, traceback.format_exc()))
        return
    try:
        result = fn(rank_, dev, *args)
        out_queue.put(("ok", rank_, _pack(result)))
    except SystemExit as e:
        out_queue.put(("exit", rank_, e.code))
    except BaseException:  # noqa: BLE001 - the parent re-raises it with the traceback
        out_queue.put(("error", rank_, traceback.format_exc()))
        raise
    finally:
        destroy_process_group()


def _spawn_once(fn, world, args, device, backend, init_method, timeout_s):
    ctx = torch.multiprocessing.get_context("spawn")
    out_queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(r, world, fn, args, device, backend,
                                                   init_method, out_queue))
             for r in range(world)]
    for p in procs:
        p.start()

    def forward(signum, frame):  # a SIGTERM to the launcher preempts its ranks
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    try:
        old_handler = signal.signal(signal.SIGTERM, forward)
    except ValueError:  # not the main thread: the ranks get no forwarded signal
        old_handler = None
    results = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while len(results) < world:
            try:
                kind, r, value = out_queue.get(timeout=1.0)
            except queue_mod.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
                crashed = [(r, p.exitcode) for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0) and r not in results]
                if crashed:
                    try:  # what a rank reported just before it exited
                        kind, r, value = out_queue.get(timeout=1.0)
                    except queue_mod.Empty:
                        raise RuntimeError(f"ranks (rank, exit code) {crashed} exited and "
                                           "reported nothing") from None
                else:
                    continue
            if kind == "rendezvous":
                raise RendezvousError(f"rank {r} could not join the process group:\n{value}")
            if kind == "error":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results[r] = (kind, value)
    finally:
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
        for p in procs:
            p.join(timeout=30 if len(results) == world else 5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    return [results[r] for r in range(world)]


def spawn(fn: Callable, world: int, args: tuple = (), device="cuda",
          backend: Optional[str] = None, addr: str = "localhost", port: Optional[int] = None,
          timeout_s: Optional[float] = None, attempts: int = 3) -> List[object]:
    """Run ``fn(rank, device, *args)`` on ``world`` ranks of this host, each a
    process started by ``spawn`` (a fresh interpreter: ``fn`` and ``args``
    are pickled) with a process group at ``tcp://addr:port`` over
    ``backend``, on ``rank_device(device, rank)`` (the card unless ``device``
    is "cpu", as at every entry point). Returns the ranks' return
    values in rank order (tensors moved to the CPU). Raises the first rank
    failure with its traceback, TimeoutError past ``timeout_s`` (None: no
    limit; every rank is then killed), and SystemExit with a rank's code
    where one exits (after the others finish); a SIGTERM to this process is
    passed on to the ranks (a preemption: ``pipelines/trainer.py``). With ``port`` None each attempt takes a free
    port, and a rendezvous failure is retried, ``attempts`` times in all;
    a failure of ``fn`` is never retried."""
    for attempt in range(attempts if port is None else 1):
        init = f"tcp://{addr}:{port or free_port()}"
        try:
            outcome = _spawn_once(fn, world, args, device, backend, init, timeout_s)
            break
        except RendezvousError:
            if port is not None or attempt == attempts - 1:
                raise
    codes = [v for kind, v in outcome if kind == "exit"]
    if codes:
        raise SystemExit(codes[0])
    return [torch.load(io.BytesIO(v), weights_only=False) for _, v in outcome]


def torchrun_env() -> Optional[tuple]:
    """``(rank, world, local_rank)`` from the environment ``torchrun`` sets,
    or None outside it."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", env["RANK"]))
