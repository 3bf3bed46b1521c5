"""Env-batch data parallelism over ``torch.distributed`` ranks (counterpart of
``unitree_rl_gym_tpu/parallel/mesh.py``).

The JAX package shards the env axis over a 1-D ("env",) device mesh and lets
XLA insert the collectives. Here each rank is one process that owns one
contiguous block of the global env batch (:class:`EnvBlock`) and a full
replica of the parameters; the algorithm code writes the global semantics
out by hand (``rl/ppo.py``): random draws of the global shape, of which a
rank keeps its rows, and every cross-env mean as a local sum over a global
count, summed over ranks by :func:`all_reduce_sum`. A run of N envs over W
ranks then gives the results of one process on the same N envs up to the
order of floating-point sums.

Launch with torchrun, which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``::

    python -m torch.distributed.run --nproc_per_node=2 \\
        -m unitree_rl_gym_tpu_torch.scripts.train --task=go2

:func:`init_process_group` picks the backend by rule: NCCL when every rank
of the host has a CUDA device of its own, gloo on the CPU; ranks that would
share a card raise unless the caller names ``backend="gloo"`` (gloo moves
CUDA tensors through host memory, which :func:`all_reduce_sum` does
explicitly). Nothing is chosen silently.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

# EnvState fields in row layout, [k, N]: the env axis is axis 1 (the
# terrain carry: step-start point heights gh [ncp, N], end-of-step point xy
# p_xy [2*ncp, N]). Declared by name, never inferred from shapes.
ROW_LAYOUT_FIELDS = frozenset({"gh", "p_xy"})
# fields that are the same for every env (the live command range [2], the
# handstand's RSI probability, a 0-d tensor): every rank keeps them whole
REPLICATED_FIELDS = frozenset({"cmd_vx_range", "task_state"})

# a rank that raises leaves the others waiting in their next collective:
# the process group's own timeout turns that wait into an error
DEFAULT_TIMEOUT_S = 120


@dataclasses.dataclass(frozen=True)
class EnvBlock:
    """One rank's contiguous block ``[offset, offset + n_local)`` of the
    ``n_global`` envs."""

    rank: int
    world_size: int
    offset: int
    n_local: int
    n_global: int

    def rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This block's slice of a tensor over all envs on axis ``dim``."""
        return x.narrow(dim, self.offset, self.n_local)


def env_block(n_global: int, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> EnvBlock:
    """The block of ``rank`` (default: this process's rank in the process
    group) in an even split of ``n_global`` envs over ``world_size`` ranks
    (default: the group's size; 1 without a group)."""
    if rank is None or world_size is None:
        on = dist.is_available() and dist.is_initialized()
        rank = (dist.get_rank() if on else 0) if rank is None else rank
        world_size = ((dist.get_world_size() if on else 1)
                      if world_size is None else world_size)
    if n_global % world_size != 0:
        raise ValueError(
            f"{n_global} envs do not split evenly over {world_size} ranks")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    n = n_global // world_size
    return EnvBlock(rank=rank, world_size=world_size, offset=rank * n,
                    n_local=n, n_global=n_global)


def launched_by_torchrun() -> bool:
    """True in a process that torchrun (or a caller setting its variables)
    started as one rank of a job."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_process_group(device, backend: Optional[str] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the job that torchrun's variables describe (the counterpart of
    ``distributed_initialize_if_needed``); returns this rank's device.

    ``device`` "cpu": gloo. ``device`` "cuda": NCCL, each rank on
    ``cuda:LOCAL_RANK``, when the host has a card for every local rank;
    with fewer cards the ranks would share one, which NCCL refuses, so this
    raises unless ``backend="gloo"`` is named (ranks then share
    ``cuda:LOCAL_RANK % device_count``)."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: use gloo")
        backend = "gloo"
    elif dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was asked for but is not available")
        n_dev = torch.cuda.device_count()
        shared = n_dev < local_world
        if backend is None:
            if shared:
                raise RuntimeError(
                    f"{local_world} ranks on this host and {n_dev} CUDA "
                    "device(s): ranks would share a card, which NCCL "
                    "refuses; pass backend='gloo' to run them over gloo")
            backend = "nccl"
        elif backend == "nccl" and shared:
            raise RuntimeError(
                f"NCCL needs a card per rank: {local_world} ranks, {n_dev} "
                "device(s)")
        elif backend not in ("nccl", "gloo"):
            raise ValueError(f"unknown backend {backend!r}")
        dev = torch.device("cuda", local_rank % n_dev)
        torch.cuda.set_device(dev)
    else:
        raise ValueError(f"unsupported device {dev}")
    dist.init_process_group(
        backend=backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def shard_env_state(state, block: EnvBlock):
    """This block's part of a state over all envs: an ``EnvState``, a
    ``PhysicsState`` or a dict (the control step's aux). Row-layout fields
    (:data:`ROW_LAYOUT_FIELDS`) are sliced on axis 1 and made contiguous,
    :data:`REPLICATED_FIELDS` and non-tensors are kept whole, every other
    tensor is sliced on axis 0 (a contiguous view)."""

    def part(name, x):
        if dataclasses.is_dataclass(x) or isinstance(x, dict):
            return shard_env_state(x, block)
        if not torch.is_tensor(x) or name in REPLICATED_FIELDS:
            return x
        if name in ROW_LAYOUT_FIELDS:
            return block.rows(x, 1).contiguous()
        return block.rows(x, 0)

    if isinstance(state, dict):
        return {k: part(k, v) for k, v in state.items()}
    return dataclasses.replace(state, **{
        f.name: part(f.name, getattr(state, f.name))
        for f in dataclasses.fields(state)})


def _over_host(x: torch.Tensor) -> bool:
    """gloo moves CUDA tensors through host memory: do that here, once."""
    return x.is_cuda and dist.get_backend() == "gloo"


def all_reduce_sum(buf: torch.Tensor) -> torch.Tensor:
    """Sum ``buf`` over all ranks, in place; every rank gets the same bits.
    Without a process group (one rank) it returns ``buf`` untouched."""
    if not (dist.is_available() and dist.is_initialized()):
        return buf
    if _over_host(buf):
        host = buf.to("cpu")
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        buf.copy_(host)
    else:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf


def broadcast_(tensors, src: int = 0):
    """Overwrite ``tensors`` (a list, one dtype) with rank ``src``'s
    values, in one collective over their concatenation."""
    if not (dist.is_available() and dist.is_initialized()) or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    if _over_host(flat):
        host = flat.to("cpu")
        dist.broadcast(host, src=src)
        flat.copy_(host)
    else:
        dist.broadcast(flat, src=src)
    i = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


# ---------------------------------------------------------------------------
# launching ranks from Python (chip_smoke.py, the dryrun, the tests)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, port, args):
    os.environ.update(
        RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
        LOCAL_WORLD_SIZE=str(world_size), MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(port))
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args=(), timeout_s: float = 600.0):
    """Run ``fn(*args)`` as each of ``world_size`` ranks of one job on this
    host, as torchrun would: fresh interpreters (the ``spawn`` method, safe
    after CUDA is initialised; ``fn`` must be importable by name) with
    torchrun's variables set, so ``fn`` calls :func:`init_process_group`.
    Raises when a rank exits non-zero or the ranks outlive ``timeout_s``
    (every rank is then killed): a failed rank never passes silently."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world_size, port, tuple(args)))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if late:
            raise TimeoutError(f"ranks {late} still running after {timeout_s} s")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if failed:
            raise RuntimeError(f"ranks exited non-zero: {failed}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
