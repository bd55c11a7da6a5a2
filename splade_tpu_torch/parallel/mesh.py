"""Data-parallel layout over ``torch.distributed`` (counterpart of
``splade_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a 1-D ``data`` mesh: parameters
replicated, the batch sharded on the data axis, one gradient psum per
optimizer step, and ``jax.distributed`` across hosts. The port runs one
process a device (``torchrun``); each rank holds a replica of the
parameters and its own contiguous rows of every micro-batch:

- ``init_distributed`` joins the process group, NCCL for a CUDA device and
  gloo for the CPU, after setting the rank's device: the kernel wrappers
  launch on the current stream of the tensor's device, and the ctypes kernel
  library sets its attributes on the thread's current device, so both assume
  the thread's device is the rank's.
- ``GradReducer`` is the one gradient reduction of an optimizer step: the
  gradients, already divided by the accumulation count, are copied into one
  persistent f32 buffer in the parameters' order, all-reduced with SUM in
  buckets of ``BUCKET_ELEMS``, divided by the world size and copied back.
  SUM then divide (gloo has no AVG) gives, on either backend, the bits of an
  in-process ``(g0 + g1) / 2`` of two ranks' gradients.
- ``all_reduce_mean`` averages the logged metrics the same way, so every
  rank logs the global numbers; ``broadcast_params_`` hands rank 0's
  parameters to every rank; ``agree_any`` and ``same_on_all_ranks`` let the
  ranks take a host decision together (stop on a signal, the checkpoint to
  resume). Under NCCL these two run on a gloo group of their own
  (``DataMesh.host_group``), so an agreement each step never waits on the
  card.

The device half of the JAX module, ``make_mesh``, lays a doc-sharded
index out (``DeviceMesh``): one process, the shards placed on a list of
devices, as JAX's single-controller mesh places them. Its
``replicated_sharding`` and ``batch_sharding`` have no counterpart: the
mesh indexes place each shard's tensors on its device themselves.

Nothing here imports ``splade_tpu`` or ``jax``.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device

#: f32 elements a bucket of the gradient all-reduce (64 MB)
BUCKET_ELEMS = 1 << 24
#: what ``init_distributed`` reads, as torchrun sets it
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclass(frozen=True)
class DeviceMesh:
    """The devices a doc-sharded index stands on, in shard order: shard d
    lives on ``devices[d]``, and ``devices[0]`` encodes the query and merges
    the shards' partial top-ks. A device may repeat (eight shards on one
    card, or on the CPU, as JAX's tests place eight virtual devices on one
    host). ``axis_names`` names the one axis, for the reader's sake."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(num_data: int = -1,
              devices: Optional[Sequence[DeviceLike]] = None) -> DeviceMesh:
    """A 1-D mesh over ``devices`` (every visible CUDA device when None),
    cut to the first ``num_data`` when that is above 0. With no card and no
    explicit devices it raises, as ``resolve_device`` does; ``num_data``
    above the device count raises ValueError."""
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises: no CUDA device
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if num_data and num_data > 0:
        if num_data > len(devs):
            raise ValueError(f"requested {num_data} devices, have "
                             f"{len(devs)}")
        devs = devs[:num_data]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return DeviceMesh(tuple(devs))


@dataclass(frozen=True)
class DataMesh:
    """This process's place in the data-parallel run: rank, world size,
    local rank, its device, the process group's backend (None when there is
    no process group: one process, nothing to reduce) and the gloo group
    host decisions go through (None: the default group, itself gloo)."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    backend: Optional[str] = None
    host_group: Any = None

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _launch_env(name: str) -> str:
    raw = os.environ.get(name)
    if raw is None:
        raise RuntimeError(
            f"distributed training: {name} is not set; launch one process a "
            "device with torchrun (python -m torch.distributed.run "
            "--nproc_per_node N -m splade_tpu_torch.train ... --distributed)")
    return raw


def init_distributed(device: DeviceLike = None, backend: Optional[str] = None,
                     init_method: str = "env://") -> DataMesh:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``; ``MASTER_ADDR`` and ``MASTER_PORT`` for ``env://``) and
    return this rank's ``DataMesh``. ``device`` None is ``cuda:{LOCAL_RANK}``
    (``resolve_device``); the device is made current before the group
    exists, so nothing touches another card. ``backend`` None is NCCL on a
    CUDA device and gloo on the CPU. A failure to join raises."""
    rank, world, local_rank = (int(_launch_env(name)) for name in LAUNCH_ENV)
    if init_method == "env://":
        for name in ("MASTER_ADDR", "MASTER_PORT"):
            _launch_env(name)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    # under NCCL the host decisions get a gloo group of their own: a
    # collective call, made here by every rank in the same order
    host_group = dist.new_group(backend="gloo") if backend != "gloo" else None
    return DataMesh(rank=rank, world=world, local_rank=local_rank, device=dev,
                    backend=backend, host_group=host_group)


def barrier(mesh: DataMesh) -> None:
    """Wait for every rank (nothing to wait for with no process group); on
    the host group, so it never waits on the card."""
    if mesh.distributed:
        dist.barrier(group=mesh.host_group)


def agree_any(flag: bool, mesh: DataMesh) -> bool:
    """True on every rank when ``flag`` is true on any rank."""
    if not mesh.distributed:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def same_on_all_ranks(text: str, mesh: DataMesh) -> bool:
    """Whether ``text`` is the same on every rank (its digest against rank
    0's, then agreed), with the same answer on every rank: the counterpart
    of ``multihost_utils.broadcast_one_to_all`` as the JAX CLI uses it."""
    if not mesh.distributed:
        return True
    mine = torch.tensor(list(hashlib.sha256(text.encode()).digest()),
                        dtype=torch.uint8)
    first = mine.clone()
    dist.broadcast(first, src=0, group=mesh.host_group)
    return not agree_any(not torch.equal(first, mine), mesh)


def all_reduce_sum(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of ``t`` over ranks, without a gradient (``t`` itself with no
    process group)."""
    if not mesh.distributed:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_reduce_mean(values: Dict[str, torch.Tensor], mesh: DataMesh
                    ) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over ranks in one collective: SUM, then
    divided by the world size."""
    if not mesh.distributed:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().to(torch.float32).reshape(())
                        for k in keys])
    dist.all_reduce(flat)
    flat = flat / mesh.world
    return dict(zip(keys, flat.unbind()))


def broadcast_params_(module: torch.nn.Module, mesh: DataMesh) -> None:
    """Rank 0's parameters and buffers onto every rank, in place."""
    if not mesh.distributed:
        return
    with torch.no_grad():
        for t in itertools.chain(module.parameters(), module.buffers()):
            dist.broadcast(t.detach(), src=0)


class GradReducer:
    """The gradient all-reduce of an optimizer step (see the module's
    docstring), with its persistent f32 buffer. ``last_ms`` is the time of
    the last reduction, copies in and out included: CUDA events on the card
    (read once the step has finished), the host clock on the CPU."""

    def __init__(self, mesh: DataMesh):
        self.mesh = mesh
        self.buffer: Optional[torch.Tensor] = None
        self._events = None
        self._host_ms: Optional[float] = None

    def __call__(self, grads: List[torch.Tensor]) -> None:
        n = sum(g.numel() for g in grads)
        dev = grads[0].device
        if (self.buffer is None or self.buffer.numel() != n
                or self.buffer.device != dev):
            self.buffer = torch.empty(n, dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        t0 = time.perf_counter()
        torch.cat([g.reshape(-1).to(torch.float32) for g in grads],
                  out=self.buffer)
        for lo in range(0, n, BUCKET_ELEMS):
            dist.all_reduce(self.buffer[lo:lo + BUCKET_ELEMS])
        self.buffer.div_(self.mesh.world)
        for g, part in zip(grads, torch.split(self.buffer,
                                              [g.numel() for g in grads])):
            g.copy_(part.view_as(g))
        if dev.type == "cuda":
            self._events[1].record()
        else:
            self._host_ms = (time.perf_counter() - t0) * 1e3

    @property
    def last_ms(self) -> Optional[float]:
        if self._events is not None:
            self._events[1].synchronize()
            return self._events[0].elapsed_time(self._events[1])
        return self._host_ms


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world: int, rank: int):
        ctx.rank, ctx.rows = rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None, None


def all_gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's rows of ``x`` stacked in rank order ([world * B, ...]),
    with a gradient: the backward sums the ranks' gradients with respect to
    the stacked rows (one all-reduce) and gives each rank its own rows.
    (``torch.distributed.nn.functional.all_gather`` sums back through a
    reduce-scatter, which gloo lacks, or an all-to-all.)"""
    if not mesh.distributed or mesh.world == 1:
        return x
    return _GatherRows.apply(x, mesh.world, mesh.rank)
