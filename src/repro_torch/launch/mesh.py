"""Process meshes of the port's ``mesh`` backend, on ``torch.distributed``.

Counterpart of the reference's ``launch/mesh.py``. Where the reference lays
a ``(data, model)`` device mesh out under one controller, the port runs one
process (rank) per ``(vertex, sim)`` shard:

* ``ProcessMesh`` holds the grid's ``shape`` and ``axis_names``, this
  rank's coordinate ``(v, s)`` (ranks are row-major, ``rank = v * mu_s + s``,
  the order ``jax.make_mesh`` gives ``("data", "model")``), its vertex group
  (the ranks of its ``s``) and sim group (the ranks of its ``v``), its
  device, and its ``Exchange``: the collectives of the mesh program.
* ``make_mesh(shape, axes)`` and ``make_im_mesh(devices, mu_v=0)`` build one
  from the initialized process group, on every rank of it (making the
  groups is collective); a grid is made once per process and reused.
* ``init_world`` joins the process group: from the environment that
  ``torchrun`` (``python -m torch.distributed.run``) sets, or from an
  explicit ``init_method`` with the rank and world size. The group gets a
  finite timeout, so a deadlocked collective fails the run.
* ``spawn_world`` runs a function on a fresh world of N spawned processes
  and returns each rank's result (the tests and ``chip_smoke.py`` use it).

The transport follows from the placement, once, when the mesh is made, and
never changes after a failure:

* a rank on the CPU exchanges CPU tensors over gloo;
* one rank per card (``LOCAL_WORLD_SIZE`` at most the cards) joins an NCCL
  group and exchanges device tensors;
* ranks that share a card join a gloo group (NCCL refuses two ranks on one
  device), and each exchange is staged through pinned host buffers that are
  allocated once per shape.

An NCCL or gloo error raises; nothing gives way to another transport.
``make_production_mesh`` and ``make_serving_mesh`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.obs import trace

#: seconds a collective may wait before the run fails
DEFAULT_TIMEOUT_S = 300.0


def env_world() -> bool:
    """True where ``torchrun`` (or ``torch.distributed.run``) started this
    process: it sets ``RANK`` and ``WORLD_SIZE``."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _local_placement() -> Tuple[int, int]:
    """(local rank, local world size): ``torchrun``'s ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``, else the global rank and world (one host)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def _rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: the CPU, or card ``local_rank % cards``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_world(*, device=None, init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group, unless this process already has one.

    Without ``init_method`` the group comes from ``torchrun``'s environment
    (``env://``); with one, ``rank`` and ``world_size`` must be given. The
    backend follows from the placement: NCCL where every rank of the host
    has a card of its own (``device`` CUDA, the default), gloo on the CPU
    and where ranks share a card."""
    if dist.is_initialized():
        return
    if init_method is None:
        if not env_world():
            raise RuntimeError("no process group to join: run under torchrun "
                               "(python -m torch.distributed.run --nproc-per-node N) "
                               "or pass init_method, rank and world_size")
        init_method = "env://"
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    elif rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = _rank_device(device, local_rank)
    backend = "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if local_world <= torch.cuda.device_count():
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


class Exchange:
    """The mesh program's collectives on one rank, over one transport.

    ``"nccl"`` exchanges device tensors; ``"gloo"`` CPU tensors; ``"gloo+host"``
    stages device tensors through pinned host buffers, one per (use, shape),
    allocated at the first exchange of that shape and kept. Every exchange
    adds its calls, the bytes this rank sent and its host seconds (device
    copies included where staged; an NCCL call returns once queued) to
    ``stats``, and runs in a span (``mesh.ring_shift``, ``mesh.all_gather``,
    ``mesh.all_reduce``; recorded where the trace recorder is on)."""

    def __init__(self, transport: str, device: torch.device):
        self.transport, self.device = transport, device
        self.staged = transport == "gloo+host"
        self._buffers: dict = {}
        self.stats: dict = {}

    def _count(self, kind: str, nbytes: int, seconds: float) -> None:
        calls, sent, secs = self.stats.get(kind, (0, 0, 0.0))
        self.stats[kind] = (calls + 1, sent + int(nbytes), secs + seconds)

    def _host(self, use: str, like: torch.Tensor, shape=None) -> torch.Tensor:
        shape = tuple(like.shape) if shape is None else tuple(shape)
        key = (use, shape, like.dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=like.dtype, pin_memory=True)
            self._buffers[key] = buf
        return buf

    def ring_shift(self, block: torch.Tensor, out: torch.Tensor, *, send_to: int,
                   recv_from: int) -> torch.Tensor:
        """Send ``block`` to rank ``send_to`` and receive rank ``recv_from``'s
        into ``out`` (the reference's ``ppermute`` of one ring step)."""
        t0 = time.perf_counter()
        with trace.span("mesh.ring_shift", phase="ring", bytes=block.numel()):
            if self.staged:
                send, recv = self._host("send", block), self._host("recv", out)
                send.copy_(block)
            else:
                send, recv = block, out
            ops = [dist.P2POp(dist.isend, send, send_to),
                   dist.P2POp(dist.irecv, recv, recv_from)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            if self.staged:
                out.copy_(recv)
        self._count("ring_shift", block.numel() * block.element_size(),
                    time.perf_counter() - t0)
        return out

    def all_gather(self, t: torch.Tensor, group, size: int) -> torch.Tensor:
        """``(size, *t.shape)``: every rank's ``t`` of ``group``, in group
        rank order, on this rank's device."""
        t0 = time.perf_counter()
        nbytes = t.numel() * t.element_size()
        with trace.span("mesh.all_gather", phase="ring", bytes=nbytes, ranks=size):
            if size == 1:
                out = t.unsqueeze(0).clone()
            elif self.staged:
                host = self._host("gather", t, (size, *t.shape))
                send = self._host("gather_send", t)
                send.copy_(t)
                dist.all_gather(list(host.unbind(0)), send, group=group)
                out = host.to(self.device)
            else:
                out = torch.empty((size, *t.shape), dtype=t.dtype, device=t.device)
                dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
        self._count("all_gather", nbytes if size > 1 else 0, time.perf_counter() - t0)
        return out

    def all_reduce(self, value: int, op, group=None) -> int:
        """One int64 ``all_reduce`` (``op`` a ``ReduceOp``) over ``group``;
        returns the result on the host."""
        t0 = time.perf_counter()
        with trace.span("mesh.all_reduce", phase="ring"):
            dev = self.device if self.transport == "nccl" else torch.device("cpu")
            t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
            dist.all_reduce(t, op=op, group=group)
            out = int(t.item())
        self._count("all_reduce", 8, time.perf_counter() - t0)
        return out

    def summary(self, since: Optional[dict] = None) -> dict:
        """``{kind: {"calls", "bytes_sent", "seconds"}}``, counted from the
        ``since`` copy of ``stats`` when one is given."""
        since = since or {}
        out = {}
        for kind, (c, b, s) in sorted(self.stats.items()):
            c0, b0, s0 = since.get(kind, (0, 0, 0.0))
            if c > c0:
                out[kind] = dict(calls=c - c0, bytes_sent=b - b0, seconds=s - s0)
        return out


@dataclasses.dataclass
class ProcessMesh:
    """One rank's view of a ``(mu_v, mu_s)`` process grid (module doc)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    coord: Tuple[int, int]
    device: torch.device
    exchange: Exchange
    vertex_group: object
    sim_group: object
    grid_group: object           # None: the whole world
    world_size: int
    devices: Tuple[str, ...]     # each grid rank's device, in rank order

    @property
    def mu_v(self) -> int:
        return self.shape[0]

    @property
    def mu_s(self) -> int:
        return math.prod(self.shape[1:])

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def transport(self) -> str:
        return self.exchange.transport

    def rank_of(self, v: int, s: int) -> int:
        return v * self.mu_s + s

    def describe(self) -> str:
        """``world=… grid=…x… transport=… devices=…``."""
        return (f"world={self.world_size} grid={'x'.join(map(str, self.shape))} "
                f"({', '.join(self.axis_names)}) transport={self.transport} "
                f"devices={','.join(self.devices)}")


_MESHES: dict = {}


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device=None) -> ProcessMesh:
    """The ``shape`` grid over the first ``prod(shape)`` ranks of the
    initialized process group, on every rank of it (``new_group`` is
    collective). ``shape`` is ``(mu_v, mu_s)`` or ``(mu_v, *sim axes)``; the
    sim axes flatten row-major. Made once per process for each (shape,
    axes, device) and reused. Raises when no group is initialized, when the
    world is smaller than the grid, when this rank lies outside the grid,
    or when the group's backend cannot serve this placement."""
    shape, axes = tuple(int(d) for d in shape), tuple(axes)
    if len(shape) != len(axes) or len(shape) < 2:
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up, "
                         "a vertex axis first")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group is initialized: run under torchrun or "
                           "call launch.mesh.init_world first")
    dev_kind = resolve_device(device).type
    key = (shape, axes, dev_kind)
    if key in _MESHES:
        return _MESHES[key]
    world, rank = dist.get_world_size(), dist.get_rank()
    size = math.prod(shape)
    if world < size:
        raise ValueError(f"mesh {shape} needs {size} ranks, the world has {world}")
    if rank >= size:
        raise ValueError(f"rank {rank} lies outside the {shape} grid of the first "
                         f"{size} ranks; run one rank per shard")
    mu_v, mu_s = shape[0], math.prod(shape[1:])
    local_rank, _ = _local_placement()
    dev = _rank_device(device, local_rank)
    backend = dist.get_backend()
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"a CPU rank needs a gloo group, this one is {backend}")
        transport = "gloo"
    elif backend == "nccl":
        transport = "nccl"
    elif backend == "gloo":
        transport = "gloo+host"
    else:
        raise ValueError(f"unsupported process group backend {backend!r}")
    vertex_groups = [dist.new_group([v * mu_s + s for v in range(mu_v)])
                     for s in range(mu_s)]
    sim_groups = [dist.new_group([v * mu_s + s for s in range(mu_s)])
                  for v in range(mu_v)]
    grid_group = dist.new_group(list(range(size))) if world > size else None
    devices = [None] * size
    dist.all_gather_object(devices, str(dev), group=grid_group)
    v, s = divmod(rank, mu_s)
    mesh = ProcessMesh(shape=shape, axis_names=axes, rank=rank, coord=(v, s),
                       device=dev, exchange=Exchange(transport, dev),
                       vertex_group=vertex_groups[s], sim_group=sim_groups[v],
                       grid_group=grid_group, world_size=world, devices=tuple(devices))
    _MESHES[key] = mesh
    return mesh


def make_im_mesh(devices: int, *, mu_v: int = 0, device=None) -> ProcessMesh:
    """``(data, model)`` mesh of the IM drivers: ``mu_v`` vertex shards x
    ``devices / mu_v`` sim shards; ``mu_v=0`` takes the reference's default
    (2 when ``devices`` is even, else 1)."""
    if mu_v <= 0:
        mu_v = 2 if devices % 2 == 0 else 1
    if devices % mu_v != 0:
        raise ValueError(f"--devices {devices} not divisible by mu_v={mu_v}")
    return make_mesh((mu_v, devices // mu_v), ("data", "model"), device=device)


def shutdown_world() -> None:
    """Leave the process group and forget the meshes made on it."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _world_entry(rank: int, fn: Callable, nprocs: int, workdir: str, device,
                 timeout_s: float, args: tuple) -> None:
    if resolve_device(device).type == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    init_world(device=device, init_method=f"file://{workdir}/pg_init", rank=rank,
               world_size=nprocs, timeout_s=timeout_s)
    try:
        out = fn(rank, *args)
        torch.save(out, Path(workdir) / f"rank{rank}.pt")
    finally:
        shutdown_world()


def spawn_world(fn: Callable, nprocs: int, *, workdir, device=None, args: tuple = (),
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(rank, *args)`` on ``nprocs`` spawned processes that form one
    process group (``init_world`` from a ``file://`` store in ``workdir``,
    which must not hold one yet) and return each rank's result, in rank
    order. ``fn`` must be importable by name (a module-level function), its
    result picklable. A rank's exception fails the whole call."""
    import torch.multiprocessing as mp

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    if (workdir / "pg_init").exists():
        raise FileExistsError(f"{workdir / 'pg_init'} exists: use a fresh directory")
    mp.spawn(_world_entry, args=(fn, nprocs, str(workdir), device, timeout_s, args),
             nprocs=nprocs, join=True)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(nprocs)]
