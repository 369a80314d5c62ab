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

**The serving mesh** (device residency, ``service.store.StoreEntry.
place_on_mesh``). ``make_serving_mesh(mu_v)`` is the reference's ``(mu_v,
1)`` mesh: one plan-order row block a rank, the sample space whole on each.
Where the reference runs each serving program as one ``shard_map`` from one
controller, ``serve_world(fn, graphs=...)`` makes rank 0 the controller: it
runs ``fn`` (the store, the engines, the launcher) while every other rank
runs ``follow``, a loop that takes one operation record at a time from the
controller (``broadcast_object_list`` over a gloo control group whose
timeout is long, since a server may idle) and runs the same operation body
on its own block. An operation is a module-level function
``body(state, payload, local)``, and the record names it by reference (as
pickle does), so a follower imports the body's module on first use and this
module keeps no list of operations. The bodies live where their work
does: placement, gather, bank comparison, mesh creation and graph sharing
here; spread, marginal and probe in ``service/queries.py``; the warm rounds
and the shard repair in ``core/distributed.py``; a backend's cold call in
``service/world.py``.

* ``Controller.call`` holds one lock for a whole operation, the record and
  every collective of its body, so the async engine's serving and mutation
  threads never interleave their collectives. Each operation ends in a
  barrier of every rank (a finite timeout); a follower whose body raises
  exits, its peers' collectives fail, and the controller raises, marks the
  mesh failed and refuses further operations. Nothing is caught and
  skipped.
* Graphs reach the followers by content, never in the records of the hot
  path: each follower holds the graphs it was started with (as the
  launcher makes them, from the same seed) and their destination-sorted
  forms, found by a content fingerprint; a delta travels as its
  ``GraphDelta`` and every rank applies it at once (``Graph.apply_delta``,
  deterministic; the ranks' fingerprints must agree). ``Controller.share_graph``
  ships a whole graph only when some follower lacks it (a snapshot's graph,
  say), once.
* A ``Placement`` is the controller's handle of a placed plan-order
  matrix: block v (rows ``[v * n_loc, (v + 1) * n_loc)``) lives on rank v.
  Blocks, graphs and plans the controller no longer references are dropped
  on every rank with the next operation (weak references).
* ``make_mesh`` and the mesh backend are SPMD only: every rank calls them.
  The controller makes a grid on every rank with ``Controller.make_mesh``
  (``serving_mesh`` for the ``(mu_v, 1)`` one); the serving layer routes a
  backend's cold call through the world itself (``service.world``).
  ``make_mesh`` on a controller outside an operation raises, as it would
  otherwise wait on followers that never join.

**The dry run** (``launch.dryrun``) lowers for grids no process group can
host. ``make_production_mesh`` returns the reference's production grids as a
``MeshShape``, a shape and axis names alone; ``dry_mesh`` gives one rank's
view of such a grid, a ``ProcessMesh`` on the ``meta`` device whose
``DryExchange`` sends nothing and records each collective for
``utils.collectives``.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import hashlib
import itertools
import math
import os
import threading
import time
import weakref
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.obs import trace
from repro_torch.utils.collectives import CollectiveRecord

#: seconds a collective may wait before the run fails
DEFAULT_TIMEOUT_S = 300.0
#: seconds a follower waits for the controller's next operation record
FOLLOW_TIMEOUT_S = 7 * 24 * 3600.0


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
    ``mesh.ordered_sum``, ``mesh.all_reduce``, ``mesh.all_reduce_max``,
    ``mesh.scatter``, ``mesh.gather``; recorded where the trace recorder is
    on). The serving
    kinds (the tensor MAX, the scatter and the gather of row blocks) stage
    one-off shapes through unpinned host copies."""

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

    def ordered_sum(self, t: torch.Tensor, group, size: int) -> torch.Tensor:
        """The elementwise sum of every rank's ``t`` over ``group``, added in
        group rank order (``((t_0 + t_1) + t_2) + ...``), as a new tensor on
        this rank's device, the same on every rank of the group.

        Float addition is not associative, so the order is part of the
        result; the serial ring adds its sim shards in this order. A
        reduce-scatter and an all-gather, as a ring all-reduce moves: ``t``
        is cut into ``size`` chunks (zero padded); an ``all_to_all`` hands
        rank i every rank's chunk i, which it adds in rank order; an
        ``all_gather`` returns the summed chunks. Each rank sends ``(size -
        1) / size`` of the padded ``t`` twice, whatever ``size``."""
        t0 = time.perf_counter()
        chunk = -(-t.numel() // size)
        nbytes = size * chunk * t.element_size()
        with trace.span("mesh.ordered_sum", phase="ring", bytes=nbytes, ranks=size):
            if size == 1:
                out = t.clone()
            else:
                dev = torch.device("cpu") if self.staged else t.device
                flat = torch.zeros(size * chunk, dtype=t.dtype, device=dev)
                flat[:t.numel()] = t.reshape(-1)
                parts = torch.empty_like(flat)
                dist.all_to_all_single(parts, flat, group=group)
                parts = parts.view(size, chunk)
                acc = parts[0].clone()
                for i in range(1, size):     # in group rank order
                    acc += parts[i]
                sums = torch.empty((size, chunk), dtype=t.dtype, device=dev)
                dist.all_gather(list(sums.unbind(0)), acc, group=group)
                out = sums.reshape(-1)[:t.numel()].reshape(t.shape).to(self.device)
        self._count("ordered_sum", nbytes if size > 1 else 0, time.perf_counter() - t0)
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

    def all_reduce_max(self, t: torch.Tensor, group) -> torch.Tensor:
        """The elementwise MAX of every rank's ``t`` over ``group`` (the
        reference's ``pmax``), as a new tensor on this rank's device."""
        t0 = time.perf_counter()
        nbytes = t.numel() * t.element_size()
        with trace.span("mesh.all_reduce_max", phase="ring", bytes=nbytes):
            buf = t.cpu() if self.staged else t.clone()
            dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
            out = buf.to(self.device) if self.staged else buf
        self._count("all_reduce_max", nbytes, time.perf_counter() - t0)
        return out

    def scatter(self, chunks, out: torch.Tensor, group, *, src: int = 0) -> torch.Tensor:
        """Fill ``out`` with chunk i of rank ``src``'s ``chunks`` on the i-th
        rank of ``group`` (``src`` is a global rank; ``chunks`` is None on
        every other rank). The placement of row blocks."""
        t0 = time.perf_counter()
        size = dist.get_world_size(group)
        sent = (sum(c.numel() * c.element_size() for c in chunks) - out.numel()
                * out.element_size()) if chunks is not None else 0
        with trace.span("mesh.scatter", phase="ring", bytes=sent, ranks=size):
            if size == 1:
                out.copy_(chunks[0])
            elif self.staged:
                recv = torch.empty(out.shape, dtype=out.dtype)
                dist.scatter(recv, [c.cpu() for c in chunks] if chunks is not None else None,
                             src=src, group=group)
                out.copy_(recv)
            else:
                dist.scatter(out, [c.contiguous() for c in chunks]
                             if chunks is not None else None, src=src, group=group)
        self._count("scatter", sent, time.perf_counter() - t0)
        return out

    def gather(self, t: torch.Tensor, group, *, dst: int = 0) -> Optional[torch.Tensor]:
        """``(size, *t.shape)``: every rank's ``t`` of ``group`` in group rank
        order, on rank ``dst`` (a global rank); None on the others."""
        t0 = time.perf_counter()
        size = dist.get_world_size(group)
        mine = dist.get_rank() == dst
        nbytes = t.numel() * t.element_size()
        with trace.span("mesh.gather", phase="ring", bytes=nbytes, ranks=size):
            if size == 1:
                out = t.unsqueeze(0).clone()
            else:
                send = t.cpu() if self.staged else t.contiguous()
                host = (torch.empty((size, *t.shape), dtype=t.dtype, device=send.device)
                        if mine else None)
                dist.gather(send, list(host.unbind(0)) if mine else None, dst=dst,
                            group=group)
                out = host.to(self.device) if mine else None
        self._count("gather", 0 if mine else nbytes, time.perf_counter() - t0)
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


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """A group of a dry rank's mesh: its size; nothing is sent on it."""

    size: int


class DryExchange(Exchange):
    """The collectives of a dry rank (``launch.dryrun``): nothing is sent.

    Every call counts through ``_count`` as the real one does (the call, the
    bytes this rank would send, 0 seconds), so a dry ``summary()`` compares
    field for field with a real rank's. Each call also appends a
    ``CollectiveRecord`` (kind, payload bytes, group size, the shape sent)
    to ``records``, for the ring formulas of ``utils.collectives``; the
    payload is the result's bytes, as the reference's HLO counts it: the
    ring block, the gathered tensor, the reduced value (the padded sum of
    an ordered sum), every chunk of a scatter or a gather. Results are
    ``meta`` tensors of the real shapes; ``all_reduce`` returns 0. ``rank``
    is this rank's global rank (a scatter's source and a gather's
    destination send nothing to themselves); ``world_size`` the size of the
    ``None`` group."""

    def __init__(self, world_size: int, rank: int = 0):
        super().__init__("dry", torch.device("meta"))
        self.world_size, self.rank = int(world_size), int(rank)
        self.records: list = []

    def _record(self, kind: str, payload: int, group_size: int, shape, sent: int) -> None:
        self.records.append(CollectiveRecord(kind, int(payload), int(group_size),
                                             tuple(shape)))
        self._count(kind, sent, 0.0)

    def _size(self, group) -> int:
        return self.world_size if group is None else group.size

    def ring_shift(self, block: torch.Tensor, out: torch.Tensor, *, send_to: int,
                   recv_from: int) -> torch.Tensor:
        self._record("ring_shift", block.nbytes, 2, block.shape, block.nbytes)
        return out

    def all_gather(self, t: torch.Tensor, group, size: int) -> torch.Tensor:
        nbytes = t.nbytes
        self._record("all_gather", size * nbytes, size, t.shape, nbytes if size > 1 else 0)
        return torch.empty((size, *t.shape), dtype=t.dtype, device="meta")

    def ordered_sum(self, t: torch.Tensor, group, size: int) -> torch.Tensor:
        nbytes = size * -(-t.numel() // size) * t.element_size()
        self._record("ordered_sum", nbytes, size, t.shape, nbytes if size > 1 else 0)
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def all_reduce(self, value: int, op, group=None) -> int:
        self._record("all_reduce", 8, self._size(group), (1,), 8)
        return 0

    def all_reduce_max(self, t: torch.Tensor, group) -> torch.Tensor:
        self._record("all_reduce_max", t.nbytes, self._size(group), t.shape, t.nbytes)
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def scatter(self, chunks, out: torch.Tensor, group, *, src: int = 0) -> torch.Tensor:
        size = self._size(group)
        sent = (sum(c.nbytes for c in chunks) - out.nbytes) if self.rank == src else 0
        self._record("scatter", size * out.nbytes, size, out.shape, sent)
        return out

    def gather(self, t: torch.Tensor, group, *, dst: int = 0) -> Optional[torch.Tensor]:
        size = self._size(group)
        mine = self.rank == dst
        self._record("gather", size * t.nbytes, size, t.shape, 0 if mine else t.nbytes)
        return torch.empty((size, *t.shape), dtype=t.dtype, device="meta") if mine else None


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
    key: tuple = ()              # (shape, axes, device kind): make_mesh's cache key

    @staticmethod
    def by_key(key: tuple) -> "ProcessMesh":
        """The mesh this process made under ``key`` (an operation's payload
        names a mesh by it); raises ``KeyError`` where it holds none."""
        mesh = _MESHES.get(key)
        if mesh is None:
            raise KeyError(f"rank {dist.get_rank()} holds no mesh {key}")
        return mesh

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

    def axis_size(self, name: str) -> int:
        """The size of axis ``name`` (the reference's ``mesh.shape[name]``)."""
        if name not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {name!r}")
        return self.shape[self.axis_names.index(name)]

    def describe(self) -> str:
        """``world=… grid=…x… transport=… devices=…``."""
        return (f"world={self.world_size} grid={'x'.join(map(str, self.shape))} "
                f"({', '.join(self.axis_names)}) transport={self.transport} "
                f"devices={','.join(self.devices)}")


_MESHES: dict = {}


def _mesh_key(shape: Sequence[int], axes: Sequence[str], device) -> tuple:
    shape, axes = tuple(int(d) for d in shape), tuple(axes)
    if len(shape) != len(axes) or len(shape) < 2:
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up, "
                         "a vertex axis first")
    return (shape, axes, resolve_device(device).type)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device=None) -> ProcessMesh:
    """The ``shape`` grid over the first ``prod(shape)`` ranks of the
    initialized process group, on every rank of it (``new_group`` is
    collective). ``shape`` is ``(mu_v, mu_s)`` or ``(mu_v, *sim axes)``; the
    sim axes flatten row-major. Made once per process for each (shape,
    axes, device) and reused. Raises when no group is initialized, when the
    world is smaller than the grid, when this rank lies outside the grid,
    or when the group's backend cannot serve this placement, and on the
    controller of a serving world outside an operation (its followers wait
    for records, not for ``new_group``: use ``Controller.make_mesh``)."""
    key = _mesh_key(shape, axes, device)
    if _MESHES.get(key) is not None:
        return _MESHES[key]
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group is initialized: run under torchrun or "
                           "call launch.mesh.init_world first")
    if _CONTROLLER is not None and not _CONTROLLER.in_op():
        raise RuntimeError("this process controls a serving world: make the mesh on "
                           "every rank with Controller.make_mesh")
    return _make_mesh(key)


def _make_mesh(key: tuple, *, outside_ok: bool = False) -> Optional[ProcessMesh]:
    """``make_mesh``'s collective body. With ``outside_ok`` a rank past the
    grid takes part in making its groups and gets None (a serving world's
    follower outside a smaller grid)."""
    if key in _MESHES:
        return _MESHES[key]
    shape, axes, dev_kind = key
    world, rank = dist.get_world_size(), dist.get_rank()
    size = math.prod(shape)
    if world < size:
        raise ValueError(f"mesh {shape} needs {size} ranks, the world has {world}")
    if rank >= size and not outside_ok:
        raise ValueError(f"rank {rank} lies outside the {shape} grid of the first "
                         f"{size} ranks; run one rank per shard")
    mu_v, mu_s = shape[0], math.prod(shape[1:])
    local_rank, _ = _local_placement()
    dev = _rank_device(dev_kind, local_rank)
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
    if rank >= size:
        _MESHES[key] = None
        return None
    devices = [None] * size
    dist.all_gather_object(devices, str(dev), group=grid_group)
    v, s = divmod(rank, mu_s)
    mesh = ProcessMesh(shape=shape, axis_names=axes, rank=rank, coord=(v, s),
                       device=dev, exchange=Exchange(transport, dev),
                       vertex_group=vertex_groups[s], sim_group=sim_groups[v],
                       grid_group=grid_group, world_size=world, devices=tuple(devices),
                       key=key)
    _MESHES[key] = mesh
    return mesh


def make_serving_mesh(mu_v: int, *, vertex_axis: str = "data", sim_axis: str = "model",
                      device=None) -> ProcessMesh:
    """The ``(mu_v, 1)`` mesh of device-resident serving: ``mu_v`` plan-order
    row blocks, one a rank, the sample space whole on each (a store splits
    it into banks, not mesh columns). SPMD, as ``make_mesh``; a serving
    world's controller uses ``Controller.serving_mesh``."""
    return make_mesh((mu_v, 1), (vertex_axis, sim_axis), device=device)


def make_im_mesh(devices: int, *, mu_v: int = 0, device=None) -> ProcessMesh:
    """``(data, model)`` mesh of the IM drivers: ``mu_v`` vertex shards x
    ``devices / mu_v`` sim shards; ``mu_v=0`` takes the reference's default
    (2 when ``devices`` is even, else 1)."""
    if mu_v <= 0:
        mu_v = 2 if devices % 2 == 0 else 1
    if devices % mu_v != 0:
        raise ValueError(f"--devices {devices} not divisible by mu_v={mu_v}")
    return make_mesh((mu_v, devices // mu_v), ("data", "model"), device=device)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device grid described by its shape alone, as the dry run lowers for
    it: no process group (one process cannot host 256 or 512 ranks). The
    ``vertex_axis`` holds the vertex shards (``mu_v``); the other axes, in
    their order, flatten row-major into the sim shards (``mu_s``, their
    product)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    vertex_axis: str = "data"

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names) or self.vertex_axis not in self.axis_names:
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} must pair "
                             f"up and hold the vertex axis {self.vertex_axis!r}")

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    @property
    def sim_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a != self.vertex_axis)

    @property
    def mu_v(self) -> int:
        return self.axis_size(self.vertex_axis)

    @property
    def mu_s(self) -> int:
        return math.prod(self.axis_size(a) for a in self.sim_axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production grids: ``(16, 16)`` over ``("data",
    "model")`` (256 devices) or ``(2, 16, 16)`` over ``("pod", "data",
    "model")`` (512 devices, 2 pods)."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def dry_mesh(grid: MeshShape, coord: Tuple[int, int] = (0, 0)) -> ProcessMesh:
    """Rank ``coord``'s (``(v, s)``) view of ``grid`` for the dry run: a
    ``ProcessMesh`` on the ``meta`` device whose exchange is a
    ``DryExchange`` and whose groups are ``DryGroup`` sizes. Its axes put
    the vertex axis first and the sim axes after it in the grid's order
    (``(2, 16, 16)`` over ``("pod", "data", "model")`` becomes ``(16, 2,
    16)`` over ``("data", "pod", "model")``): the order ``make_mesh`` and
    the mesh program take, with the same sim shards."""
    axes = (grid.vertex_axis, *grid.sim_axes)
    shape = tuple(grid.axis_size(a) for a in axes)
    v, s = coord
    rank = v * grid.mu_s + s
    return ProcessMesh(shape=shape, axis_names=axes, rank=rank, coord=(v, s),
                       device=torch.device("meta"),
                       exchange=DryExchange(grid.size, rank),
                       vertex_group=DryGroup(grid.mu_v), sim_group=DryGroup(grid.mu_s),
                       grid_group=DryGroup(grid.size), world_size=grid.size,
                       devices=("meta",) * grid.size)


def shutdown_world() -> None:
    """Leave the process group and forget the meshes made on it."""
    _MESHES.clear()
    _SERVING_GROUPS.clear()
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


# -- the serving world: one controller, followers ---------------------------------------

_SERVING_GROUPS: dict = {}     # "control" (long timeout), "done": gloo groups of the world
_CONTROLLER: Optional["Controller"] = None


def graph_fingerprint(g) -> str:
    """A content fingerprint of a graph (its sizes and edge arrays), kept on
    the object: how a follower finds the graph an operation names."""
    fp = getattr(g, "_serving_fp", None)
    if fp is None:
        h = hashlib.blake2b(digest_size=16)
        h.update(np.asarray([g.n, g.n_pad, g.m_real], dtype=np.int64).tobytes())
        for a in (g.src, g.dst, g.weight):
            a = np.ascontiguousarray(a)
            h.update(str(a.dtype).encode())
            h.update(a.data)
        fp = h.hexdigest()
        object.__setattr__(g, "_serving_fp", fp)
    return fp


class ServingState:
    """One rank's serving state: graphs by fingerprint (the start graphs
    and their destination-sorted forms are pinned; the controller holds its
    graphs weakly, its callers own them), placed blocks by handle, plans by
    id, and a small cache of rank partitions (``cached``)."""

    def __init__(self, graphs=(), *, controller: bool = False):
        self.graphs = weakref.WeakValueDictionary() if controller else {}
        self.pinned: set = set()
        self._unsorted = list(graphs)
        for g in graphs:
            fp = graph_fingerprint(g)
            self.graphs[fp] = g
            self.pinned.add(fp)
        self.blocks: dict = {}
        self.plans: dict = {}
        self.parts: collections.OrderedDict = collections.OrderedDict()

    def graph(self, fp: str):
        g = self.graphs.get(fp)
        while g is None and self._unsorted:   # the sorted form of a start graph
            s = self._unsorted.pop().sorted_by_dst()
            sfp = graph_fingerprint(s)
            self.graphs[sfp] = s
            self.pinned.add(sfp)
            g = self.graphs.get(fp)
        if g is None:
            raise KeyError(f"rank {dist.get_rank()} holds no graph {fp}")
        return g

    def has_graph(self, fp: str) -> bool:
        try:
            self.graph(fp)
        except KeyError:
            return False
        return True

    def cached(self, key, make, size: int = 2):
        """``make()``'s value for ``key``, kept for the ``size`` latest keys."""
        if key in self.parts:
            self.parts.move_to_end(key)
            return self.parts[key]
        out = self.parts[key] = make()
        while len(self.parts) > size:
            self.parts.popitem(last=False)
        return out

    def drop(self, kind: str, key) -> None:
        if kind == "block":
            self.blocks.pop(key, None)
        elif kind == "plan":
            self.plans.pop(key, None)
        elif kind == "graph" and key not in self.pinned:
            self.graphs.pop(key, None)
            for k in [k for k in self.parts if key in k]:
                del self.parts[k]


def _done() -> None:
    """Every rank reports its operation done (a finite timeout)."""
    dist.all_reduce(torch.zeros(1, dtype=torch.int64), group=_SERVING_GROUPS["done"])


def _run_op(state: ServingState, op: Callable, payload, local):
    """Run ``op(state, payload, local)`` on this rank (``local``: the
    controller's own argument, None on the followers), then report done. A
    payload dict with a ``"mesh"`` key runs only on that mesh's ranks."""
    out = None
    key = payload.get("mesh") if isinstance(payload, dict) else None
    if key is None or _MESHES.get(key) is not None:
        out = op(state, payload, local)
    _done()
    return out


_CONTROLLERS = itertools.count(1)


class Controller:
    """Rank 0 of a serving world (module doc). ``call(op, payload, local)``
    runs the operation body ``op`` (a module-level function) on every rank
    under the lock and returns the controller's result."""

    def __init__(self, state: ServingState):
        self.state = state
        self.serial = next(_CONTROLLERS)
        self.lock = threading.RLock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        # (kind, key) of what the controller let go of: appended by weak
        # reference callbacks (any thread), read under the lock by ``call``
        self._released: collections.deque = collections.deque()
        self._known: set = set()        # graph fingerprints every rank holds
        self._graph_refs: dict = {}     # fingerprint -> live shared graph objects
        self.stopped = False
        self.failed: Optional[str] = None

    def in_op(self) -> bool:
        return getattr(self._local, "depth", 0) > 0

    def call(self, op: Callable, payload=None, local=None):
        name = f"{op.__module__}.{op.__qualname__}"
        with self.lock:
            if self.stopped:
                raise RuntimeError(f"the serving mesh has stopped: {name} cannot run "
                                   "(a device-resident entry lives only as long as "
                                   "its serving world)")
            if self.failed is not None:
                raise RuntimeError(f"the serving mesh failed in {self.failed}; "
                                   f"{name} cannot run")
            drops = self._take_drops()
            self._local.depth = getattr(self._local, "depth", 0) + 1
            try:
                dist.broadcast_object_list([(op, payload, drops)], src=0,
                                           group=_SERVING_GROUPS["control"])
                for kind, key in drops:
                    self.state.drop(kind, key)
                return _run_op(self.state, op, payload, local)
            except BaseException as e:
                self.failed = f"{name} ({type(e).__name__}: {e})"
                raise
            finally:
                self._local.depth -= 1

    def _take_drops(self) -> list:
        """What every rank drops with the next operation: released blocks and
        plans, and graphs no live object of the controller shares any more."""
        out = []
        while self._released:
            kind, key = self._released.popleft()
            if kind == "graph":
                self._graph_refs[key] -= 1
                if self._graph_refs[key]:
                    continue
                del self._graph_refs[key]
                self._known.discard(key)
            out.append((kind, key))
        return out

    def new_id(self) -> int:
        return next(self._ids)

    def release(self, kind: str, key) -> None:
        """Drop ``key`` on every rank with the next operation (a weak
        reference's callback: any thread, any time)."""
        self._released.append((kind, key))

    def _track_graph(self, g, fp: str) -> None:
        if getattr(g, "_serving_tracked", None) == self.serial:
            return
        object.__setattr__(g, "_serving_tracked", self.serial)
        self._graph_refs[fp] = self._graph_refs.get(fp, 0) + 1
        weakref.finalize(g, self.release, "graph", fp)

    def share_graph(self, g) -> str:
        """``g``'s fingerprint, once every rank holds ``g`` (shipping it to
        the followers that lack it)."""
        fp = graph_fingerprint(g)
        with self.lock:
            self._track_graph(g, fp)
            self.state.graphs[fp] = g      # held weakly: this object is the live one
            if fp not in self._known:
                self.call(_op_graph_ensure, fp, local=g)
                self._known.add(fp)
        return fp

    def apply_delta(self, base, delta):
        """``base.apply_delta(delta).sorted_by_dst()``, the store's new graph,
        made by every rank at once from its own copy of ``base`` (the delta
        travels, the graph does not); the ranks check that their results'
        fingerprints agree. Returns the controller's."""
        with self.lock:
            new = self.call(_op_graph_delta, (self.share_graph(base), delta))
            self._track_graph(new, graph_fingerprint(new))
            self._known.add(graph_fingerprint(new))
        return new

    def share_plan(self, plan) -> int:
        """The id every rank knows ``plan`` by (sent once)."""
        with self.lock:
            tag = getattr(plan, "_serving_pid", None)
            if tag is not None and tag[0] == self.serial:
                return tag[1]
            pid = self.new_id()
            self.call(_op_plan, (pid, plan))
            object.__setattr__(plan, "_serving_pid", (self.serial, pid))
            weakref.finalize(plan, self.release, "plan", pid)
        return pid

    def make_mesh(self, shape: Sequence[int], axes: Sequence[str], *,
                  device=None) -> ProcessMesh:
        """``make_mesh(shape, axes)`` on every rank of the world (ranks past
        the grid take part in making its groups); the controller's view."""
        key = _mesh_key(shape, axes, device)
        if _MESHES.get(key) is not None:
            return _MESHES[key]
        return self.call(_op_make_mesh, key)

    def serving_mesh(self, mu_v: int, *, vertex_axis: str = "data",
                     sim_axis: str = "model", device=None) -> ProcessMesh:
        """``make_serving_mesh`` on every rank of the world."""
        return self.make_mesh((mu_v, 1), (vertex_axis, sim_axis), device=device)

    def stop(self) -> None:
        """End the followers' loops (not after a failed operation: its
        collectives are broken, and the followers fail on their own)."""
        with self.lock:
            if not self.stopped and self.failed is None:
                self.call(_op_stop)
            self.stopped = True


def current_controller() -> Optional[Controller]:
    """The controller of the serving world this process runs (rank 0 of
    ``serve_world``), else None."""
    return _CONTROLLER


def require_controller() -> Controller:
    """``current_controller()``, or a raise naming why there is none."""
    if _CONTROLLER is None:
        raise RuntimeError("device residency runs on a serving world: rank 0 of "
                           "launch.mesh.serve_world (or serve under torchrun) controls "
                           "the mesh, the other ranks follow")
    return _CONTROLLER


def controller_of(mesh: ProcessMesh) -> Controller:
    """The controller that serves ``mesh``, or a raise naming why none does."""
    ctl = require_controller()
    if _MESHES.get(mesh.key) is not mesh or mesh.rank != 0:
        raise ValueError(f"mesh {mesh.describe()} is not one this controller made")
    return ctl


def _serving_groups() -> None:
    """The control group (its timeout lets a server idle) and the done
    group, both gloo over the whole world; collective, once a world."""
    if not _SERVING_GROUPS:
        _SERVING_GROUPS["control"] = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=FOLLOW_TIMEOUT_S))
        _SERVING_GROUPS["done"] = dist.new_group(backend="gloo")


def follow(graphs=()) -> int:
    """A follower's loop: run each operation the controller sends, on this
    rank's blocks, until it sends ``stop``. ``graphs`` are the graphs this
    rank was started with (the controller's, made the same way). Returns
    the number of operations run. A body that raises ends the loop with
    the raise, which fails the controller's next collective."""
    _serving_groups()
    state = ServingState(graphs)
    n = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=_SERVING_GROUPS["control"])
        op, payload, drops = box[0]
        for kind, key in drops:
            state.drop(kind, key)
        if op is _op_stop:
            _done()
            return n
        _run_op(state, op, payload, None)
        n += 1


def serve_world(fn: Callable, *, graphs=()):
    """Run a serving world on every rank of the initialized process group:
    rank 0 becomes the controller and returns ``fn()``; every other rank
    follows (``follow(graphs)``) until rank 0 is done and returns None.
    The followers stop when ``fn`` returns or raises (unless an operation
    failed, whose collectives are broken)."""
    global _CONTROLLER
    if not dist.is_initialized():
        raise RuntimeError("a serving world needs an initialized process group "
                           "(torchrun, or launch.mesh.init_world)")
    if dist.get_rank() != 0:
        follow(graphs)
        return None
    if _CONTROLLER is not None:
        raise RuntimeError("this process already controls a serving world")
    _serving_groups()
    ctl = _CONTROLLER = Controller(ServingState(graphs, controller=True))
    try:
        return fn()
    finally:
        try:
            ctl.stop()
        finally:
            _CONTROLLER = None


def _op_stop(state, payload, local):
    return None


def _op_make_mesh(state, key, local):
    return _make_mesh(key, outside_ok=True)


def _op_plan(state, payload, local):
    pid, plan = payload
    state.plans[pid] = plan


def _op_graph_ensure(state, fp, local):
    if local is not None:
        state.graphs[fp] = local
    lacking = torch.tensor([0 if state.has_graph(fp) else 1], dtype=torch.int64)
    dist.all_reduce(lacking, group=_SERVING_GROUPS["done"])
    if lacking.item():
        box = [local]
        dist.broadcast_object_list(box, src=0, group=_SERVING_GROUPS["done"])
        if not state.has_graph(fp):
            if graph_fingerprint(box[0]) != fp:
                raise ValueError(f"the graph shipped as {fp} does not match it")
            state.graphs[fp] = box[0]


def _op_graph_delta(state, payload, local):
    base_fp, delta = payload
    new = state.graph(base_fp).apply_delta(delta).sorted_by_dst()
    fp = graph_fingerprint(new)
    fps = [None] * dist.get_world_size()
    dist.all_gather_object(fps, fp, group=_SERVING_GROUPS["done"])
    if len(set(fps)) != 1:
        raise ValueError(f"the ranks' graphs after the delta differ: {fps}")
    state.graphs[fp] = new
    return new


# -- placed row blocks --------------------------------------------------------------------

class Placement:
    """The controller's handle of a plan-order matrix placed on a serving
    mesh: block v (rows ``[v * n_loc, (v + 1) * n_loc)``, all ``cols``
    columns) lives on the mesh's rank v, ``local`` is the controller's own.
    ``shape``/``numel``/``device`` describe the whole matrix, as the
    reference's sharded array does; ``gather`` brings it to the controller."""

    def __init__(self, ctl: Controller, mesh: ProcessMesh, hid: int, n_loc: int,
                 local: torch.Tensor):
        self.ctl, self.mesh, self.hid, self.n_loc = ctl, mesh, hid, n_loc
        self.local = local
        self.shape = (mesh.mu_v * n_loc, int(local.shape[1]))
        self.dtype = local.dtype
        self.device = local.device
        weakref.finalize(self, ctl.release, "block", hid)

    def numel(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def nbytes(self) -> int:
        return self.numel() * self.local.element_size()

    def gather(self) -> torch.Tensor:
        """The whole plan-order matrix on the controller's device."""
        return self.ctl.call(_op_gather, {"mesh": self.mesh.key, "hid": self.hid})

    def changed_columns(self, other: "Placement", splits: int) -> list:
        """For each of ``splits`` equal column blocks (banks), whether it
        differs between the two placements."""
        return self.ctl.call(_op_changed, {"mesh": self.mesh.key, "a": self.hid,
                                              "b": other.hid, "splits": int(splits)})


def place_rows(mesh: ProcessMesh, pm: torch.Tensor, n_loc: int) -> Placement:
    """Scatter the controller's plan-order matrix ``pm`` (``mu_v * n_loc``
    rows) as row blocks over ``mesh``'s vertex axis."""
    ctl = controller_of(mesh)
    if pm.shape[0] != mesh.mu_v * n_loc or mesh.mu_s != 1:
        raise ValueError(f"a {tuple(pm.shape)} matrix does not split into {mesh.mu_v} "
                         f"row blocks of {n_loc} on a {mesh.shape} mesh")
    hid = ctl.new_id()
    blk = ctl.call(_op_place, {"mesh": mesh.key, "hid": hid, "n_loc": int(n_loc),
                                  "cols": int(pm.shape[1])}, local=pm.contiguous())
    return Placement(ctl, mesh, hid, n_loc, blk)


def adopt_block(mesh: ProcessMesh, hid: int, n_loc: int) -> Placement:
    """The handle of a block that an operation stored under ``hid`` on every
    rank of ``mesh`` (the shard repair's output)."""
    ctl = controller_of(mesh)
    return Placement(ctl, mesh, hid, n_loc, ctl.state.blocks[hid])


def _op_place(state, p, local):
    mesh = ProcessMesh.by_key(p["mesh"])
    out = torch.empty((p["n_loc"], p["cols"]), dtype=torch.int8, device=mesh.device)
    chunks = list(local.split(p["n_loc"])) if local is not None else None
    state.blocks[p["hid"]] = mesh.exchange.scatter(chunks, out, mesh.vertex_group, src=0)
    return state.blocks[p["hid"]]


def _op_gather(state, p, local):
    mesh = ProcessMesh.by_key(p["mesh"])
    blk = state.blocks[p["hid"]]
    out = mesh.exchange.gather(blk, mesh.vertex_group, dst=0)
    return None if out is None else out.reshape(-1, blk.shape[1])


def _op_changed(state, p, local):
    mesh = ProcessMesh.by_key(p["mesh"])
    a, b = state.blocks[p["a"]], state.blocks[p["b"]]
    flags = torch.stack([(x != y).any() for x, y in
                         zip(a.chunk(p["splits"], dim=1), b.chunk(p["splits"], dim=1))])
    flags = mesh.exchange.all_reduce_max(flags.to(torch.int8), mesh.vertex_group)
    return [bool(f) for f in flags.tolist()]
