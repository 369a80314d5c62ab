"""A cell on several cards: a world of one rank a card, kept in step.

``imbench/run.py`` runs a cell whose ``chips`` is more than 1 as a world.
The process that the benchmark's command line starts, the launcher, starts
one rank a card, each ``python3 imbench/run.py`` with the same arguments,
and waits for all of them (``launch``). It imports neither torch nor the
program. Rank 0 alone prints to standard output; the launcher passes on its
standard error and then its result line. It exits 0 only if every rank did.
When a rank fails it stops the others and names, last on its standard
error, each rank that failed, its exit code or signal and the last lines of
its standard error.

A rank (``Rank``) joins the program's process group through
``repro_torch.launch.mesh.init_world`` (NCCL where each rank has a card of
its own, gloo where ranks share one or run on the CPU), from a ``file://``
store in the launcher's temporary folder. Every decision that could split
the ranks is made once and shared through a store of the harness's own
beside it (``World``), which belongs to no process group:

* the graph: every rank makes it from the seed, and the ranks compare a
  fingerprint of its edges and of the run's arguments;
* the window: before each job rank 0's clock decides whether another job
  starts, and every rank gets that answer and the job's index;
* its end: once every rank is out of the last job, every rank leaves the
  process group (``shutdown_world``: the NCCL communicators and their
  watchdog threads end), then stops its profiler and reads its own trace,
  and hands rank 0 its job count, peak and device readings. Only then does
  rank 0 check the sampled job against the reference and print the
  result, while the other ranks exit: no rank waits on a collective
  meanwhile, and no profiler stops beside a live communicator.

Every process of a run reads the host's ``CLOCK_MONOTONIC`` through
``time.perf_counter`` (Linux), so rank 0 times ``setup_s`` from the
launcher's start.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

#: names the world's spec file in each rank's environment
WORLD_ENV = "IMBENCH_WORLD"
#: seconds a rank waits at one of the harness's own collectives
TIMEOUT_S = 300.0
#: seconds a rank stopped by the launcher has to end before it is killed
GRACE_S = 10.0
#: lines of a failed rank's standard error that the launcher repeats
TAIL_LINES = 30
RUN = Path(__file__).resolve().parents[1] / "run.py"


def _cores() -> int:
    return len(os.sched_getaffinity(0))


def _argv(args) -> List[str]:
    return ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
            repr(float(args.seconds)), "--trace", str(args.trace)]


def _how(code: int) -> str:
    if code < 0:
        return f"killed by signal {signal.Signals(-code).name} ({-code})"
    return f"exit code {code}"


def _tail(path: Path) -> List[str]:
    return path.read_text(errors="replace").splitlines()[-TAIL_LINES:]


def _stop(procs, pending) -> None:
    for rank in pending:
        procs[rank].terminate()
    deadline = time.monotonic() + GRACE_S
    for rank in pending:
        try:
            procs[rank].wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            procs[rank].kill()
            procs[rank].wait()


def _wait(procs) -> list:
    """Wait for every rank. Returns ``[(rank, code)]`` of the ranks that
    failed on their own, in the order seen; once one has, the others are
    stopped (and not listed)."""
    pending = list(range(len(procs)))
    failed = []
    while pending:
        for rank in list(pending):
            code = procs[rank].poll()
            if code is not None:
                pending.remove(rank)
                if code != 0:
                    failed.append((rank, code))
        if failed and pending:
            _stop(procs, pending)
            break
        time.sleep(0.02)
    return failed


def _on_term(signum, frame):
    raise SystemExit(128 + signum)


def launch(args, chips: int, *, t_start: float, forbidden, bench=None, data_dir=None,
           device=None) -> int:
    """Run the cell of ``args`` as a world of ``chips`` ranks and return the
    launcher's exit code; ``forbidden()`` lists the modules whose presence
    in this process voids the result (each rank checks its own). ``bench``,
    ``data_dir`` and ``device`` are the tests' stand-ins, handed to every
    rank."""
    threads = max(1, _cores() // chips)
    with tempfile.TemporaryDirectory(prefix="imbench-world-") as tmp:
        tmp = Path(tmp)
        spec = {"t_start": t_start, "folder": str(tmp), "bench": bench,
                "data_dir": None if data_dir is None else str(data_dir), "device": device}
        (tmp / "world.json").write_text(json.dumps(spec))
        procs, files = [], []
        old = signal.signal(signal.SIGTERM, _on_term)
        try:
            for rank in range(chips):
                # TEARDOWN_CUPTI=0: a traced rank's profiler leaves CUPTI attached
                # when it stops, rather than finalize it in a process with CUDA work
                env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(chips),
                           LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(chips),
                           OMP_NUM_THREADS=str(threads), TEARDOWN_CUPTI="0")
                env[WORLD_ENV] = str(tmp / "world.json")
                out = open(tmp / f"rank{rank}.out", "w")
                err = open(tmp / f"rank{rank}.err", "w")
                files += [out, err]
                procs.append(subprocess.Popen([sys.executable, str(RUN), *_argv(args)],
                                              stdout=out, stderr=err, env=env))
            failed = _wait(procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in files:
                f.close()
            signal.signal(signal.SIGTERM, old)
        sys.stderr.write((tmp / "rank0.err").read_text(errors="replace"))
        if failed:
            for rank, code in failed:
                print(f"imbench: rank {rank} of {chips} failed, {_how(code)}; the last "
                      f"lines of its standard error:", file=sys.stderr)
                for line in _tail(tmp / f"rank{rank}.err"):
                    print(f"  rank {rank}| {line}", file=sys.stderr)
            sys.stderr.flush()
            code = failed[0][1]
            return code if code > 0 else 128 - code
        sys.stderr.flush()
        return _relay(tmp / "rank0.out", forbidden)


def _relay(path: Path, forbidden) -> int:
    bad = forbidden()
    if bad:
        print(f"imbench: loaded in the launcher: {bad}", file=sys.stderr)
        return 3
    sys.stdout.write(path.read_text())
    sys.stdout.flush()
    return 0


@dataclasses.dataclass
class Rank:
    """A rank's part of the world, from the spec file the launcher wrote:
    the stand-ins of ``run.main``, and the folder of the world's stores."""

    rank: int
    size: int
    local_rank: int
    t_start: float
    folder: str
    bench: Optional[dict]
    data_dir: Optional[str]
    device: Optional[str]

    @classmethod
    def from_env(cls) -> "Rank":
        spec = json.loads(Path(os.environ[WORLD_ENV]).read_text())
        return cls(rank=int(os.environ["RANK"]), size=int(os.environ["WORLD_SIZE"]),
                   local_rank=int(os.environ["LOCAL_RANK"]), **spec)

    def join(self, device) -> "World":
        """Open the harness's store, join the program's process group on this
        rank's device (``cpu``, or CUDA: card ``LOCAL_RANK`` modulo the
        cards)."""
        import torch
        import torch.distributed as dist
        from repro_torch.launch import mesh

        store = dist.FileStore(f"{self.folder}/harness", self.size)
        store.set_timeout(datetime.timedelta(seconds=TIMEOUT_S))
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(max(1, _cores() // self.size))
        else:
            dev = torch.device("cuda", self.local_rank % torch.cuda.device_count())
        mesh.init_world(device=dev.type, init_method=f"file://{self.folder}/mesh",
                        rank=self.rank, world_size=self.size)
        return World(rank=self.rank, size=self.size, device=dev, store=store)


def _fingerprint(edges, what) -> str:
    n, src, dst, weight = edges
    h = hashlib.sha256(json.dumps(what, sort_keys=True).encode())
    h.update(int(n).to_bytes(8, "little"))
    for a in (src, dst, weight):
        h.update(str(a.dtype).encode())
        h.update(a.data if a.flags.c_contiguous else a.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class World:
    """The harness's view of a world from one rank: the decisions rank 0
    makes for every rank, and what the ranks tell each other, through a
    store of the harness's own (``torch.distributed.FileStore``), which
    no process group owns and so outlives the program's."""

    rank: int
    size: int
    device: object
    store: object
    jobs: int = 0

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def _post(self, name: str, value) -> None:
        self.store.set(f"{name}/{self.rank}", json.dumps(value))

    def _read(self, name: str) -> list:
        keys = [f"{name}/{r}" for r in range(self.size)]
        self.store.wait(keys)
        return [json.loads(self.store.get(k)) for k in keys]

    def agree_graph(self, edges, what: dict) -> None:
        """Fail on every rank unless every rank made the same edges for the
        same arguments ``what``."""
        self._post("graph", _fingerprint(edges, what))
        prints = self._read("graph")
        if len(set(prints)) != 1:
            raise RuntimeError(f"the ranks made different graphs: fingerprints {prints}")

    def barrier(self) -> None:
        """Wait until every rank has set up."""
        self._post("ready", True)
        self._read("ready")

    def next_job(self, wanted: bool, index: int):
        """Rank 0's ``(wanted, index)``: whether another job starts, and its
        index, the same on every rank."""
        key = f"job/{self.jobs}"
        self.jobs += 1
        if self.lead:
            self.store.set(key, json.dumps([wanted, index]))
        wanted, index = json.loads(self.store.get(key))
        return bool(wanted), int(index)

    def leave(self) -> None:
        """Once every rank is out of the window's last job, leave the
        program's process group (its NCCL communicators and their
        watchdogs end here, before any profiler stops)."""
        from repro_torch.launch import mesh

        self._post("left", True)
        self._read("left")
        mesh.shutdown_world()

    def gather(self, reading: dict) -> Optional[list]:
        """Every rank's ``reading``, in rank order, on rank 0 (None on the
        others). Fails on rank 0 if the ranks ran different numbers of
        jobs."""
        self._post("reading", reading)
        if not self.lead:
            return None
        readings = self._read("reading")
        jobs = [r["jobs"] for r in readings]
        if len(set(jobs)) != 1:
            raise RuntimeError(f"the ranks ran different numbers of jobs: {jobs}")
        return readings
