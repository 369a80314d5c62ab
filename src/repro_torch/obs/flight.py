"""Flight recorder: always-on bounded ring of recent spans, dumped on fault.

"p99 regressed" is only actionable if the window around the regression is
still inspectable after the fact. The flight recorder keeps a bounded ring
of the most recent *completed* spans — fed by the span-listener tap in
:mod:`repro_torch.obs.trace`, so it captures every real span whether or not the
main recorder is on (with tracing disabled that's the always-``timed=True``
population: engine query batches, store builds, async mutations; with
tracing enabled, everything). On an engine exception or an SLO breach it dumps the ring as a
Chrome-trace JSON (Perfetto-loadable), stamped with the dump reason and the
counter deltas since the previous dump.

Cost model: one dict append into a ``deque(maxlen=N)`` per real span. The
tracing-disabled fast path is untouched — null spans never reach listeners.

The module-level recorder installs itself at import (``repro_torch.obs``
imports this module), so the ring is warm in every process that touches
the obs package. ``configure(out_dir=...)`` or the ``REPRO_TORCH_FLIGHT_DIR``
environment variable picks the dump directory (default: a gitignored
``flight/`` under the working directory).

The port's copy of the reference's ``obs/flight.py``; only the variable's
name differs (the reference reads ``REPRO_FLIGHT_DIR``)."""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

from repro_torch.obs import metrics, trace

#: Ring capacity: ~2k spans is minutes of engine traffic and a handful of
#: full builds — enough context either side of a fault, small enough that
#: the ring never matters for memory.
DEFAULT_CAPACITY = 2048
#: environment variable naming the dump directory (``configure`` wins)
ENV_DIR = "REPRO_TORCH_FLIGHT_DIR"


class FlightRecorder:
    """Bounded ring of completed spans with fault-triggered Chrome dumps."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *,
                 out_dir: Optional[str] = None, max_dumps: int = 8):
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._counter_basis: dict = {}
        self.out_dir = out_dir
        self.max_dumps = max_dumps      # rate limit: a breach storm must not
        self.dump_count = 0             # fill the disk with identical dumps
        self.dumps: List[str] = []
        self.enabled = True

    # -- capture -----------------------------------------------------------

    def on_span(self, sp) -> None:
        """Span-listener entry point (every real span's ``__exit__``)."""
        if not self.enabled:
            return
        ev = {"name": sp.name, "phase": sp.phase or "other",
              "ts_s": sp.t0 - self._epoch, "dur_s": sp.t1 - sp.t0,
              "depth": sp.depth, "attrs": dict(sp.attrs)}
        with self._lock:
            self._ring.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    # -- dump --------------------------------------------------------------

    def _counter_deltas(self) -> dict:
        """Counter movement since the previous dump — the 'what happened in
        this window' ledger embedded in the dump metadata."""
        now = {}
        for rec in metrics.registry().snapshot():
            if rec["kind"] != "counter":
                continue
            key = rec["name"] + "".join(
                f"|{k}={v}" for k, v in sorted(rec["tags"].items()))
            now[key] = rec["value"]
        deltas = {k: v - self._counter_basis.get(k, 0)
                  for k, v in now.items()
                  if v != self._counter_basis.get(k, 0)}
        self._counter_basis = now
        return deltas

    def chrome_trace(self, reason: str = "") -> dict:
        """Chrome trace-event JSON of the ring (same lane-per-phase layout
        as the main recorder) plus a metadata event carrying the dump
        reason and counter deltas."""
        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": f"repro_torch-flight ({reason})" if reason
                      else "repro_torch-flight"}},
        ]
        ring = self.events()
        used = sorted({ev["phase"] for ev in ring},
                      key=lambda p: trace._PHASE_TID.get(p, 99))
        for p in used:
            tid = trace._PHASE_TID.get(p, len(trace.PHASES))
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tid, "args": {"name": p}})
            events.append({"ph": "M", "name": "thread_sort_index", "pid": 0,
                           "tid": tid, "args": {"sort_index": tid}})
        for ev in ring:
            args = {k: trace._jsonable(v) for k, v in ev["attrs"].items()}
            args["depth"] = ev["depth"]
            events.append({
                "ph": "X", "name": ev["name"], "pid": 0,
                "tid": trace._PHASE_TID.get(ev["phase"], len(trace.PHASES)),
                "ts": round(ev["ts_s"] * 1e6, 3),
                "dur": round(ev["dur_s"] * 1e6, 3),
                "cat": ev["phase"], "args": args})
        meta = {"reason": reason, "spans": len(ring),
                "wall_s": time.perf_counter() - self._epoch,
                "counter_deltas": self._counter_deltas()}
        # an instant event makes the dump reason visible on the Perfetto
        # timeline itself, not only in the JSON
        events.append({"ph": "i", "name": f"flight-dump: {reason}", "pid": 0,
                       "tid": 0, "ts": round(meta["wall_s"] * 1e6, 3),
                       "s": "g", "args": meta})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": meta}

    def dump(self, path: Optional[str] = None, *,
             reason: str = "manual") -> Optional[str]:
        """Write the ring as Chrome-trace JSON; returns the path written, or
        None when rate-limited / disabled. Never raises — the recorder runs
        inside exception handlers on the serving path."""
        if not self.enabled or self.dump_count >= self.max_dumps:
            return None
        try:
            if path is None:
                # default: a gitignored flight/ subdirectory — dumps are
                # debugging artifacts and must never land in the worktree
                # root (where they read as committable files)
                base = (self.out_dir or os.environ.get(ENV_DIR)
                        or os.path.join(os.getcwd(), "flight"))
                os.makedirs(base, exist_ok=True)
                slug = "".join(c if c.isalnum() or c in "-_" else "-"
                               for c in reason)[:48] or "dump"
                path = os.path.join(
                    base, f"flight_{self.dump_count:02d}_{slug}.json")
            with open(path, "w") as f:
                json.dump(self.chrome_trace(reason), f)
            self.dump_count += 1
            self.dumps.append(path)
            metrics.counter("flight.dumps").inc()
            return path
        except Exception:  # noqa: BLE001 — must not mask the original fault
            return None


_FLIGHT = FlightRecorder()
trace.add_span_listener(_FLIGHT.on_span)


def get_flight_recorder() -> FlightRecorder:
    """The process-global always-on flight recorder."""
    return _FLIGHT


def configure(*, out_dir: Optional[str] = None,
              capacity: Optional[int] = None,
              max_dumps: Optional[int] = None,
              enabled: Optional[bool] = None) -> FlightRecorder:
    """Adjust the global recorder in place (tests and launchers)."""
    if out_dir is not None:
        _FLIGHT.out_dir = out_dir
    if capacity is not None:
        with _FLIGHT._lock:
            _FLIGHT._ring = deque(_FLIGHT._ring, maxlen=capacity)
    if max_dumps is not None:
        _FLIGHT.max_dumps = max_dumps
    if enabled is not None:
        _FLIGHT.enabled = enabled
    return _FLIGHT


def dump(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Module-level convenience: dump the global ring."""
    return _FLIGHT.dump(path, reason=reason)
