"""Hierarchical, device-sync-aware tracing with Chrome/Perfetto export.

The port's copy of the reference's ``obs/trace.py``; only the device sync
differs. PyTorch returns from a CUDA launch before the device finishes, so
a bare ``perf_counter`` pair around it measures the enqueue. Spans fix that
with a ``sync`` knob: outputs declared on a span (up front with
``span(..., sync=out)`` or later with ``sp.sync(value)``) are synchronized
*inside* the span, at its exit, so device time lands in the span that
incurred it.

The sync (:func:`_block_until_ready`) walks tuples, lists, dicts and
dataclass attributes, and for every CUDA tensor it meets synchronizes that
tensor's device's *current stream* (``torch.cuda.current_stream``), not the
whole device: under the async engine the serving and the mutation thread
each run on a stream of their own, and a span of one must not wait for the
other's kernels. CPU tensors, numpy arrays and other leaves are no-ops. A
CUDA error raised by the sync reaches the caller.

Design constraints:

  * **Standard library only at import**: torch is imported inside the sync,
    the first time a span has outputs to sync.
  * **No-op when disabled**: with the recorder off, ``span(...)`` returns one
    shared ``_NULL_SPAN`` singleton (no allocation, no timestamps, no sync).
    Callers that need wall time regardless (the engine's latency
    accounting) pass ``timed=True`` and always get a real measuring span,
    which skips only the recording step while the recorder is off.
  * **One lane per phase**: every span carries a ``phase`` (one of
    :data:`PHASES`); the Chrome-trace export maps each phase to its own
    ``tid``, so Perfetto draws plan / build / fixpoint / select / ring /
    repair / query work as distinct lanes. A span with no phase inherits
    the enclosing span's (a thread-local stack), else ``"other"``.

Usage::

    from repro_torch.obs import trace
    with trace.span("store.build_bank", phase="build", bank=b) as sp:
        m = sp.sync(backend.build_matrix(...))   # synchronized at span exit

    rec = trace.get_recorder()
    rec.start(); ...workload...; rec.stop()
    rec.save_chrome_trace("trace.json")          # open in ui.perfetto.dev
"""
from __future__ import annotations

import dataclasses
import functools
import json
import threading
import time
from typing import Any, Dict, List, Optional

#: Fixed lane order of the Perfetto view; index == Chrome-trace ``tid``.
PHASES = ("plan", "build", "fixpoint", "select", "ring", "repair", "query",
          "other")
_PHASE_TID = {p: i for i, p in enumerate(PHASES)}


def _cuda_devices(value, out: set, seen: set) -> None:
    """Collect the devices of the CUDA tensors in ``value`` (tuples, lists,
    dicts and dataclass attributes are walked; anything else is a leaf)."""
    if id(value) in seen:
        return
    seen.add(id(value))
    if isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out, seen)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out, seen)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), out, seen)
    elif getattr(value, "is_cuda", False) is True:
        out.add(value.device)


def _block_until_ready(value):
    """Wait for the device work behind ``value``: synchronize the current
    stream of every CUDA device that one of its tensors lives on. A no-op
    for CPU tensors, numpy arrays and plain objects. Raises what the CUDA
    runtime raises."""
    devices: set = set()
    _cuda_devices(value, devices, set())
    if devices:
        import torch

        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
    return value


class _NullSpan:
    """The shared do-nothing span handed out while tracing is disabled.

    Identity is the no-op contract: ``span(...) is span(...)`` whenever the
    recorder is off (tested), so the disabled path allocates nothing.
    """

    __slots__ = ()
    duration_s = 0.0
    name = phase = ""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def sync(self, value):
        return value

    def annotate(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """One live timed region. Use via :func:`span`, not directly."""

    __slots__ = ("name", "phase", "attrs", "t0", "t1", "depth", "_outputs",
                 "_recorder")

    def __init__(self, recorder: Optional["Recorder"], name: str,
                 phase: Optional[str], sync_value, attrs: Dict[str, Any]):
        self.name = name
        self.phase = phase
        self.attrs = attrs
        self._outputs: List[Any] = [] if sync_value is None else [sync_value]
        self._recorder = recorder    # None: timed-only, nothing recorded
        self.t0 = self.t1 = 0.0
        self.depth = 0

    @property
    def duration_s(self) -> float:
        """Wall seconds (valid after ``__exit__``; includes device sync)."""
        return self.t1 - self.t0

    def sync(self, value):
        """Declare ``value`` (tensors, possibly nested in tuples, lists,
        dicts or dataclasses) as an output of this span: its streams are
        synchronized at span exit, so the device work it represents lands
        inside the span. Returns ``value``."""
        self._outputs.append(value)
        return value

    def annotate(self, **attrs) -> "Span":
        """Attach extra key/values to the span's Chrome-trace ``args``."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = _STACK.spans
        if self.phase is None:
            self.phase = stack[-1].phase if stack else "other"
        self.depth = len(stack)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if self._outputs:
                _block_until_ready(self._outputs)   # each stream once
        finally:
            self.t1 = time.perf_counter()
            stack = _STACK.spans
            if stack and stack[-1] is self:
                stack.pop()
            if self._recorder is not None:
                self._recorder._add(self)
            for fn in _SPAN_LISTENERS:
                try:
                    fn(self)
                except Exception:   # noqa: BLE001 — observers must not break
                    pass            # the observed workload
        return False


class _SpanStack(threading.local):
    def __init__(self):
        self.spans: List[Span] = []


_STACK = _SpanStack()

#: Completion listeners: called with every *real* span (recorded or
#: ``timed=True``) right after its ``__exit__`` timestamps settle. This is
#: the flight recorder's tap — it sees measuring spans even while the main
#: recorder is off. Null spans never reach listeners, so the
#: tracing-disabled fast path stays allocation-free.
_SPAN_LISTENERS: List = []


def add_span_listener(fn) -> None:
    """Register ``fn(span)`` to run at every real span completion. Listeners
    must be cheap and must not raise (exceptions are swallowed — a broken
    observer must never break the observed workload)."""
    if fn not in _SPAN_LISTENERS:
        _SPAN_LISTENERS.append(fn)


def remove_span_listener(fn) -> None:
    if fn in _SPAN_LISTENERS:
        _SPAN_LISTENERS.remove(fn)


class Recorder:
    """Process-global span sink. Disabled by default; ``start()`` clears and
    begins collecting, ``stop()`` freezes. Thread-safe appends."""

    def __init__(self):
        self.enabled = False
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Recorder":
        with self._lock:
            self._events.clear()
            self._epoch = time.perf_counter()
            self.enabled = True
        return self

    def stop(self) -> "Recorder":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def _add(self, sp: Span) -> None:
        ev = {"name": sp.name, "phase": sp.phase or "other",
              "ts_s": sp.t0 - self._epoch, "dur_s": sp.t1 - sp.t0,
              "depth": sp.depth, "attrs": sp.attrs}
        with self._lock:
            self._events.append(ev)

    # -- inspection --------------------------------------------------------

    def events(self) -> List[dict]:
        """Recorded span dicts (name/phase/ts_s/dur_s/depth/attrs), in
        completion order (children complete before parents)."""
        with self._lock:
            return list(self._events)

    def phases_seen(self) -> set:
        return {ev["phase"] for ev in self.events()}

    def top_level_seconds(self) -> float:
        """Total seconds inside depth-0 spans — the numerator of the
        "spans account for >= X% of wall time" acceptance check."""
        return sum(ev["dur_s"] for ev in self.events() if ev["depth"] == 0)

    # -- export ------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable): one
        complete ("ph": "X") event per span, one thread lane per phase."""
        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "repro_torch"}},
        ]
        used = sorted(self.phases_seen(), key=lambda p: _PHASE_TID.get(p, 99))
        for p in used:
            tid = _PHASE_TID.get(p, len(PHASES))
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tid, "args": {"name": p}})
            events.append({"ph": "M", "name": "thread_sort_index", "pid": 0,
                           "tid": tid, "args": {"sort_index": tid}})
        for ev in self.events():
            args = {k: _jsonable(v) for k, v in ev["attrs"].items()}
            args["depth"] = ev["depth"]
            events.append({
                "ph": "X", "name": ev["name"], "pid": 0,
                "tid": _PHASE_TID.get(ev["phase"], len(PHASES)),
                "ts": round(ev["ts_s"] * 1e6, 3),
                "dur": round(ev["dur_s"] * 1e6, 3),
                "cat": ev["phase"], "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save_chrome_trace(self, path: str) -> int:
        """Write the Chrome-trace JSON; returns the span count written."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return sum(1 for e in trace["traceEvents"] if e["ph"] == "X")


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return int(v)          # numpy ints
    except (TypeError, ValueError):
        try:
            return float(v)    # numpy floats
        except (TypeError, ValueError):
            return str(v)


_RECORDER = Recorder()


def get_recorder() -> Recorder:
    """The process-global recorder every :func:`span` reports to."""
    return _RECORDER


def tracing_enabled() -> bool:
    return _RECORDER.enabled


def span(name: str, *, phase: Optional[str] = None, sync=None,
         timed: bool = False, **attrs):
    """Open a traced region (context manager).

    ``phase`` picks the Perfetto lane (:data:`PHASES`; ``None`` inherits
    the enclosing span's). ``sync`` declares an output pytree up front;
    ``sp.sync(value)`` declares more at runtime; all are synchronized at
    span exit. ``timed=True`` forces a real
    measuring span (``sp.duration_s`` valid, outputs synced) even while the
    recorder is disabled — for callers whose latency accounting must not
    depend on tracing; everyone else gets the free ``_NULL_SPAN``."""
    if not _RECORDER.enabled:
        if not timed:
            return _NULL_SPAN
        return Span(None, name, phase, sync, attrs)
    return Span(_RECORDER, name, phase, sync, attrs)


def traced(name: Optional[str] = None, *, phase: Optional[str] = None):
    """Decorator form of :func:`span` for whole-function regions::

        @traced("store.build_banks", phase="build")
        def build(...): ...

    Same no-op-when-disabled contract as :func:`span`."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(label, phase=phase):
                return fn(*args, **kwargs)
        return wrapper
    return deco
