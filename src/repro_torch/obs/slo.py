"""SLO watchdog: per-query-class latency budgets with rolling-window p99.

Serving needs more than latency histograms: it needs the process to *know*, while running, that a query
class is out of budget, count it, and trigger capture. This module is that
loop: the engine feeds every batch latency into :class:`SLOWatchdog`;
the watchdog keeps a small rolling window per class, evaluates the
nearest-rank p99 against the class budget once the window has enough
samples, publishes ``slo.window_p99_ms`` gauges and ``slo.breaches``
counters, and fires a breach callback on the *rising edge* (ok -> breached)
— by default the flight recorder's dump, so a breach leaves behind an
openable Perfetto file of the offending window.

Budgets come from engine config or ``RunSpec.slo`` (a tuple of
``(query_class, p99_ms)`` pairs — tuple-of-tuples so the spec stays
hashable/frozen). Classes with no budget are observed but never breach.

The port's copy of the reference's ``obs/slo.py``; standard library only,
like the rest of ``repro_torch.obs``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.obs import metrics

#: Budgets accepted anywhere: mapping, RunSpec-style tuple pairs, or config.
BudgetsLike = Union[Mapping[str, float], Sequence[Tuple[str, float]],
                    "SLOConfig", None]


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Latency objectives for the engine.

    ``budgets`` maps query class -> p99 budget in **milliseconds** (ms is
    the unit operators quote; the engine's histograms stay in seconds).
    ``window`` bounds the rolling sample window per class; ``min_samples``
    gates evaluation so a cold class can't breach off two slow warmup
    batches.
    """

    budgets: Tuple[Tuple[str, float], ...] = ()
    window: int = 256
    min_samples: int = 20

    @classmethod
    def coerce(cls, obj: BudgetsLike) -> Optional["SLOConfig"]:
        """Normalize any budget spelling to an ``SLOConfig`` (None -> None,
        empty budgets -> None: no objectives, no watchdog)."""
        if obj is None or isinstance(obj, SLOConfig):
            return obj if (obj is None or obj.budgets) else None
        if isinstance(obj, Mapping):
            pairs = tuple(sorted((str(k), float(v)) for k, v in obj.items()))
        else:
            pairs = tuple(sorted((str(k), float(v)) for k, v in obj))
        return cls(budgets=pairs) if pairs else None

    def budget_ms(self, qclass: str) -> Optional[float]:
        for name, ms in self.budgets:
            if name == qclass:
                return ms
        return None


class SLOWatchdog:
    """Rolling-window p99 evaluation against per-class budgets.

    ``observe(qclass, latency_s)`` is the engine's single entry point; it is
    O(window) only at evaluation (a sort of <= ``window`` floats), which is
    noise next to the device work each sample represents.

    ``on_breach(qclass, p99_ms, budget_ms, watchdog)`` fires on the rising
    edge per class — once per excursion, not per sample — and again only
    after the class recovers (p99 back under budget). Callback exceptions
    are swallowed: an observer must never take down the serving path.
    """

    def __init__(self, config: BudgetsLike,
                 on_breach: Optional[Callable] = None):
        cfg = SLOConfig.coerce(config)
        self.config = cfg if cfg is not None else SLOConfig()
        self.on_breach = on_breach
        self._windows: Dict[str, deque] = {}
        self._breached: Dict[str, bool] = {}
        self.breach_count = 0

    def observe(self, qclass: str, latency_s: float) -> bool:
        """Record one batch latency; returns True when this sample put the
        class into breach (the rising edge)."""
        budget_ms = self.config.budget_ms(qclass)
        win = self._windows.get(qclass)
        if win is None:
            win = self._windows[qclass] = deque(maxlen=self.config.window)
        win.append(float(latency_s))
        if len(win) < self.config.min_samples:
            return False
        p99_ms = self.window_p99_ms(qclass)
        metrics.gauge("slo.window_p99_ms", qclass=qclass).set(p99_ms)
        if budget_ms is None:
            return False
        breached = p99_ms > budget_ms
        rising = breached and not self._breached.get(qclass, False)
        self._breached[qclass] = breached
        if rising:
            self.breach_count += 1
            metrics.counter("slo.breaches", qclass=qclass).inc()
            metrics.gauge("slo.breach_excess_ms", qclass=qclass).set(
                p99_ms - budget_ms)
            if self.on_breach is not None:
                try:
                    self.on_breach(qclass, p99_ms, budget_ms, self)
                except Exception:  # noqa: BLE001 — observers must not break
                    pass           # the serving path
        return rising

    def window_p99_ms(self, qclass: str) -> float:
        """Nearest-rank p99 (in ms) over the class's current window."""
        win = self._windows.get(qclass)
        if not win:
            return 0.0
        ordered = sorted(win)
        rank = max(int(0.99 * len(ordered) + 0.999999) - 1, 0)
        return ordered[min(rank, len(ordered) - 1)] * 1e3

    def in_breach(self, qclass: str) -> bool:
        return self._breached.get(qclass, False)

    def summary(self) -> dict:
        """Per-class state for the perf report / engine stats."""
        out = {}
        for qclass, win in self._windows.items():
            budget = self.config.budget_ms(qclass)
            out[qclass] = {
                "samples": len(win),
                "window_p99_ms": self.window_p99_ms(qclass),
                "budget_ms": budget,
                "in_breach": self._breached.get(qclass, False),
            }
        out["_breach_count"] = self.breach_count
        return out
