"""Cost-aware eviction for multi-graph tenancy.

The port's copy of the reference's ``service/eviction.py``. Every resident
:class:`~repro_torch.service.store.StoreEntry` pins its register banks on
the device; with many graphs resident the store needs a budget. The
evictor keeps ``store.resident_bytes()`` under ``budget_bytes`` by dropping
the entries that are cheapest to lose:

    score = rebuild_cost × recency ÷ device_bytes

* **rebuild_cost** — the entry's measured ``build_time_s`` (what a future
  touch pays to bring it back; the store keeps an
  :class:`~repro_torch.service.store.EvictionRecipe` so the rebuild is
  transparent).
* **recency** — ``1 / (1 + age_s)`` since the last touch: hot entries are
  worth keeping, cold ones approach score 0.
* **device_bytes** — the bank footprint: big entries buy back more budget
  per eviction.

Lowest score goes first. Entries the store refuses to evict are skipped:
*stale* entries (their over-approximating matrix is history-dependent — a
pristine rebuild would change answers, violating the async≡sync contract)
and any key the caller protects (e.g. keys with queries in flight, to
avoid evict/rebuild thrash within one tick). The port's entries are all
host-resident (``StoreEntry.residency``), so the reference's exclusion of
mesh-placed entries never applies here.

``clock`` (``time.monotonic`` by default) is injectable, so a test drives
the scores with its own timeline. The async engine enforces the budget
from its serving and its mutation thread; ``enforce`` holds a lock, so two
calls never pick victims from one list of resident keys.
"""
from __future__ import annotations

import threading
import time
from typing import Iterable, Optional

from repro_torch.obs import metrics
from repro_torch.service.store import SketchStore, StoreKey


class CostAwareEvictor:
    """Keep a store's resident device bytes under a budget."""

    def __init__(self, budget_bytes: int, clock=time.monotonic):
        self.budget_bytes = int(budget_bytes)
        self._clock = clock
        self._last_touch: dict[StoreKey, float] = {}
        self._lock = threading.Lock()

    def touch(self, key: StoreKey, now: Optional[float] = None) -> None:
        """Record demand for a key (every submit/serve against it)."""
        self._last_touch[key] = self._clock() if now is None else now

    def score(self, entry, now: Optional[float] = None) -> float:
        """Keep-value of an entry: high = expensive to lose. The enforce
        loop evicts ascending."""
        now = self._clock() if now is None else now
        age_s = max(now - self._last_touch.get(entry.key, 0.0), 0.0)
        recency = 1.0 / (1.0 + age_s)
        return (max(entry.build_time_s, 1e-9) * recency
                / max(entry.device_bytes(), 1))

    def evictable(self, entry) -> bool:
        return not entry.stale and entry.residency == "host"

    def enforce(self, store: SketchStore,
                protect: Iterable[StoreKey] = ()) -> list[StoreKey]:
        """Evict lowest-score entries until the store fits the budget (or
        nothing evictable remains). Returns the evicted keys."""
        protected = set(protect)
        evicted: list[StoreKey] = []
        with self._lock:
            while store.resident_bytes() > self.budget_bytes:
                now = self._clock()
                candidates = [e for e in (store.entry(k)
                                          for k in store.resident_keys())
                              if e.key not in protected and self.evictable(e)]
                if not candidates:
                    break
                victim = min(candidates, key=lambda e: self.score(e, now))
                store.evict(victim.key)
                evicted.append(victim.key)
        over = store.resident_bytes() - self.budget_bytes
        metrics.gauge("evictor.over_budget_bytes").set(float(max(over, 0)))
        return evicted
