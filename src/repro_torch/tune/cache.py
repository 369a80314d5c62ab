"""Persistent tuning cache: measured kernel-config winners keyed by workload.

Counterpart of the reference's ``tune/cache.py``, with its JSON schema and
version. One JSON file maps ``kernel family x backend x impl x diffusion
model x size bucket`` to the ``KernelConfig`` that measured fastest, with the
measurement record that justified it (default against tuned microseconds,
achieved GB/s, share of the bandwidth roof). The port writes the device type
(``cuda`` or ``cpu``) into the key's ``impl`` slot, so its entries never meet
the reference's (``ref``, ``pallas``) in a shared file, and a configuration
the other package cannot read is ignored there (``KernelConfig.from_dict``
drops unknown fields both ways). Sizes are bucketed to the next power of two,
so a cache tuned at one R-MAT scale serves its neighbours; a miss falls back
to today's defaults (``tuning="cached"`` on a cold cache runs as ``"off"``).

The file is ``TUNE_cache.json`` in the working directory by default
(``REPRO_TUNE_CACHE`` overrides it; an empty value keeps the cache in
memory).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

from repro_torch.tune.config import KernelConfig

#: schema version of the on-disk JSON (the reference's)
CACHE_VERSION = 1

#: default on-disk location (relative to the working directory)
DEFAULT_CACHE_PATH = "TUNE_cache.json"

#: environment override for the cache path ("" disables persistence)
CACHE_ENV = "REPRO_TUNE_CACHE"


def size_bucket(num_edges: int) -> int:
    """An edge count rounded up to the next power of two, at least 256."""
    n = max(int(num_edges), 1)
    b = 256
    while b < n:
        b <<= 1
    return b


def cache_key(family: str, *, backend: str, impl: str, model: str,
              num_edges: int) -> str:
    """The lookup key: ``family|backend|impl|model|e<bucket>``."""
    return "|".join((family, backend, impl, model, f"e{size_bucket(num_edges)}"))


class TuningCache:
    """JSON-backed map of cache key to (winning config, measurement record)."""

    def __init__(self, path: Optional[str] = DEFAULT_CACHE_PATH):
        self.path = path or None
        self._entries: Dict[str, dict] = {}
        self._loaded = False

    def load(self) -> "TuningCache":
        """Read the JSON file if present; empty on a missing, unreadable or
        other-version file."""
        self._loaded = True
        if not self.path or not os.path.exists(self.path):
            return self
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
            if int(doc.get("version", 0)) == CACHE_VERSION:
                entries = doc.get("entries", {})
                if isinstance(entries, dict):
                    self._entries = {str(k): dict(v) for k, v in entries.items()}
        except (OSError, ValueError, TypeError, AttributeError):
            self._entries = {}
        return self

    def save(self) -> None:
        """Write back to ``self.path`` (nothing when persistence is off),
        through a temporary file renamed into place."""
        if not self.path:
            return
        doc = {"version": CACHE_VERSION, "entries": self._entries}
        tmp = f"{self.path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
        os.replace(tmp, self.path)

    def _ensure_loaded(self) -> None:
        if not self._loaded:
            self.load()

    def lookup(self, key: str) -> Optional[KernelConfig]:
        """The winning config for ``key``, or None on a miss."""
        self._ensure_loaded()
        entry = self._entries.get(key)
        if entry is None:
            return None
        try:
            return KernelConfig.from_dict(entry.get("config", {}))
        except (TypeError, ValueError):
            return None

    def record(self, key: str) -> Optional[dict]:
        """The full entry for ``key`` (config and measurement)."""
        self._ensure_loaded()
        entry = self._entries.get(key)
        return dict(entry) if entry is not None else None

    def put(self, key: str, config: KernelConfig, *,
            measurement: Optional[dict] = None) -> None:
        """Store a winner, and its evidence, under ``key``."""
        self._ensure_loaded()
        entry = {"config": config.to_dict()}
        if measurement:
            entry["measurement"] = dict(measurement)
        self._entries[key] = entry

    def records(self) -> Dict[str, dict]:
        """All entries by key (copies; the report reads them)."""
        self._ensure_loaded()
        return {k: dict(v) for k, v in self._entries.items()}

    def __len__(self) -> int:
        self._ensure_loaded()
        return len(self._entries)


_default: Optional[TuningCache] = None


def default_cache() -> TuningCache:
    """The process's cache at ``$REPRO_TUNE_CACHE`` or ``TUNE_cache.json``
    (a new one whenever the path changes)."""
    global _default
    path = os.environ.get(CACHE_ENV, DEFAULT_CACHE_PATH)
    if _default is None or _default.path != (path or None):
        _default = TuningCache(path)
    return _default


def reset_default_cache() -> None:
    """Drop the process's cache (tests)."""
    global _default
    _default = None
