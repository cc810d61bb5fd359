"""BoundedLRU: the one eviction policy for the runner caches.

Two caches in the package hold built runners and must not grow without
bound: ``EngineCore._runners`` (one runner per ``(days, observables)`` key;
on the card a runner holds captured CUDA graphs and their memory pools)
and the serving tier's warm shape-bucket table
(:mod:`repro_torch.serve.server`, one resident ``EngineCore`` per bucket).
The port of the reference's ``repro.engine.cache``.
Both are keyed by hashables, both want least-recently-used eviction
under a max-entries budget, and both need eviction *stats* surfaced to
telemetry — so the policy lives here once and is shared.

Deterministic by construction: recency order is the only state, and it
is driven purely by the caller's get/put sequence (no clocks).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional


class BoundedLRU:
    """An ordered mapping with least-recently-used eviction.

    ``max_entries=None`` means unbounded (the stats still work).
    ``on_evict(key, value)`` observes every eviction — the serve tier
    uses it to count bucket teardowns and drop references promptly.
    """

    def __init__(self, max_entries: Optional[int] = None,
                 on_evict: Optional[Callable] = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._on_evict = on_evict
        self._data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- mapping surface -------------------------------------------------
    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def __iter__(self):
        """Iterate keys in recency order (least recent first), dict-like."""
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def get(self, key, default=None):
        """Recency-bumping lookup; counts a hit or a miss."""
        if key in self._data:
            self._data.move_to_end(key)
            self.hits += 1
            return self._data[key]
        self.misses += 1
        return default

    def peek(self, key, default=None):
        """Lookup without touching recency or the hit/miss counters."""
        return self._data.get(key, default)

    def put(self, key, value) -> None:
        """Insert/overwrite ``key`` as most-recent, evicting the least
        recently used entry if the budget is exceeded."""
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while self.max_entries is not None and len(self._data) > self.max_entries:
            old_key, old_val = self._data.popitem(last=False)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(old_key, old_val)

    def pop(self, key, default=None):
        """Remove ``key`` without counting it as an eviction (caller-
        driven invalidation, not budget pressure)."""
        return self._data.pop(key, default)

    # -- telemetry -------------------------------------------------------
    def stats(self) -> dict:
        """The counters the serve metrics and the core introspection
        expose: size/budget plus lifetime hit/miss/eviction counts."""
        return {
            "size": len(self._data),
            "max_entries": self.max_entries,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }
