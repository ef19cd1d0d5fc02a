"""Placement-quality churn accounting.

The part of the reference's ``obs/quality.py`` that the cache's bind
and evict seams feed: cumulative evictions, preemptions, placements and
re-binds (a bind of a uid evicted earlier). The per-cycle scorecard
(packing density, fragmentation, fairness) and its flight-record feed
are not ported yet; ``cards_computed`` stays 0 and ``last`` None.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

from ..utils.lockdebug import witness_writes, wrap_lock

logger = logging.getLogger(__name__)

QUALITY_ENV = "KBT_QUALITY"              # "0" disables the feed
QUALITY_EVERY_ENV = "KBT_QUALITY_EVERY"  # production-feed cadence
DEFAULT_QUALITY_EVERY = 64
# Eviction-reason values that count as preemption churn (cache.evict
# callers pass these for preempt/reclaim victims).
_PREEMPT_REASONS = frozenset(("preempt", "reclaim"))
# The evicted-uid set exists to classify a later bind as a RE-bind; a
# uid evicted and never re-bound would otherwise pin memory forever on
# a production-length run.
_EVICTED_CAP = 1 << 18


def quality_enabled_from_env() -> bool:
    return os.environ.get(QUALITY_ENV, "1") != "0"


def quality_every_from_env() -> int:
    try:
        return max(1, int(os.environ.get(
            QUALITY_EVERY_ENV, DEFAULT_QUALITY_EVERY
        )))
    except ValueError:
        return DEFAULT_QUALITY_EVERY


class QualityMonitor:
    """Cumulative churn accounting.

    The cache's evict/bind seams call :meth:`note_eviction` /
    :meth:`note_bound` (cheap: one lock, counter bumps, a set probe to
    classify re-binds)."""

    def __init__(self):
        self._lock = wrap_lock("obs.quality")
        self.enabled = quality_enabled_from_env()
        self.every = quality_every_from_env()
        self._cycles = 0
        self._cards = 0
        self._last_card: Optional[dict] = None
        self.evictions = 0
        self.preemptions = 0
        self.rebinds = 0
        self.bound = 0
        self.evictions_by_reason: Dict[str, int] = {}
        self._evicted: set = set()
        witness_writes(self, "obs.quality", (
            "_cycles", "_cards", "_last_card", "evictions",
            "preemptions", "rebinds", "bound",
        ))

    def reset(self) -> None:
        with self._lock:
            self.enabled = quality_enabled_from_env()
            self.every = quality_every_from_env()
            self._cycles = 0
            self._cards = 0
            self._last_card = None
            self.evictions = 0
            self.preemptions = 0
            self.rebinds = 0
            self.bound = 0
            self.evictions_by_reason = {}
            self._evicted = set()

    # -- churn seams (cache/cache.py) ---------------------------------------

    def note_eviction(self, uid: str, reason: str = "") -> None:
        with self._lock:
            self.evictions += 1
            key = reason or "unknown"
            self.evictions_by_reason[key] = (
                self.evictions_by_reason.get(key, 0) + 1
            )
            if reason in _PREEMPT_REASONS:
                self.preemptions += 1
            if len(self._evicted) >= _EVICTED_CAP:
                self._evicted.clear()
            self._evicted.add(uid)
        try:
            from .. import metrics

            metrics.register_quality_eviction(reason or "unknown")
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("quality eviction metric failed")

    def note_bound(self, uids: Sequence[str]) -> None:
        if not uids:
            return
        with self._lock:
            self.bound += len(uids)
            rebound = [u for u in uids if u in self._evicted]
            if rebound:
                self.rebinds += len(rebound)
                self._evicted.difference_update(rebound)
        if rebound:
            try:
                from .. import metrics

                metrics.register_quality_rebinds(len(rebound))
            except Exception:  # pragma: no cover
                logger.exception("quality rebind metric failed")

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return {
                "evictions": float(self.evictions),
                "preemptions": float(self.preemptions),
                "rebinds": float(self.rebinds),
                "placements": float(self.bound),
            }

    def churn_delta(self, prev: Dict[str, float]) -> Dict[str, float]:
        """Delta of the cumulative churn counters against ``prev``
        (caller-owned: the scheduler feed and any sim feed each pass
        their own), updating ``prev`` in place."""
        now = self.counters()
        delta = {k: now[k] - prev.get(k, 0.0) for k in now}
        prev.update(now)
        return delta

    # -- read side (/debug/quality, /debug/vars) ----------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "type": "quality",
                "enabled": self.enabled,
                "every": self.every,
                "cycles_seen": self._cycles,
                "cards_computed": self._cards,
                "counters": {
                    "evictions": self.evictions,
                    "preemptions": self.preemptions,
                    "rebinds": self.rebinds,
                    "placements": self.bound,
                    "evictions_by_reason": dict(
                        self.evictions_by_reason
                    ),
                },
                "last": self._last_card,
            }


QUALITY = QualityMonitor()
