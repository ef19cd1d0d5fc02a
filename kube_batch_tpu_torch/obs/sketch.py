"""Log-bucketed quantile sketch for the placement-latency ledger.

A copy of ``QuantileSketch`` from the reference's ``obs/telemetry.py``,
kept on its own so the port's ``obs`` never loads the telemetry module
(which reads JAX device memory).
"""

from __future__ import annotations

import math
from typing import Dict


class QuantileSketch:
    """Log-bucketed quantile sketch (DDSketch style).

    Positive values land in bucket ``ceil(log_gamma(v))`` with
    ``gamma = (1 + alpha) / (1 - alpha)``; the bucket's midpoint
    estimate ``2 * gamma^i / (gamma + 1)`` is within relative error
    ``alpha`` of any value in it. Zero/negative values (idle phases,
    signed drift series) are tracked exactly at their min — quantiles
    over them return that min, keeping the relative-error contract
    vacuous rather than wrong. Bounded: past ``max_buckets`` the lowest
    buckets collapse together (coarse at the cheap end, exact error at
    the tail, which is what latency series need).
    """

    __slots__ = ("alpha", "_gamma", "_log_gamma", "max_buckets",
                 "buckets", "count", "low_count", "low_min")

    def __init__(self, alpha: float = 0.05, max_buckets: int = 512):
        self.alpha = alpha
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self._gamma)
        self.max_buckets = max_buckets
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.low_count = 0       # values <= 0
        self.low_min = 0.0

    def add(self, value: float) -> None:
        self.count += 1
        if value <= 0.0:
            if self.low_count == 0 or value < self.low_min:
                self.low_min = value
            self.low_count += 1
            return
        idx = math.ceil(math.log(value) / self._log_gamma)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        if len(self.buckets) > self.max_buckets:
            self._collapse_lowest()

    def _collapse_lowest(self) -> None:
        lo = sorted(self.buckets)[:2]
        if len(lo) == 2:
            self.buckets[lo[1]] = (
                self.buckets.pop(lo[0]) + self.buckets.get(lo[1], 0)
            )

    def merge(self, other: "QuantileSketch") -> None:
        """Fold ``other`` into this sketch (log-bucket counts add
        exactly — DDSketch mergeability). Lives HERE, next to the
        fields it touches, so callers never poke sketch internals; the
        same ``max_buckets`` coalescing as :meth:`add` applies."""
        self.count += other.count
        if other.low_count:
            if self.low_count == 0 or other.low_min < self.low_min:
                self.low_min = other.low_min
            self.low_count += other.low_count
        for idx, c in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + c
        while len(self.buckets) > self.max_buckets:
            self._collapse_lowest()

    def quantile(self, q: float) -> float:
        """Value estimate at quantile ``q`` in [0, 1]; 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        if rank < self.low_count:
            return self.low_min
        seen = self.low_count
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen > rank:
                return 2.0 * self._gamma ** idx / (self._gamma + 1.0)
        idx = max(self.buckets)
        return 2.0 * self._gamma ** idx / (self._gamma + 1.0)
