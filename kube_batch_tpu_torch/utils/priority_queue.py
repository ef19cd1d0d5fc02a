"""Heap-backed priority queue ordered by a LessFn.

Mirrors reference pkg/scheduler/util/priority_queue.go:26-79. Items for which
``less_fn(a, b)`` is True pop first. Insertion order breaks ties (stable).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, List

LessFn = Callable[[Any, Any], bool]


class _Entry:
    __slots__ = ("item", "less_fn", "seq")

    def __init__(self, item, less_fn, seq):
        self.item = item
        self.less_fn = less_fn
        self.seq = seq

    def __lt__(self, other: "_Entry") -> bool:
        if self.less_fn(self.item, other.item):
            return True
        if self.less_fn(other.item, self.item):
            return False
        return self.seq < other.seq


class PriorityQueue:
    def __init__(self, less_fn: LessFn):
        self._less_fn = less_fn
        self._heap: List[_Entry] = []
        self._seq = itertools.count()

    def push(self, item: Any) -> None:
        heapq.heappush(self._heap, _Entry(item, self._less_fn, next(self._seq)))

    def pop(self) -> Any:
        if not self._heap:
            return None
        return heapq.heappop(self._heap).item

    def empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)
