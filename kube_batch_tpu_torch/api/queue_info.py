"""QueueInfo: scheduling view of a tenant queue.

Mirrors reference pkg/scheduler/api/queue_info.go (:73 QueueInfo{UID,Name,
Weight,Queue}; Spec.Weight/Capability :63-66).
"""

from __future__ import annotations

from .objects import Queue

QueueID = str


class QueueInfo:
    def __init__(self, queue: Queue):
        # UID is the queue NAME (reference queue_info.go:77: jobs reference
        # queues by name, and the cache keys queues by name too).
        self.uid: QueueID = queue.name
        self.name = queue.name
        self.weight = queue.spec.weight
        self.queue = queue

    def clone(self) -> "QueueInfo":
        return QueueInfo(self.queue)

    def __repr__(self) -> str:
        return f"Queue ({self.name}): weight {self.weight}"
