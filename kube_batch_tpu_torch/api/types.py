"""Core scheduling types: task status machine + validation results.

Mirrors reference pkg/scheduler/api/types.go (:23 TaskStatus enum,
:111 ValidateResult) and helpers.go (:62 AllocatedStatus).
TaskStatus is an IntEnum so it can live directly in snapshot tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class TaskStatus(IntEnum):
    """Status of a task (reference types.go:23-58)."""

    PENDING = 0      # task not started; pod not yet assigned
    ALLOCATED = 1    # resources assigned within a Session, not yet bound
    PIPELINED = 2    # assigned onto releasing resources; waits for release
    BINDING = 3      # bind request sent, not yet confirmed
    BOUND = 4        # bound to host
    RUNNING = 5      # task running
    RELEASING = 6    # being deleted / resources releasing
    SUCCEEDED = 7
    FAILED = 8
    UNKNOWN = 9


# Statuses whose resources are held on a node (reference helpers.go:62-75).
ALLOCATED_STATUSES = frozenset(
    {TaskStatus.BOUND, TaskStatus.BINDING, TaskStatus.RUNNING, TaskStatus.ALLOCATED}
)


def allocated_status(status: TaskStatus) -> bool:
    return status in ALLOCATED_STATUSES


def validate_status_update(old: TaskStatus, new: TaskStatus) -> None:
    """Status-transition guard (reference types.go validateStatusUpdate — the
    reference currently allows all transitions; kept as a seam)."""
    return None


class NodePhase:
    """Node readiness phase (reference types.go NodePhase)."""

    READY = "Ready"
    NOT_READY = "NotReady"


@dataclass
class ValidateResult:
    """Result of a JobValid callback (reference types.go:111-118)."""

    passed: bool
    reason: str = ""
    message: str = ""
