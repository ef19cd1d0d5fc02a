"""Actions (mirrors reference pkg/scheduler/actions).

Importing this package registers every builtin action with the framework
registry (the reference's factory.go:28-33 / init() pattern), including the
TPU-native ``allocate_tpu`` batched drop-in."""

from . import allocate, allocate_tpu, backfill, preempt, reclaim  # noqa: F401
