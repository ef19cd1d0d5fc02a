"""Scheduler cache (mirrors reference pkg/scheduler/cache)."""

from .cache import (
    DefaultBinder,
    DefaultEvictor,
    DefaultStatusUpdater,
    DefaultVolumeBinder,
    SchedulerCache,
    new_scheduler_cache,
)
from .interface import Binder, Cache, Evictor, StatusUpdater, VolumeBinder
from .util import create_shadow_pod_group, job_terminated, shadow_pod_group
