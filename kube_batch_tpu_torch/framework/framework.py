"""Session lifecycle: OpenSession / CloseSession.

Mirrors reference framework/framework.go (:30 OpenSession builds plugins from
tiers and runs OnSessionOpen with per-plugin timing; :55 CloseSession).

Divergence (intended-behavior fix): the reference runs its JobValid filter
inside openSession BEFORE tiers/plugins are installed (framework.go:31-32 vs
session.go:89-108), so gang's JobValidFn can never fire there — dead code.
Here validation runs after OnSessionOpen, so invalid gangs are dropped with
an Unschedulable condition as intended.
"""

from __future__ import annotations

import logging
import time
from typing import List

from .. import metrics
from ..conf import Tier
from ..obs import span
from .arguments import Arguments
from .plugins import get_plugin_builder
from .session import Session

logger = logging.getLogger(__name__)


def open_session(cache, tiers: List[Tier], micro: bool = False,
                 device=None) -> Session:
    ssn = Session(cache, tiers, micro=micro, device=device)
    ssn._open()

    for tier in tiers:
        for opt in tier.plugins:
            builder = get_plugin_builder(opt.name)
            if builder is None:
                logger.error("Failed to get plugin %s.", opt.name)
                continue
            plugin = builder(Arguments(opt.arguments))
            ssn.plugins[plugin.name()] = plugin

    with span("plugins_open"):
        for plugin in ssn.plugins.values():
            start = time.perf_counter()
            plugin.on_session_open(ssn)
            metrics.update_plugin_duration(
                plugin.name(), "OnSessionOpen", time.perf_counter() - start
            )

    ssn._validate_jobs()
    return ssn


def close_session(ssn: Session) -> None:
    # Drain guard: an overlapped allocate_tpu solve still in flight must
    # complete before the session's world view is torn down under it.
    ssn.drain_inflight_solve()
    # Close runs under the GC guard like the action body: plugin
    # OnSessionClose plus the status write-back allocate ~O(#jobs)
    # short-lived objects, and a generational collection landing inside
    # them showed up as close-time jitter in the reference's runs.
    # Nested guards are no-ops, so callers that
    # already hold one (scheduler.run_once, bench) are unchanged;
    # standalone callers get the deferral + bounded exit collection.
    from ..utils import deferred_gc

    with deferred_gc():
        with span("plugins_close"):
            for plugin in ssn.plugins.values():
                start = time.perf_counter()
                plugin.on_session_close(ssn)
                metrics.update_plugin_duration(
                    plugin.name(), "OnSessionClose",
                    time.perf_counter() - start,
                )
        ssn._close()
