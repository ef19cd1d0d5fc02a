"""Priority plugin (reference plugins/priority/priority.go:39-82):
TaskOrderFn by task priority (PodSpec.Priority), JobOrderFn by job priority
(PodGroup PriorityClass, resolved in cache snapshot)."""

from __future__ import annotations

from ..framework import Plugin, register_plugin_builder


class PriorityPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return "priority"

    def on_session_open(self, ssn) -> None:
        def task_order_fn(l, r) -> int:
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_task_order_fn(self.name(), task_order_fn)

        def batch_task_order_key(tasks):
            import numpy as np

            # Ascending key ≡ task_order_fn: higher priority first.
            return np.asarray([-t.priority for t in tasks], np.float64)

        ssn.add_batch_task_order_key_fn(self.name(), batch_task_order_key)

        def job_order_fn(l, r) -> int:
            if l.priority > r.priority:
                return -1
            if l.priority < r.priority:
                return 1
            return 0

        ssn.add_job_order_fn(self.name(), job_order_fn)

        def batch_job_order_key(jobs):
            import numpy as np

            # Ascending key ≡ job_order_fn: higher priority first.
            return np.asarray([-j.priority for j in jobs], np.float64)

        ssn.add_batch_job_order_key_fn(self.name(), batch_job_order_key)


register_plugin_builder("priority", lambda args: PriorityPlugin(args))
