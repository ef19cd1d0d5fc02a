"""Gang plugin: all-or-nothing minMember semantics.

Mirrors reference plugins/gang/gang.go:
- JobValidFn: ValidTaskNum >= MinAvailable else NotEnoughTasks (:48-66).
- Preemptable/Reclaimable: a victim is only evictable if its job stays at or
  above minAvailable afterwards (:70-93).
- JobOrderFn: not-ready jobs first (:97-119).
- JobReady/JobPipelined from JobInfo.Ready/Pipelined (:121-128).
- OnSessionClose: Unschedulable PodGroup conditions + unschedulable metrics
  (:132-160).
"""

from __future__ import annotations

from .. import metrics
from ..api import (
    NOT_ENOUGH_PODS_REASON,
    NOT_ENOUGH_RESOURCES_REASON,
    POD_GROUP_CONDITION_UNSCHEDULABLE,
    JobInfo,
    PodGroupCondition,
    ValidateResult,
)
from ..framework import Plugin, register_plugin_builder


class GangPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return "gang"

    def on_session_open(self, ssn) -> None:
        def valid_job_fn(job) -> ValidateResult:
            if not isinstance(job, JobInfo):
                return ValidateResult(
                    passed=False, message=f"Failed to convert {job!r} to JobInfo"
                )
            vtn = job.valid_task_num()
            if vtn < job.min_available:
                return ValidateResult(
                    passed=False,
                    reason=NOT_ENOUGH_PODS_REASON,
                    message=(
                        f"Not enough valid tasks for gang-scheduling, "
                        f"valid: {vtn}, min: {job.min_available}"
                    ),
                )
            return None

        ssn.add_job_valid_fn(self.name(), valid_job_fn)

        def preemptable_fn(preemptor, preemptees):
            victims = []
            for preemptee in preemptees:
                job = ssn.jobs[preemptee.job]
                occupied = job.ready_task_num()
                preemptable = (
                    job.min_available <= occupied - 1 or job.min_available == 1
                )
                if preemptable:
                    victims.append(preemptee)
            return victims

        ssn.add_reclaimable_fn(self.name(), preemptable_fn)
        ssn.add_preemptable_fn(self.name(), preemptable_fn)

        def job_order_fn(l, r) -> int:
            l_ready, r_ready = l.ready(), r.ready()
            if l_ready and r_ready:
                return 0
            if l_ready:
                return 1
            if r_ready:
                return -1
            return 0

        ssn.add_job_order_fn(self.name(), job_order_fn)

        def batch_job_order_key(jobs):
            import numpy as np

            # Ascending key ≡ job_order_fn: not-ready gangs first. One
            # readiness evaluation per job instead of one per comparison
            # (job.ready() re-sums the status index on every call, so
            # the comparison sort paid it O(J log J) times per queue).
            return np.asarray(
                [1.0 if j.ready() else 0.0 for j in jobs], np.float64
            )

        ssn.add_batch_job_order_key_fn(self.name(), batch_job_order_key)
        ssn.add_job_ready_fn(self.name(), lambda job: job.ready())
        ssn.add_job_pipelined_fn(self.name(), lambda job: job.pipelined())

    def on_session_close(self, ssn) -> None:
        unschedulable_jobs = 0
        for job in ssn.jobs.values():
            if not job.ready():
                unready = job.min_available - job.ready_task_num()
                msg = (
                    f"{unready}/{len(job.tasks)} tasks in gang unschedulable: "
                    f"{job.fit_error()}"
                )
                unschedulable_jobs += 1
                metrics.update_unschedulable_task_count(job.name, int(unready))
                metrics.register_job_retries(job.name)
                cond = PodGroupCondition(
                    type=POD_GROUP_CONDITION_UNSCHEDULABLE,
                    status="True",
                    transition_id=ssn.uid,
                    reason=NOT_ENOUGH_RESOURCES_REASON,
                    message=msg,
                )
                try:
                    ssn.update_job_condition(job, cond)
                except KeyError:
                    pass
        metrics.update_unschedulable_job_count(unschedulable_jobs)


register_plugin_builder("gang", lambda args: GangPlugin(args))
