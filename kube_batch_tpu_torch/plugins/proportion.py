"""Proportion plugin: queue-level weighted fair share via water-filling.

Mirrors reference plugins/proportion/proportion.go:
- Iterative water-filling distributes cluster capacity to queues by weight
  until remaining is empty or every queue's request is met (:100-147).
- QueueOrderFn by share = max(allocated/deserved) (:156-168, :241-253).
- ReclaimableFn: victim ok if its queue stays >= deserved after removal
  (:171-195).
- OverusedFn: deserved <= allocated (:198-208).
- Event handlers keep allocated/share live (:211-234).
"""

from __future__ import annotations

from typing import Dict

from ..api import (
    QueueInfo,
    Resource,
    min_resource,
    share as share_fn,
)
from ..api.types import TaskStatus
from ..framework import EventHandler, Plugin, register_plugin_builder


class _QueueAttr:
    __slots__ = ("queue_id", "name", "weight", "deserved", "allocated", "request", "share")

    def __init__(self, queue_id: str, name: str, weight: int):
        self.queue_id = queue_id
        self.name = name
        self.weight = weight
        self.deserved = Resource.empty()
        self.allocated = Resource.empty()
        self.request = Resource.empty()
        self.share = 0.0


class ProportionPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.total_resource = Resource.empty()
        self.queue_attrs: Dict[str, _QueueAttr] = {}

    def name(self) -> str:
        return "proportion"

    def _update_share(self, attr: _QueueAttr) -> None:
        res = 0.0
        for rn in attr.deserved.resource_names():
            s = share_fn(attr.allocated.get(rn), attr.deserved.get(rn))
            if s > res:
                res = s
        attr.share = res

    def on_session_open(self, ssn) -> None:
        from .drf import fold_reuse_enabled

        # Shared per-session aggregate (one O(nodes) pass for all
        # plugins, not one each).
        self.total_resource = ssn.total_node_allocatable()

        # Cross-session fold reuse: the per-job PENDING walk (request =
        # allocated + pending) is the O(tasks) term of this open; an
        # unchanged job keeps its snapshot clone (identity + _ver), so
        # its pending sum from the previous open is still exact and the
        # walk runs only for churned jobs. The queue aggregation itself
        # stays O(jobs) Resource adds — small constant, no task walks.
        store = (
            ssn.cache.plugin_fold if fold_reuse_enabled(ssn.cache) else None
        )
        pend_cache: Dict[str, tuple] = (
            store.setdefault("proportion", {}) if store is not None else {}
        )

        # Build queue attributes from jobs (reference :66-99).
        for job in ssn.jobs.values():
            if job.queue not in ssn.queues:
                continue
            if job.queue not in self.queue_attrs:
                queue = ssn.queues[job.queue]
                self.queue_attrs[queue.uid] = _QueueAttr(
                    queue.uid, queue.name, queue.weight
                )
            attr = self.queue_attrs[job.queue]
            # allocated-status sum == the maintained JobInfo.allocated
            # aggregate; only the PENDING index still needs a per-task
            # walk (request = allocated + pending). Steady-state session
            # opens stop re-summing every placed task.
            attr.allocated.add(job.allocated)
            attr.request.add(job.allocated)
            ent = pend_cache.get(job.uid)
            if ent is not None and ent[0] is job and ent[1] == job._ver:
                pending = ent[2]
            else:
                pending = Resource.empty()
                for t in job.task_status_index.get(
                    TaskStatus.PENDING, {}
                ).values():
                    pending.add(t.resreq)
                pend_cache[job.uid] = (job, job._ver, pending)
            attr.request.add(pending)
        if store is not None and len(pend_cache) > len(ssn.jobs) + 1024:
            # Bound the store against deleted-job residue (entries are
            # self-invalidating, so this is memory hygiene only).
            live = {
                uid: ent for uid, ent in pend_cache.items()
                if uid in ssn.jobs
            }
            store["proportion"] = live

        # Water-filling (reference :100-147).
        remaining = self.total_resource.clone()
        meet: Dict[str, bool] = {}
        while True:
            total_weight = sum(
                a.weight for a in self.queue_attrs.values() if a.queue_id not in meet
            )
            if total_weight == 0:
                break
            increased = Resource.empty()
            decreased = Resource.empty()
            for attr in self.queue_attrs.values():
                if attr.queue_id in meet:
                    continue
                old_deserved = attr.deserved.clone()
                attr.deserved.add(
                    remaining.clone().multi(attr.weight / total_weight)
                )
                if attr.request.less(attr.deserved):
                    attr.deserved = min_resource(attr.deserved, attr.request)
                    meet[attr.queue_id] = True
                self._update_share(attr)
                inc, dec = attr.deserved.diff(old_deserved)
                increased.add(inc)
                decreased.add(dec)
            remaining.sub(increased)
            remaining.add(decreased)
            if remaining.is_empty():
                break

        def queue_order_fn(l: QueueInfo, r: QueueInfo) -> int:
            ls, rs = self.queue_attrs[l.uid].share, self.queue_attrs[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_queue_order_fn(self.name(), queue_order_fn)

        def reclaimable_fn(reclaimer, reclaimees):
            victims = []
            allocations: Dict[str, Resource] = {}
            for reclaimee in reclaimees:
                job = ssn.jobs.get(reclaimee.job)
                attr = (
                    self.queue_attrs.get(job.queue)
                    if job is not None else None
                )
                if attr is None:
                    # Untracked queue (see _attr_of): proportion has no
                    # share opinion, so it neither protects nor offers
                    # the task — raising here would abort reclaim.
                    continue
                if job.queue not in allocations:
                    allocations[job.queue] = attr.allocated.clone()
                allocated = allocations[job.queue]
                if allocated.less(reclaimee.resreq):
                    continue
                allocated.sub(reclaimee.resreq)
                if attr.deserved.less_equal(allocated):
                    victims.append(reclaimee)
            return victims

        ssn.add_reclaimable_fn(self.name(), reclaimable_fn)

        def overused_fn(queue: QueueInfo) -> bool:
            attr = self.queue_attrs.get(queue.uid)
            if attr is None:
                return False
            return attr.deserved.less_equal(attr.allocated)

        ssn.add_overused_fn(self.name(), overused_fn)

        def queue_budget_fn(queue: QueueInfo):
            attr = self.queue_attrs.get(queue.uid)
            if attr is None:
                return None
            return attr.deserved, attr.allocated

        ssn.add_queue_budget_fn(self.name(), queue_budget_fn)

        def _attr_of(task):
            # A task whose job sits on a queue proportion never tracked
            # (e.g. a shadow job on a deleted/missing queue — the same
            # jobs on_session_open skips) has no share bookkeeping; an
            # event handler raising here would abort the caller's whole
            # allocate, so skip instead.
            job = ssn.jobs.get(task.job)
            if job is None:
                return None
            return self.queue_attrs.get(job.queue)

        def on_allocate(event):
            attr = _attr_of(event.task)
            if attr is None:
                return
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event):
            attr = _attr_of(event.task)
            if attr is None:
                return
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)

        def _attr_of_job(job):
            # Same skip rule as _attr_of, with the job already resolved.
            return self.queue_attrs.get(job.queue)

        def on_allocate_batch(batches):
            # Aggregate fold of on_allocate: the deserved/allocated math
            # is associative over a batch, so each per-job JobBatchEvent
            # costs one Resource add on its queue attr and each touched
            # queue one share update — ~#jobs work for a 50k-task apply
            # (proportion.go:211-234's per-event form).
            touched = {}
            for b in batches:
                attr = _attr_of_job(b.job)
                if attr is None:
                    continue
                attr.allocated.add(b.delta)
                touched[id(attr)] = attr
            for attr in touched.values():
                self._update_share(attr)

        def on_evict_batch(batches):
            # Aggregate fold of on_deallocate.
            touched = {}
            for b in batches:
                attr = _attr_of_job(b.job)
                if attr is None:
                    continue
                attr.allocated.sub(b.delta)
                touched[id(attr)] = attr
            for attr in touched.values():
                self._update_share(attr)

        ssn.add_event_handler(
            EventHandler(
                allocate_func=on_allocate,
                deallocate_func=on_deallocate,
                batch_allocate_func=on_allocate_batch,
                batch_deallocate_func=on_evict_batch,
            )
        )

    def on_session_close(self, ssn) -> None:
        self.total_resource = Resource.empty()
        self.queue_attrs = {}


register_plugin_builder("proportion", lambda args: ProportionPlugin(args))
