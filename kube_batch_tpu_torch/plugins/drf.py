"""DRF plugin: Dominant Resource Fairness across jobs.

Mirrors reference plugins/drf/drf.go:
- Per-job share = max over resources of allocated/clusterTotal (:161-172).
- PreemptableFn: victim ok if preemptor's post-transfer share stays below (or
  within shareDelta of) the victim's (:85-108).
- JobOrderFn: lower share first (:115-132).
- Event handlers keep allocated+share incrementally updated (:137-157).
"""

from __future__ import annotations

import os
from typing import Dict

from ..api import JobInfo, Resource, share as share_fn
from ..framework import EventHandler, Plugin, register_plugin_builder


def _total_key(total: Resource):
    """Hashable identity of the cluster capacity a fold was computed
    against — shares are ratios, so any capacity move invalidates
    every cached share at once."""
    return (
        total.milli_cpu, total.memory,
        tuple(sorted((total.scalar_resources or {}).items())),
    )


def fold_reuse_enabled(cache) -> bool:
    """Cross-session plugin fold reuse (KBT_FOLD_REUSE, default on):
    requires the real scheduler cache's ``plugin_fold`` store."""
    return (
        getattr(cache, "plugin_fold", None) is not None
        and os.environ.get("KBT_FOLD_REUSE", "1") != "0"
    )

SHARE_DELTA = 0.000001  # reference drf.go:29


class _DrfAttr:
    __slots__ = ("allocated", "share")

    def __init__(self):
        self.allocated = Resource.empty()
        self.share = 0.0


class DrfPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.total_resource = Resource.empty()
        self.job_attrs: Dict[str, _DrfAttr] = {}

    def name(self) -> str:
        return "drf"

    def _calculate_share(self, allocated: Resource, total: Resource) -> float:
        res = 0.0
        for rn in total.resource_names():
            s = share_fn(allocated.get(rn), total.get(rn))
            if s > res:
                res = s
        return res

    def _update_share(self, attr: _DrfAttr) -> None:
        attr.share = self._calculate_share(attr.allocated, self.total_resource)

    def on_session_open(self, ssn) -> None:
        # Shared per-session aggregate (one O(nodes) pass for all
        # plugins, not one each).
        self.total_resource = ssn.total_node_allocatable()

        # Bulk share computation: one numpy pass over the cpu/mem
        # columns instead of a per-job resource_names walk (the per-job
        # form was a measurable slice of every steady-cycle open at
        # 500+ jobs). Scalar resources — rare — fold in per name.
        # Semantics identical to _calculate_share/share_fn: r == 0 →
        # 1.0 if l > 0 else 0.0.
        import numpy as np

        jobs = list(ssn.jobs.values())
        total = self.total_resource
        total_key = _total_key(total)

        # Cross-session fold reuse: an unchanged job keeps its snapshot
        # clone (same identity, same _ver — any mutation rides a _ver
        # bump and re-clones), so the _DrfAttr minted for it last open
        # — the share AND the allocated clone the event handlers fold
        # into — is still exact and is reused wholesale. Steady-state
        # micro opens then pay share math only for the churned jobs.
        store = (
            ssn.cache.plugin_fold if fold_reuse_enabled(ssn.cache) else None
        )
        cached = store.get("drf") if store is not None else None
        if cached is not None and cached["total"] != total_key:
            cached = None  # capacity moved: every cached share is stale
        prev: Dict[str, tuple] = (
            cached["entries"] if cached is not None else {}
        )
        miss = []
        for job in jobs:
            ent = prev.get(job.uid)
            if ent is not None and ent[0] is job and ent[1] == job._ver:
                self.job_attrs[job.uid] = ent[2]
            else:
                miss.append(job)

        M = len(miss)
        share = np.zeros(M, dtype=np.float64)

        def fold(vals, cap):
            nonlocal share
            if cap == 0:
                np.maximum(share, (vals > 0).astype(np.float64), out=share)
            else:
                np.maximum(share, vals / cap, out=share)

        if M:
            fold(
                np.fromiter(
                    (j.allocated.milli_cpu for j in miss), np.float64,
                    count=M,
                ),
                total.milli_cpu,
            )
            fold(
                np.fromiter(
                    (j.allocated.memory for j in miss), np.float64, count=M
                ),
                total.memory,
            )
            for name in (total.scalar_resources or ()):
                fold(
                    np.fromiter(
                        (
                            (j.allocated.scalar_resources or {}).get(name, 0.0)
                            for j in miss
                        ),
                        np.float64, count=M,
                    ),
                    total.scalar_resources[name],
                )
        shares = share.tolist()
        for i, job in enumerate(miss):
            attr = _DrfAttr()
            # JobInfo.allocated IS the sum of allocated-status task
            # resreqs (maintained by add/delete/update_task_status), so
            # re-summing 50k tasks per cycle (drf.go:66-73's per-task
            # walk) collapses to one aggregate clone per job.
            attr.allocated = job.allocated.clone()
            attr.share = shares[i]
            self.job_attrs[job.uid] = attr
            prev[job.uid] = (job, job._ver, attr)
        if store is not None:
            if len(prev) > len(jobs) + 1024:
                # Deleted jobs leave inert entries behind (a reused uid
                # misses on clone identity); bound the store instead of
                # paying a live-set walk every open.
                prev = {
                    uid: prev[uid] for uid in self.job_attrs
                    if uid in prev
                }
            store["drf"] = {"total": total_key, "entries": prev}

        def preemptable_fn(preemptor, preemptees):
            victims = []
            latt = self.job_attrs[preemptor.job]
            lalloc = latt.allocated.clone().add(preemptor.resreq)
            ls = self._calculate_share(lalloc, self.total_resource)
            allocations: Dict[str, Resource] = {}
            for preemptee in preemptees:
                if preemptee.job not in allocations:
                    allocations[preemptee.job] = self.job_attrs[
                        preemptee.job
                    ].allocated.clone()
                ralloc = allocations[preemptee.job].sub(preemptee.resreq)
                rs = self._calculate_share(ralloc, self.total_resource)
                if ls < rs or abs(ls - rs) <= SHARE_DELTA:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name(), preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            ls, rs = self.job_attrs[l.uid].share, self.job_attrs[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_job_order_fn(self.name(), job_order_fn)

        def batch_job_order_key(jobs):
            import numpy as np

            # Ascending key ≡ job_order_fn: lower share first.
            return np.asarray(
                [self.job_attrs[j.uid].share for j in jobs], np.float64
            )

        ssn.add_batch_job_order_key_fn(self.name(), batch_job_order_key)

        def on_allocate(event):
            attr = self.job_attrs[event.task.job]
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event):
            attr = self.job_attrs[event.task.job]
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)

        def on_allocate_batch(batches):
            # Aggregate fold of on_allocate: the share math is
            # associative over a batch, so each JobBatchEvent costs ONE
            # Resource add + one share update — ~#jobs work for a
            # 50k-task apply instead of 50k per-task handler calls
            # (drf.go:137-157's per-event form).
            for b in batches:
                attr = self.job_attrs[b.job.uid]
                attr.allocated.add(b.delta)
                self._update_share(attr)

        def on_evict_batch(batches):
            # Aggregate fold of on_deallocate (exact: deltas are sums
            # of integral milli/byte quantities).
            for b in batches:
                attr = self.job_attrs[b.job.uid]
                attr.allocated.sub(b.delta)
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
        self.job_attrs = {}


register_plugin_builder("drf", lambda args: DrfPlugin(args))
