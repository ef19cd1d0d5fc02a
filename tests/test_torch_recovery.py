"""Parity of the port's successor recovery (``cache/recovery.py``) with
the JAX package's.

The seventeen cases of ``tests/unit/test_recovery.py`` run the same
cluster script through both packages: an ``InProcessCluster`` holding a
dead predecessor's bind-intent journal, then ``reconcile_journal`` (or
the ``Scheduler`` entry point). ``RecoveryReport.summary()`` (without
its wall-clock duration), the pods bound or evicted afterwards, and
the journal left behind must be equal, and equal to what the
reference's cases expect.
"""

import importlib
from types import SimpleNamespace

import pytest

PKGS = ("kube_batch_tpu", "kube_batch_tpu_torch")


def package(name):
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        name=name, api=m("api"), tu=m("utils.test_utils"),
        metrics=m("metrics"), recovery=m("cache.recovery"),
        SchedulerCache=m("cache").SchedulerCache,
        InProcessCluster=m("cluster").InProcessCluster,
        scheduler=m("scheduler"),
    )


def req(P, cpu="500m", mem="512Mi"):
    return P.api.build_resource_list(cpu=cpu, memory=mem)


def make_cluster(P, nodes=("n1", "n2"), node_cpu="8"):
    c = P.InProcessCluster(simulate_kubelet=True)
    c.create_queue(P.tu.build_queue("default", weight=1))
    for n in nodes:
        c.create_node(P.tu.build_node(n, P.api.build_resource_list(
            cpu=node_cpu, memory="16Gi", pods=110)))
    return c


def add_node(P, c, name, cpu, mem, pods):
    c.create_node(P.tu.build_node(name, P.api.build_resource_list(
        cpu=cpu, memory=mem, pods=pods)))


def add_gang(P, cluster, name, members, min_member, bound_on=None):
    """A PodGroup and its pods; ``bound_on`` maps pod index -> node for
    members already bound."""
    bound_on = bound_on or {}
    cluster.create_pod_group(P.tu.build_pod_group(
        name, namespace="ns", min_member=min_member))
    pods = []
    for i in range(members):
        pod = P.tu.build_pod("ns", f"{name}-{i}", "", P.api.PodPhase.PENDING,
                             req(P), group_name=name)
        cluster.create_pod(pod)
        if i in bound_on:
            cluster.bind_pod(pod, bound_on[i])
        pods.append(pod)
    return pods


def intent(cluster, pods, nodes, job, minm, marks=None, leader="dead-0"):
    seq = cluster.append_bind_intent({
        "leader": leader,
        "tasks": [
            {"uid": p.uid, "pod": f"ns/{p.name}", "node": n, "job": job}
            for p, n in zip(pods, nodes)
        ],
        "gangs": {job: minm},
    })
    for uid, outcome in (marks or {}).items():
        cluster.mark_bind_intent(seq, uid, outcome)
    return seq


def summary(report):
    out = report.summary()
    out.pop("duration_ms")
    return out


def truth(c):
    """Cluster truth after recovery: every pod with its node, and the
    journal records left."""
    return {
        "pods": sorted((p.name, p.spec.node_name)
                       for p in c.list_objects("Pod")),
        "journal": len(c.list_bind_intents()),
    }


def reconcile(P, c):
    return dict(summary(P.recovery.reconcile_journal(c, "succ-1")),
                **truth(c))


# ---------------------------------------------------------------- scripts


def marked_and_truth_backfilled_rows(P):
    c = make_cluster(P)
    pods = add_gang(P, c, "pg1", 4, 2, bound_on={0: "n1", 1: "n1"})
    # p0: bind landed + marked; p1: landed, mark lost in the crash; p2:
    # bound ELSEWHERE by a later leader; p3: deleted.
    c.bind_pod(pods[2], "n2")
    intent(c, pods, ["n1"] * 4, "ns/pg1", 2,
           marks={pods[0].uid: "applied"})
    c.delete_pod(pods[3])
    return reconcile(P, c)


def failed_mark_classifies_failed(P):
    c = make_cluster(P)
    pods = add_gang(P, c, "pg1", 2, 1)
    intent(c, pods, ["n1", "n1"], "ns/pg1", 1,
           marks={pods[0].uid: "failed"})
    return reconcile(P, c)


def lost_without_gang_constraint_requeues(P):
    c = make_cluster(P)
    pods = add_gang(P, c, "pg1", 2, 1)
    intent(c, pods, ["n1", "n1"], "ns/pg1", 1)
    return reconcile(P, c)


def lost_whole_gang_unbound_requeues(P):
    c = make_cluster(P)
    pods = add_gang(P, c, "pg1", 4, 4)
    intent(c, pods, ["n1"] * 4, "ns/pg1", 4)
    return reconcile(P, c)


def redrive_completes_partial_gang(P):
    c = make_cluster(P)
    pods = add_gang(P, c, "pg1", 4, 4, bound_on={0: "n1", 1: "n1"})
    intent(c, pods, ["n1", "n1", "n2", "n2"], "ns/pg1", 4)
    counter = P.metrics.scheduler_failover_recoveries
    before = counter.get(("redriven",))
    out = reconcile(P, c)
    out["metric_delta"] = counter.get(("redriven",)) - before
    out["last"] = P.recovery.LAST_RECOVERY["outcomes"]
    return out


def redrive_respects_capacity_recount(P):
    c = make_cluster(P, nodes=("n1", "tiny"))
    add_node(P, c, "tiny", "500m", "1Gi", 2)
    filler = P.tu.build_pod("ns", "filler", "", P.api.PodPhase.PENDING,
                            req(P, cpu="400m"))
    c.create_pod(filler)
    c.bind_pod(filler, "tiny")
    pods = add_gang(P, c, "pg1", 2, 2, bound_on={0: "n1"})
    intent(c, pods, ["n1", "tiny"], "ns/pg1", 2)
    return reconcile(P, c)


def node_gone_evicts_partial_placement(P):
    c = make_cluster(P, nodes=("n1",))
    pods = add_gang(P, c, "pg1", 3, 3, bound_on={0: "n1"})
    intent(c, pods, ["n1", "gone", "gone"], "ns/pg1", 3)
    return reconcile(P, c)


def min_member_falls_back_to_journal_gangs(P):
    c = make_cluster(P)
    pods = add_gang(P, c, "pg1", 3, 3, bound_on={0: "n1"})
    for pg in c.list_objects("PodGroup"):
        c.delete("PodGroup", pg)
    intent(c, pods, ["n1", "n2", "n2"], "ns/pg1", 3)
    return reconcile(P, c)


def two_redrives_cannot_double_book_headroom(P):
    c = make_cluster(P, nodes=("n1", "small"))
    add_node(P, c, "small", "700m", "2Gi", 8)
    pods = add_gang(P, c, "pg1", 3, 2, bound_on={0: "n1"})
    intent(c, pods, ["n1", "small", "small"], "ns/pg1", 2)
    return reconcile(P, c)


def abandoned_plan_reservations_roll_back(P):
    c = make_cluster(P, nodes=("solo",))
    add_node(P, c, "solo", "1500m", "4Gi", 8)
    a = add_gang(P, c, "aaa", 3, 3, bound_on={0: "solo"})
    b = add_gang(P, c, "bbb", 2, 2, bound_on={0: "solo"})
    intent(c, a, ["solo", "solo", "gone"], "ns/aaa", 3)
    intent(c, b, ["solo", "solo"], "ns/bbb", 2)
    return reconcile(P, c)


def journal_scan_failure_reports_error_not_raise(P):
    c = make_cluster(P)

    def boom():
        raise RuntimeError("journal unreadable")

    c.list_bind_intents = boom
    return summary(P.recovery.reconcile_journal(c, "succ-1"))


def malformed_record_does_not_abort_the_pass(P):
    c = make_cluster(P)
    pods = add_gang(P, c, "pg1", 1, 1, bound_on={0: "n1"})
    c.append_bind_intent({"leader": "x"})  # no tasks at all
    intent(c, pods, ["n1"], "ns/pg1", 1)   # unmarked, bound: applied
    return reconcile(P, c)


def make_scheduler(P, cluster):
    cache = P.SchedulerCache(cluster=cluster)
    cache.leader_identity = "succ-sched"
    cache.start_ingest()
    kw = {"device": "cpu"} if P.name.endswith("torch") else {}
    return P.scheduler.Scheduler(cache, schedule_period=0.01, **kw)


def recover_from_journal_runs_and_notes_flight_record(P):
    c = make_cluster(P)
    pods = add_gang(P, c, "pg1", 2, 2, bound_on={0: "n1"})
    intent(c, pods, ["n1", "n2"], "ns/pg1", 2)
    sched = make_scheduler(P, c)
    report = sched.recover_from_journal()
    out = dict(summary(report), note=sched._pending_recovery_note["outcomes"],
               **truth(c))
    sched.cache.shutdown()
    return out


def kbt_recovery_0_skips(P, monkeypatch):
    c = make_cluster(P)
    pods = add_gang(P, c, "pg1", 2, 2, bound_on={0: "n1"})
    intent(c, pods, ["n1", "n2"], "ns/pg1", 2)
    monkeypatch.setenv("KBT_RECOVERY", "0")
    sched = make_scheduler(P, c)
    out = dict(report=sched.recover_from_journal(), **truth(c))
    monkeypatch.delenv("KBT_RECOVERY")
    sched.cache.shutdown()
    return out


def no_journal_seam_is_a_noop(P):
    kw = {"device": "cpu"} if P.name.endswith("torch") else {}
    sched = P.scheduler.Scheduler(P.SchedulerCache(), schedule_period=0.01,
                                  **kw)
    return sched.recover_from_journal()


def short_lease_flags_and_exports(P):
    kw = {"device": "cpu"} if P.name.endswith("torch") else {}
    s = P.scheduler.Scheduler(P.SchedulerCache(), schedule_period=1.0, **kw)
    verdict = s.check_lease_ttl(15.0)
    exported = P.scheduler.LEASE_TTL_CHECK == verdict
    ok = s.check_lease_ttl(s.watchdog_budget + 1.0)
    return dict(budget=s.watchdog_budget, short=verdict, exported=exported,
                ok=ok)


def disabled_watchdog_is_always_sane(P, monkeypatch):
    monkeypatch.setenv("KBT_WATCHDOG_BUDGET", "0")
    kw = {"device": "cpu"} if P.name.endswith("torch") else {}
    s = P.scheduler.Scheduler(P.SchedulerCache(), schedule_period=1.0, **kw)
    monkeypatch.delenv("KBT_WATCHDOG_BUDGET")
    return s.check_lease_ttl(1.0)


SCRIPTS = {
    "marked_and_truth_backfilled_rows": marked_and_truth_backfilled_rows,
    "failed_mark_classifies_failed": failed_mark_classifies_failed,
    "lost_without_gang_constraint_requeues":
        lost_without_gang_constraint_requeues,
    "lost_whole_gang_unbound_requeues": lost_whole_gang_unbound_requeues,
    "redrive_completes_partial_gang": redrive_completes_partial_gang,
    "redrive_respects_capacity_recount": redrive_respects_capacity_recount,
    "node_gone_evicts_partial_placement":
        node_gone_evicts_partial_placement,
    "min_member_falls_back_to_journal_gangs":
        min_member_falls_back_to_journal_gangs,
    "two_redrives_cannot_double_book_headroom":
        two_redrives_cannot_double_book_headroom,
    "abandoned_plan_reservations_roll_back":
        abandoned_plan_reservations_roll_back,
    "journal_scan_failure_reports_error_not_raise":
        journal_scan_failure_reports_error_not_raise,
    "malformed_record_does_not_abort_the_pass":
        malformed_record_does_not_abort_the_pass,
    "recover_from_journal_runs_and_notes_flight_record":
        recover_from_journal_runs_and_notes_flight_record,
    "kbt_recovery_0_skips": kbt_recovery_0_skips,
    "no_journal_seam_is_a_noop": no_journal_seam_is_a_noop,
    "short_lease_flags_and_exports": short_lease_flags_and_exports,
    "disabled_watchdog_is_always_sane": disabled_watchdog_is_always_sane,
}
NEEDS_MONKEYPATCH = {"kbt_recovery_0_skips",
                     "disabled_watchdog_is_always_sane"}


def node_of(out, pod):
    return dict(out["pods"]).get(pod)


# What the reference's cases expect of each script (port side).
EXPECT = {
    "marked_and_truth_backfilled_rows": lambda o: (
        o["outcomes"] == {"applied": 2, "superseded": 1, "vanished": 1}
        and o["errors"] == 0 and o["journal"] == 0),
    "failed_mark_classifies_failed": lambda o: (
        o["outcomes"] == {"failed": 1, "requeued": 1}),
    "lost_without_gang_constraint_requeues": lambda o: (
        o["outcomes"] == {"requeued": 2} and node_of(o, "pg1-0") == ""),
    "lost_whole_gang_unbound_requeues": lambda o: (
        o["outcomes"] == {"requeued": 4}
        and o["gangs_repaired"] == [] and o["gangs_evicted"] == []),
    "redrive_completes_partial_gang": lambda o: (
        o["outcomes"] == {"applied": 2, "redriven": 2}
        and o["gangs_repaired"] == ["ns/pg1"] and o["gangs_evicted"] == []
        and node_of(o, "pg1-2") == "n2" and node_of(o, "pg1-3") == "n2"
        and o["metric_delta"] == 2 and o["journal"] == 0
        and o["last"]["redriven"] == 2),
    "redrive_respects_capacity_recount": lambda o: (
        o["outcomes"] == {"applied": 1, "evicted": 1, "requeued": 1}
        and o["gangs_evicted"] == ["ns/pg1"]
        and node_of(o, "pg1-0") is None and node_of(o, "pg1-1") == ""),
    "node_gone_evicts_partial_placement": lambda o: (
        o["outcomes"] == {"applied": 1, "evicted": 1, "requeued": 2}
        and o["gangs_evicted"] == ["ns/pg1"]
        and [e["pod"] for e in o["evicted"]] == ["ns/pg1-0"]),
    "min_member_falls_back_to_journal_gangs": lambda o: (
        o["outcomes"] == {"applied": 1, "redriven": 2}
        and o["gangs_repaired"] == ["ns/pg1"]),
    "two_redrives_cannot_double_book_headroom": lambda o: (
        o["outcomes"] == {"applied": 1, "redriven": 1, "requeued": 1}
        and [n for _, n in o["pods"]].count("small") == 1),
    "abandoned_plan_reservations_roll_back": lambda o: (
        o["gangs_evicted"] == ["ns/aaa"] and o["gangs_repaired"] == ["ns/bbb"]
        and node_of(o, "bbb-1") == "solo"
        and sorted(p for p, n in o["pods"] if n) == ["bbb-0", "bbb-1"]),
    "journal_scan_failure_reports_error_not_raise": lambda o: (
        o["errors"] == 1 and o["intents_scanned"] == 0),
    "malformed_record_does_not_abort_the_pass": lambda o: (
        o["outcomes"] == {"applied": 1} and o["journal"] == 0),
    "recover_from_journal_runs_and_notes_flight_record": lambda o: (
        o["leader"] == "succ-sched"
        and o["outcomes"] == {"applied": 1, "redriven": 1}
        and o["note"] == {"applied": 1, "redriven": 1}),
    "kbt_recovery_0_skips": lambda o: (
        o["report"] is None and o["journal"] == 1),
    "no_journal_seam_is_a_noop": lambda o: o is None,
    "short_lease_flags_and_exports": lambda o: (
        o["budget"] > 15.0 and o["short"]["sane"] is False
        and o["exported"] and o["ok"]["sane"] is True),
    "disabled_watchdog_is_always_sane": lambda o: o["sane"] is True,
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_recovery_matches_reference(case, monkeypatch):
    extra = (monkeypatch,) if case in NEEDS_MONKEYPATCH else ()
    ref, got = (SCRIPTS[case](package(p), *extra) for p in PKGS)
    assert got == ref
    assert EXPECT[case](got), got
