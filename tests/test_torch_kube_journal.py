"""Parity of the port's Lease-annotation bind-intent journal, its Lease
leader elector and successor recovery over the real-cluster adapter with
the JAX package's.

- The Lease-journal cases of ``tests/unit/test_bind_journal.py`` (its
  ``TestKubeLeaseJournal``) run once per package against each package's
  ``FakeKube``; one script of appends, marks and removals through both
  gives the same annotation, byte for byte, and the same refusal of a
  record over the annotation budget.
- ``cli.server.KubeLeaseElector``: the roundtrip, a handover on release,
  a steal once the holder stops renewing, a renewing holder with a
  foreign timestamp that is never stolen, and a release after a takeover
  that leaves the new holder alone; the Lease's holder and transitions
  are equal in both packages.
- ``cache.recovery.reconcile_journal`` over a ``KubeCluster`` journal,
  on the recovery cases of phase 10.3's drill and of
  ``tests/unit/test_recovery.py``: the report (without its wall time),
  the binds and evictions the API server saw and the journal left are
  equal; and ``cli.run --once`` with ``--leader-elect`` over
  ``--master`` takes a released Lease, reconciles a fenced
  predecessor's journal and binds the same pods in both packages.
"""

import importlib
import json
import threading
import time
from types import SimpleNamespace

import pytest

PKGS = ("kube_batch_tpu", "kube_batch_tpu_torch")
GROUP = "scheduling.incubator.k8s.io"
NS = "kube-system"


def package(name):
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    m("actions")
    m("plugins")
    return SimpleNamespace(
        name=name, kube=m("cluster.kube"), fk=m("utils.fake_kube"),
        server=m("cli.server"), cli=m("cli"), recovery=m("cache.recovery"),
        rng=m("utils.scheduler_helper")._rng,
    )


@pytest.fixture(params=PKGS)
def P(request):
    return package(request.param)


@pytest.fixture
def kube(P):
    server = P.fk.FakeKube()
    cluster = journal_cluster(P, server)
    try:
        yield server, cluster
    finally:
        server.close()


def journal_cluster(P, server):
    cluster = P.kube.KubeCluster(P.kube.KubeConfig(server.url),
                                 watch_kinds=())
    cluster.journal_namespace = NS
    return cluster


def record_for(uids, node="n1", job="ns/pg1", minm=2, leader="L0"):
    return {
        "leader": leader,
        "tasks": [{"uid": u, "pod": f"ns/{u}", "node": node, "job": job}
                  for u in uids],
        "gangs": {job: minm},
    }


# ------------------------------------------------ the Lease-annotation journal


class TestKubeLeaseJournal:
    def test_append_mark_list_remove_roundtrip(self, kube):
        _server, cluster = kube
        assert cluster.supports_bind_journal
        s1 = cluster.append_bind_intent(record_for(["a", "b"]))
        s2 = cluster.append_bind_intent(record_for(["c"], job="ns/pg2"))
        assert s2 == s1 + 1
        recs = cluster.list_bind_intents()
        assert [r["seq"] for r in recs] == [s1, s2]
        assert cluster.mark_bind_intent(s1, "a", "applied") is False
        assert cluster.list_bind_intents()[0]["marks"] == {"a": "applied"}
        assert cluster.mark_bind_intent(s1, "b", "failed") is True
        assert [r["seq"] for r in cluster.list_bind_intents()] == [s2]
        cluster.remove_bind_intent(s2)
        assert cluster.list_bind_intents() == []
        # Seq survives pruning: the counter rides the same annotation.
        assert cluster.append_bind_intent(record_for(["d"])) == s2 + 1

    def test_journal_survives_adapter_restart(self, P, kube):
        server, cluster = kube
        seq = cluster.append_bind_intent(record_for(["a"]))
        successor = journal_cluster(P, server)
        recs = successor.list_bind_intents()
        assert [r["seq"] for r in recs] == [seq]
        assert recs[0]["tasks"][0]["uid"] == "a"


def journal_script(P):
    """Appends, partial and full marks, a batched mark, a removal, an
    unusable annotation reset and a record over the byte budget; returns
    what each step returned and the annotation left."""
    server = P.fk.FakeKube()
    try:
        c = journal_cluster(P, server)
        steps = [c.append_bind_intent(record_for([f"t{i}" for i in range(3)],
                                                 job=f"ns/pg{j}"))
                 for j in range(4)]
        steps.append(c.mark_bind_intents(1, {"t0": "applied",
                                             "t1": "failed"}))
        steps.append(c.mark_bind_intents(2, {f"t{i}": "applied"
                                             for i in range(3)}))
        steps.append(c.mark_bind_intent(3, "t2", "applied"))
        c.remove_bind_intents((4,))
        steps.append(c.list_bind_intents())
        with pytest.raises(ValueError, match="annotation budget"):
            c.append_bind_intent(record_for(
                [f"u{i:06d}" for i in range(5000)]))
        path = c._journal_lease_path()
        annotation = server.leases[path]["metadata"]["annotations"][
            c.JOURNAL_ANNOTATION]
        with server.lock:  # a hand-edited annotation reads as empty
            server.leases[path]["metadata"]["annotations"][
                c.JOURNAL_ANNOTATION] = "[1, 2]"
        steps.append(c.list_bind_intents())
        steps.append(c.append_bind_intent(record_for(["z"])))
        return {"steps": steps, "annotation": annotation,
                "after_reset": server.leases[path]["metadata"][
                    "annotations"][c.JOURNAL_ANNOTATION]}
    finally:
        server.close()


def test_journal_annotations_equal_across_packages():
    ref, got = (journal_script(package(p)) for p in PKGS)
    assert got == ref
    assert got["steps"][:4] == [1, 2, 3, 4]
    assert [r["seq"] for r in got["steps"][7]] == [1, 3]
    assert json.loads(got["annotation"])["next_seq"] == 5
    assert json.loads(got["after_reset"]) == {
        "next_seq": 2, "records": [dict(record_for(["z"]), seq=1,
                                        marks={})]}


# -------------------------------------------------------- the Lease elector


def lease_of(server, name="tpu-batch"):
    spec = server.leases[
        f"/apis/coordination.k8s.io/v1/namespaces/{NS}/leases/{name}"]["spec"]
    return spec["holderIdentity"], spec["leaseTransitions"]


def elector(P, server, identity, **kw):
    cluster = P.kube.KubeCluster(P.kube.KubeConfig(server.url),
                                 watch_kinds=())
    return P.server.KubeLeaseElector(cluster, NS, identity=identity, **kw)


class TestKubeLeaseElector:
    def test_kube_lease_elector_roundtrip(self, P, kube):
        server, _ = kube
        a = elector(P, server, "a", lease_duration=15.0)
        b = elector(P, server, "b", lease_duration=15.0)
        assert a.try_acquire()
        assert not b.try_acquire()
        assert a.try_acquire()  # renew
        assert lease_of(server) == ("a", 0)

    def test_run_hands_over_on_release(self, P, kube):
        """A leader's payload returns and ``release`` clears the holder;
        a successor blocked in ``run`` takes the Lease within one retry
        period, without waiting out the lease duration."""
        server, _ = kube
        timing = dict(lease_duration=30.0, renew_deadline=5.0,
                      retry_period=0.05)
        a = elector(P, server, "a", **timing)
        b = elector(P, server, "b", **timing)
        order = []
        a_leads, a_may_go = threading.Event(), threading.Event()

        def run_a():
            a.run(on_started_leading=lambda lost: (
                order.append("a"), a_leads.set(), a_may_go.wait(10)),
                on_stopped_leading=lambda: order.append("a-lost"))
            a.release()

        ta = threading.Thread(target=run_a, daemon=True)
        ta.start()
        assert a_leads.wait(10)
        tb = threading.Thread(target=lambda: b.run(
            on_started_leading=lambda lost: order.append("b"),
            on_stopped_leading=lambda: order.append("b-lost")), daemon=True)
        tb.start()
        time.sleep(0.3)
        assert order == ["a"] and lease_of(server)[0] == "a"
        t0 = time.monotonic()
        a_may_go.set()
        ta.join(10)
        tb.join(10)
        b.release()
        assert order == ["a", "b"]
        assert time.monotonic() - t0 < 5.0
        assert lease_of(server) == ("", 1)

    def test_steal_after_the_holder_stops_renewing(self, P, kube):
        server, _ = kube
        a = elector(P, server, "a", lease_duration=0.2)
        b = elector(P, server, "b", lease_duration=0.2)
        assert a.try_acquire()
        assert not b.try_acquire()  # first observation starts b's clock
        time.sleep(0.3)
        assert b.try_acquire()
        assert lease_of(server) == ("b", 1)
        assert not a.try_acquire()  # b's renewal is fresh to a

    def test_skewed_renewing_holder_is_never_stolen(self, P, kube):
        server, cluster = kube
        a = elector(P, server, "a", lease_duration=0.2)
        b = elector(P, server, "b", lease_duration=0.2)
        assert a.try_acquire()
        path = f"/apis/coordination.k8s.io/v1/namespaces/{NS}/leases/tpu-batch"
        for i in range(4):
            assert not b.try_acquire()
            time.sleep(0.1)
            assert a.try_acquire()
            with server.lock:  # the holder's clock writes nonsense
                server.leases[path]["spec"]["renewTime"] = f"skewed-{i}"
        assert not b.try_acquire()
        assert lease_of(server) == ("a", 0)

    def test_release_after_takeover_leaves_the_new_holder(self, P, kube):
        server, _ = kube
        a = elector(P, server, "a", lease_duration=0.2)
        b = elector(P, server, "b", lease_duration=0.2)
        assert a.try_acquire()
        assert not b.try_acquire()
        time.sleep(0.3)
        assert b.try_acquire()
        a.release()  # a held it once, but b holds it now
        assert lease_of(server) == ("b", 1)
        b.release()
        assert lease_of(server) == ("", 1)


# --------------------------------------------------- recovery over the Lease


def node_doc(P, name, cpu="4", pods="20"):
    return P.fk.node_doc(name, cpu=cpu, pods=pods)


def fill(P, server, nodes, gangs):
    """Queue, nodes, and gangs ``(name, members, minMember)`` of 500m
    pods in namespace ``ns``."""
    server.create("Queue", {
        "apiVersion": f"{GROUP}/v1alpha1", "kind": "Queue",
        "metadata": {"name": "default"}, "spec": {"weight": 1}})
    for name, cpu in nodes:
        server.create("Node", node_doc(P, name, cpu=cpu))
    for name, members, minm in gangs:
        server.create("PodGroup", {
            "apiVersion": f"{GROUP}/v1alpha1", "kind": "PodGroup",
            "metadata": {"name": name, "namespace": "ns"},
            "spec": {"minMember": minm, "queue": "default"}})
        for i in range(members):
            doc = P.fk.pod_doc(f"{name}-{i}", ns="ns", group=name)
            doc["spec"]["schedulerName"] = "tpu-batch"
            server.create("Pod", doc)


def bind(server, key, node):
    """A bind made by the dead predecessor before it died."""
    with server.lock:
        pod = server.objects["Pod"][key]
        pod["spec"]["nodeName"] = node
        pod["status"]["phase"] = "Running"


def journal(cluster, job, rows, minm, marks=None, leader="dead-0"):
    """A predecessor's intent: ``rows`` of (pod name, node)."""
    seq = cluster.append_bind_intent({
        "leader": leader,
        "tasks": [{"uid": f"uid-ns-{pod}", "pod": f"ns/{pod}", "node": node,
                   "job": job} for pod, node in rows],
        "gangs": {job: minm},
    })
    for pod, outcome in (marks or {}).items():
        cluster.mark_bind_intent(seq, f"uid-ns-{pod}", outcome)


def drill(P, server, c):
    """Phase 10.3's cut: a gang of 4 with 2 members bound and intents for
    all 4, beside a gang still pending."""
    fill(P, server, [("r0", "8"), ("r1", "8")],
         [("redo", 4, 4), ("fresh", 3, 3)])
    bind(server, "ns/redo-0", "r0")
    bind(server, "ns/redo-1", "r0")
    journal(c, "ns/redo", [("redo-0", "r0"), ("redo-1", "r0"),
                           ("redo-2", "r1"), ("redo-3", "r1")], 4)


def truth_backfilled(P, server, c):
    fill(P, server, [("n1", "8"), ("n2", "8")], [("pg1", 4, 2)])
    bind(server, "ns/pg1-0", "n1")
    bind(server, "ns/pg1-1", "n1")
    bind(server, "ns/pg1-2", "n2")  # a later leader placed it elsewhere
    journal(c, "ns/pg1", [(f"pg1-{i}", "n1") for i in range(4)], 2,
            marks={"pg1-0": "applied"})
    with server.lock:
        server.objects["Pod"].pop("ns/pg1-3")  # deleted since


def node_gone(P, server, c):
    fill(P, server, [("n1", "8")], [("pg1", 3, 3)])
    bind(server, "ns/pg1-0", "n1")
    journal(c, "ns/pg1", [("pg1-0", "n1"), ("pg1-1", "gone"),
                          ("pg1-2", "gone")], 3)


def capacity_recount(P, server, c):
    fill(P, server, [("n1", "8"), ("tiny", "500m")], [("pg1", 2, 2)])
    filler = P.fk.pod_doc("filler", ns="ns", cpu="400m")
    server.create("Pod", filler)
    bind(server, "ns/filler", "tiny")
    bind(server, "ns/pg1-0", "n1")
    journal(c, "ns/pg1", [("pg1-0", "n1"), ("pg1-1", "tiny")], 2)


def lost_gang_requeues(P, server, c):
    fill(P, server, [("n1", "8")], [("pg1", 4, 4)])
    journal(c, "ns/pg1", [(f"pg1-{i}", "n1") for i in range(4)], 4)


RECOVERY = {"drill": drill, "truth_backfilled": truth_backfilled,
            "node_gone": node_gone, "capacity_recount": capacity_recount,
            "lost_gang_requeues": lost_gang_requeues}
OUTCOMES = {
    "drill": {"applied": 2, "redriven": 2},
    "truth_backfilled": {"applied": 2, "superseded": 1, "vanished": 1},
    "node_gone": {"applied": 1, "evicted": 1, "requeued": 2},
    "capacity_recount": {"applied": 1, "evicted": 1, "requeued": 1},
    "lost_gang_requeues": {"requeued": 4},
}


def api_truth(server, c):
    with server.lock:
        pods = sorted((k, p["spec"].get("nodeName", ""))
                      for k, p in server.objects["Pod"].items())
        binds = sorted(server.bindings)
    return {"pods": pods, "bindings": binds,
            "journal": c.list_bind_intents()}


def reconcile_over_lease(P, script):
    server = P.fk.FakeKube()
    try:
        c = P.kube.KubeCluster(P.kube.KubeConfig(server.url),
                               watch_kinds=())
        RECOVERY[script](P, server, c)
        report = P.recovery.reconcile_journal(c, "succ-1").summary()
        report.pop("duration_ms")
        return dict(report, **api_truth(server, c))
    finally:
        server.close()


@pytest.mark.parametrize("script", sorted(RECOVERY))
def test_reconcile_over_a_lease_journal_equals_the_jax_package(script):
    ref, got = (reconcile_over_lease(package(p), script) for p in PKGS)
    assert got == ref
    assert got["outcomes"] == OUTCOMES[script]
    assert got["journal"] == [] and got["errors"] == 0


def successor_process(P, monkeypatch):
    """``cli.run --once --leader-elect`` over ``--master``: a fenced
    predecessor released its Lease and left phase 10.3's journal; the
    successor takes the Lease, reconciles, and runs one cycle. Every
    adapter built is stopped afterwards (the JAX package's ``cli.run``
    leaves its watch threads running)."""
    made = []
    init = P.kube.KubeCluster.__init__

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(P.kube.KubeCluster, "__init__", recorded)
    server = P.fk.FakeKube()
    try:
        c = P.kube.KubeCluster(P.kube.KubeConfig(server.url),
                               watch_kinds=())
        drill(P, server, c)
        assert c.try_acquire_lease(NS, "tpu-batch", "dead-0", 15.0)
        c.release_lease(NS, "tpu-batch", "dead-0")
        P.rng.seed(0)
        P.recovery.LAST_RECOVERY = None
        opt = dict(master=server.url, once=True, enable_leader_election=True,
                   lock_object_namespace=NS, listen_address="127.0.0.1:0")
        if P.name.endswith("torch"):
            opt["device"] = "cpu"
        P.cli.run(P.cli.ServerOption(**opt))
        report = dict(P.recovery.LAST_RECOVERY)
        report.pop("duration_ms")
        out = dict(report, **api_truth(server, c))
        out["lease"] = lease_of(server)[0]
        return out
    finally:
        for cluster in made:
            cluster.stop()
        server.close()


def test_successor_process_over_the_api_server(monkeypatch):
    ref, got = (successor_process(package(p), monkeypatch) for p in PKGS)
    assert got == ref
    assert got["outcomes"] == OUTCOMES["drill"]
    assert got["journal"] == [] and got["lease"] == ""
    assert {k for k, node in got["pods"] if node} == {
        f"ns/{g}-{i}" for g, n in (("redo", 4), ("fresh", 3))
        for i in range(n)}
